"""Shared helpers of the ``tests/test_torch_*.py`` files: the problems both
packages solve, made from a seed with numpy, and the test-only host build of
the kernels' per-problem math (``bunmpc_tpu_torch/_build.build_host``).

Every port test file imports this module, which pins PyTorch to one
intra-op thread: the suite runs in several worker processes on shared cores,
where PyTorch's default of one thread per core oversubscribes them (the
plain MPC solve at B=4 ran 34.6 s at 8 threads and 5.5 s at 1)."""

import ctypes

import numpy as np
import torch

from bunmpc_tpu_torch import _build

torch.set_num_threads(1)

H_ADMM, NE, M_ADMM = 20, 4, 2.5


def admm_problem(B, seed=0):
    """The ``problem`` fixture of tests/test_pallas_admm.py at batch size B
    (float64 numpy): random contact plans around a standing CoM."""
    rng = np.random.default_rng(seed)
    H = H_ADMM
    cnt = (rng.random((B, H, NE)) > 0.4).astype(np.float64)
    r = rng.normal(size=(B, H, NE, 3)) * 0.15
    r[..., 2] = 0.018
    dt = np.full((B, H), 0.05)
    x_init = np.tile(np.array([0, 0, 0.2, 0, 0, 0, 0, 0, 0.0]), (B, 1))
    x_init[:, 0:2] += rng.normal(size=(B, 2)) * 0.01
    W = np.tile(np.array([1e-5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e4, 1e4, 1e4]), (B, H + 1, 1))
    W[:, -1] = 10 * np.array([1e5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5])
    X_ref = np.tile(np.array([0, 0, 0.2, 0, 0, 0, 0, 0, 0.0]), (B, H + 1, 1))
    W_F = np.full((B, H, NE, 3), 1e1)
    X_wm = np.tile(x_init[:, None, :], (1, H + 1, 1))
    F_wm = np.zeros((B, H, NE, 3))
    lb = np.full((B, H + 1, 9), -np.inf)
    ub = np.full((B, H + 1, 9), np.inf)
    return dict(cnt=cnt, r=r, dt=dt, x_init=x_init, W=W, X_ref=X_ref, W_F=W_F, X_wm=X_wm,
                F_wm=F_wm, lb=lb, ub=ub)


def host_lib(name, tmp_path_factory):
    """ctypes handle of the g++ build of ``csrc/<name>.cu`` (test-only)."""
    out = tmp_path_factory.mktemp(f"host_{name}")
    return ctypes.CDLL(_build.build_host(name, str(out)))


def call_host(lib, symbol, argtypes, args):
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    assert fn(*args) == 0


def to_torch(d, dtype):
    return {k: torch.as_tensor(v, dtype=dtype) for k, v in d.items()}
