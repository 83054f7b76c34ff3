"""K1: the batched biconvex centroidal ADMM as a hand-written CUDA kernel.

Counterpart of ``bunmpc_tpu/solvers/pallas_admm.py`` (``solve`` ->
``_kernel`` -> ``_admm_core``, every x_solver and precondition branch); the
kernel is ``csrc/admm.cu`` over the per-problem code of ``csrc/admm_core.cuh``
(a warp and a slice of the block's shared memory per problem, see their
headers for the design and what bounds it). ``solve`` takes a batch of any
size B (no padding) and any horizon whose problem fits a block's shared
memory (``launch_per_block``; past that it raises). It takes an optional
scaled dual ``P_wm`` (a receding-horizon warm start; zeros otherwise) and
returns the final dual at the base rho, as the plain version does.

Dispatch: tensors on the CPU go to the plain version (``solvers/biconvex.py``);
tensors on a CUDA device go to the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .._build import Kernel, fit_per_block
from ..mpc.centroidal import ContactPlan
from . import biconvex

KERNEL = Kernel("admm")
NE = 4  # feet per problem the kernel is built for
LANES = 32  # threads per problem: one warp (csrc/common.cuh: LANES)
PER_BLOCK = 4  # problems per thread block, where their shared memory fits
BIG = 3.4e38  # the kernels' stand-in for an infinite bound (< the f32 maximum)


@dataclasses.dataclass(frozen=True)
class CudaAdmmConfig:
    """The fields and defaults of ``PallasAdmmConfig`` (without
    ``interpret``)."""

    rho: float = 1e5
    max_admm_iters: int = 100
    fista_max_iters: int = 150
    fista_tol: float = 1e-5
    exit_tol: float = 1e-3
    mu: float = 1.0
    power_iters: int = 8
    power_safety: float = 1.25
    precondition: bool = False
    dual_relax: float = 1.8
    rho_growth: float = 3.0
    rho_growth_every: int = 10
    rho_max_scale: float = 81.0
    rho_stall_gate: bool = True
    rho_stall_improve: float = 0.0
    rho_backoff_thresh: float = 2.0
    x_solver: str = "thomas"


def _check_config(cfg: CudaAdmmConfig):
    if cfg.x_solver not in ("thomas", "fista"):
        raise ValueError(f"x_solver must be 'thomas' or 'fista', got {cfg.x_solver!r}")


def plain_config(cfg: CudaAdmmConfig) -> biconvex.BiconvexConfig:
    """The ``BiconvexConfig`` of the plain version that runs the same solve."""
    return biconvex.BiconvexConfig(
        rho=cfg.rho, max_admm_iters=cfg.max_admm_iters, fista_max_iters=cfg.fista_max_iters,
        fista_tol=cfg.fista_tol, exit_tol=cfg.exit_tol, mu=cfg.mu,
        power_iters=cfg.power_iters, power_safety=cfg.power_safety,
        dual_relax=cfg.dual_relax, rho_growth=cfg.rho_growth,
        rho_growth_every=cfg.rho_growth_every, rho_max_scale=cfg.rho_max_scale,
        rho_stall_gate=cfg.rho_stall_gate, rho_stall_improve=cfg.rho_stall_improve,
        rho_backoff_thresh=cfg.rho_backoff_thresh, precondition=cfg.precondition,
        x_solver=cfg.x_solver,
    )


def solve_plain(plan, m, x_init, W, X_ref_target, W_F, X_wm, F_wm, x_bounds, cfg, F_reg_ref=None,
                P_wm=None):
    """K1's plain version: the batched PyTorch ADMM, same returns as ``solve``."""
    _check_config(cfg)
    res = biconvex.solve(
        plan, m, x_init, biconvex.CostX(W=W, X_ref=X_ref_target), W_F, X_wm, F_wm,
        torch.zeros_like(X_wm) if P_wm is None else P_wm, plain_config(cfg), x_bounds=x_bounds,
        F_ref=F_reg_ref,
    )
    return res.X, res.F, res.viol_norm, res.admm_iters, res.P


_I = ctypes.c_int
_D = ctypes.c_double
_P = ctypes.c_void_p
ARGTYPES = [_I] * 9 + [_D] * 11 + [_P] * 19


def config_args(H: int, m: float, cfg: CudaAdmmConfig) -> list:
    """The scalar ADMM settings of a C entry point (csrc/admm_core.cuh:
    ADMM_CFG_ARGS), 8 ints then 11 doubles."""
    return [
        H, cfg.max_admm_iters, cfg.fista_max_iters, cfg.power_iters, cfg.rho_growth_every,
        int(cfg.rho_stall_gate), int(cfg.x_solver == "fista"), int(cfg.precondition),
        float(m), cfg.rho, cfg.fista_tol, cfg.exit_tol, cfg.mu, cfg.power_safety,
        cfg.dual_relax, cfg.rho_growth, cfg.rho_max_scale, cfg.rho_stall_improve,
        cfg.rho_backoff_thresh,
    ]


def shared_size(H: int) -> int:
    """Shared-memory elements per problem (csrc/admm_core.cuh: admm_layout):
    the work arrays (the Thomas sweep's and the X-FISTA's share their room)
    and the staged inputs."""
    nX, nF = (H + 1) * 9, H * NE * 3
    work = 6 * nX + 7 * nF + 2 * LANES + max(H * 81 + 81 + 81 + 9, 5 * nX)
    inputs = H * NE + nF + H + 9 + 4 * nX + 2 * nF  # cnt, r, dt, x_init, W, ql, lb, ub, WF, qF
    return work + inputs


def launch_per_block(H: int) -> int:
    """Problems per block at horizon H (K1 and K3): PER_BLOCK, or as many as
    the block's shared memory holds; raises ValueError if one does not fit."""
    return fit_per_block("the ADMM kernels", 4 * shared_size(H), PER_BLOCK, f"H={H}")


def kernel_args(plan, m, x_init, W, X_ref_target, W_F, X_wm, F_wm, x_bounds, cfg,
                F_reg_ref=None, P_wm=None):
    """Checked inputs, freshly allocated outputs, and the C argument list
    (without the launch configuration) of one kernel call. Returns
    ``(args, keep, outputs)``: ``keep`` holds every tensor the call points at,
    ``outputs`` is ``(X, F, viol, iters, fista_iters, P)``. ``P_wm`` None
    starts the dual at zero (a null pointer)."""
    _check_config(cfg)
    B, H, ne = plan.cnt.shape
    if ne != NE:
        raise ValueError(f"the ADMM kernel is built for {NE} feet, got {ne}")
    dtype, device = x_init.dtype, x_init.device
    shapes = {
        "cnt": (plan.cnt, (B, H, NE)), "r": (plan.r, (B, H, NE, 3)), "dt": (plan.dt, (B, H)),
        "x_init": (x_init, (B, 9)), "W": (W, (B, H + 1, 9)),
        "X_ref": (X_ref_target, (B, H + 1, 9)), "W_F": (W_F, (B, H, NE, 3)),
        "X_wm": (X_wm, (B, H + 1, 9)), "F_wm": (F_wm, (B, H, NE, 3)),
        "lb": (x_bounds[0], (B, H + 1, 9)), "ub": (x_bounds[1], (B, H + 1, 9)),
    }
    if P_wm is not None:
        shapes["P_wm"] = (P_wm, (B, H + 1, 9))
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected {shape}")
        if a.dtype != dtype or a.device != device:
            raise ValueError(f"{name}: {a.dtype} on {a.device}, expected {dtype} on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ql = -2.0 * W * X_ref_target
    if F_reg_ref is None:
        qF = torch.zeros_like(W_F)
    else:
        qF = (-2.0 * W_F * F_reg_ref).contiguous()
    lb = torch.clamp(x_bounds[0], -BIG, BIG)
    ub = torch.clamp(x_bounds[1], -BIG, BIG)
    X = torch.empty_like(X_wm)
    F = torch.empty_like(F_wm)
    P = torch.empty_like(X_wm)
    viol = torch.empty((B,), dtype=dtype, device=device)
    iters = torch.empty((B,), dtype=torch.int32, device=device)
    fista = torch.empty((B,), dtype=torch.int32, device=device)
    ptrs = [plan.cnt, plan.r, plan.dt, x_init, W, ql, W_F, qF, lb, ub, X_wm, F_wm, P_wm,
            X, F, P, viol, iters, fista]
    args = [B] + config_args(H, m, cfg) + [None if t is None else t.data_ptr() for t in ptrs]
    return args, ptrs, (X, F, viol, iters, fista, P)


def _launch(plan, m, x_init, W, X_ref_target, W_F, X_wm, F_wm, x_bounds, cfg, F_reg_ref, P_wm):
    if x_init.device.type != "cuda":
        raise ValueError(f"the ADMM kernel runs on a CUDA device, got {x_init.device}")
    if x_init.dtype != torch.float32:
        raise ValueError(f"the ADMM kernel takes float32, got {x_init.dtype}")
    per_block = launch_per_block(plan.dt.shape[1])
    args, keep, out = kernel_args(plan, m, x_init, W, X_ref_target, W_F, X_wm, F_wm,
                                  x_bounds, cfg, F_reg_ref, P_wm)
    with torch.cuda.device(x_init.device):
        stream = torch.cuda.current_stream().cuda_stream
        KERNEL.launch("admm_launch_f32", args + [per_block, stream], ARGTYPES + [_I, _P])
    del keep
    return out


def fista_iterations(plan, m, x_init, W, X_ref_target, W_F, X_wm, F_wm, x_bounds, cfg,
                     F_reg_ref=None, P_wm=None):
    """F-step FISTA iterations the kernel runs per problem on these inputs (B,) —
    the data-dependent part of its arithmetic, for measuring."""
    return _launch(plan, m, x_init, W, X_ref_target, W_F, X_wm, F_wm, x_bounds, cfg,
                   F_reg_ref, P_wm)[4]


def solve(
    plan: ContactPlan,  # cnt (B, H, ne), r (B, H, ne, 3), dt (B, H)
    m: float,
    x_init,  # (B, 9)
    W,  # (B, H+1, 9)
    X_ref_target,  # (B, H+1, 9)
    W_F,  # (B, H, ne, 3)
    X_wm,  # (B, H+1, 9)
    F_wm,  # (B, H, ne, 3)
    x_bounds,  # (lb, ub): (B, H+1, 9) each
    cfg: CudaAdmmConfig,
    F_reg_ref=None,  # optional (B, H, ne, 3) force regularization point
    P_wm=None,  # optional (B, H+1, 9) scaled dual at the base rho (None: zeros)
):
    """Batched biconvex ADMM. Returns ``(X, F, viol (B,), iters (B,), P)``,
    ``P`` the final scaled dual at the base rho."""
    if x_init.device.type == "cpu":
        return solve_plain(plan, m, x_init, W, X_ref_target, W_F, X_wm, F_wm, x_bounds, cfg,
                           F_reg_ref, P_wm)
    X, F, viol, iters, _, P = _launch(plan, m, x_init, W, X_ref_target, W_F, X_wm, F_wm,
                                      x_bounds, cfg, F_reg_ref, P_wm)
    return X, F, viol, iters, P
