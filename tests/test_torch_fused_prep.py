"""The fused-assembly path: K3's plain prologue (``cuda_fused.prep_values``)
and the port's ``_compact_inputs`` against the JAX package's, K3's
per-problem math (``csrc/fused.cu`` built for the host with g++) against K3's
plain version, and the fused MPC solve against the unfused one.

Tolerances:
* ``prep_values`` against the JAX package's, called eagerly on its (.., T)
  layout, in f32 on the same compact inputs: the gates of
  tests/test_fused_prep.py:95-116 (cnt and swing exact, dt 1e-6, r 1e-5, W
  and WF rtol 1e-6, qlin rtol 2e-5 atol 1e-4, qF rtol 1e-5 atol 1e-4, lb/ub
  rtol 1e-6 atol 1e-5, X0 1e-5);
* ``_compact_inputs`` against the vmapped JAX function in f64: atol 1e-10
  (the same kinematics, summed in another order);
* K3's host build against its plain version: in f64 X and F 1e-7, equal
  iteration counts, cnt and swing exact, r and dt 1e-12; in f32 at 4 ADMM
  iterations the gates of tests/test_fused_prep.py:145-149;
* the fused path against the unfused path on the CPU in f64: every MpcPlan
  field within 1e-6, equal ADMM iteration counts.
"""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot as jtrot
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu.solvers import pallas_admm as JPA
from bunmpc_tpu_torch.mpc import kino_dyn as TKD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TSolo
from bunmpc_tpu_torch.solvers import cuda_admm, cuda_fused
from bunmpc_tpu_torch.workload import trot_states

from torch_port_helpers import call_host, host_lib

B = 8
H, NE = 20, 4


def states(n, seed):
    """Random mid-episode states (tests/test_fused_prep.py:_rand_batch):
    yaw-dominant base orientations, joint and velocity noise, a gait clock in
    [0, 0.6), commands, and a zero yaw rate on about half the batch (the
    orientation-correction branch)."""
    rng = np.random.default_rng(seed)
    q = np.tile(TSolo.q0(), (n, 1))
    q[:, 7:] += rng.normal(size=(n, 12)) * 0.05
    yaw = rng.uniform(-0.6, 0.6, n)
    q[:, 3] = np.sin(yaw / 2) * 0.1
    q[:, 5] = np.sin(yaw / 2)
    q[:, 6] = np.cos(yaw / 2)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    v = rng.normal(size=(n, 18)) * 0.1
    t = rng.uniform(0, 0.6, n)
    v_des = np.stack([rng.uniform(-0.3, 0.5, n), rng.uniform(-0.2, 0.2, n), np.zeros(n)], -1)
    w_des = np.where(rng.uniform(size=n) < 0.5, 0.0, rng.uniform(-0.3, 0.3, n))
    return q, v, t, v_des, w_des


@pytest.fixture(scope="module")
def tspec():
    return TKD.make_cyclic_spec(TSolo.load_model(), trot, TSolo.q0(), device="cpu")


@pytest.fixture(scope="module")
def jspec():
    return JKD.make_cyclic_spec(JSolo.load_model(), jtrot, JSolo.q0())


def styled(spec, style):
    """The spec of a prologue style: "tiled_zero" (the Solo family's) or
    "vdes_weight" (the command-riding warm start and the weight-distributed
    force regularization, the Go2's)."""
    if style == "tiled_zero":
        return spec
    return dataclasses.replace(spec, warm_start_style="vdes",
                               params=dataclasses.replace(spec.params, f_reg_style="weight"))


def compact(spec, dtype, n, seed):
    """The kernel's compact inputs from the port's ``_compact_inputs``:
    (t, v_des_w, w_des, x_init, ee, hip, amom)."""
    st = [torch.as_tensor(a, dtype=dtype) for a in states(n, seed)]
    _, t, vdw, x_init, ee, hip, amom = TKD._compact_inputs(spec, *st)
    return t, vdw, st[4], x_init, ee, hip, amom


@pytest.mark.parametrize("style", ["tiled_zero", "vdes_weight"])
def test_prep_values_matches_jax(tspec, jspec, style):
    tsp, jsp = styled(tspec, style), styled(jspec, style)
    pc = TKD.make_prep_consts(tsp)
    jpc = cuda_fused.PrepConsts(**dataclasses.asdict(JKD.make_prep_consts(jsp)))
    np.testing.assert_allclose(pc.as_array(), jpc.as_array(), rtol=1e-12, atol=0)
    ins = compact(tsp, torch.float32, B, seed=3)
    m = float(tsp.model.total_mass)
    got = [a.numpy() for a in cuda_fused.prep_values(*ins, pc=pc, m=m, H=H, ne=NE)]

    def lanes(a):  # (B, ...) -> (..., B)
        return jnp.moveaxis(jnp.asarray(a.numpy(), jnp.float32), 0, -1)

    t, vdw, w, x_init, ee, hip, amom = ins
    ref = JPA.prep_values(lanes(t)[None], lanes(vdw), lanes(w)[None], lanes(x_init), lanes(ee),
                          lanes(hip), lanes(amom), pc=JKD.make_prep_consts(jsp), m=m, H=H, ne=NE)
    ref = [np.moveaxis(np.asarray(a), -1, 0) for a in ref]
    cnt, r, dt, swing, W, qlin, WF, qF, lb, ub, X0, F0 = got
    np.testing.assert_array_equal(cnt, ref[0])
    np.testing.assert_allclose(r, ref[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(dt, ref[2], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(swing, ref[3])
    np.testing.assert_allclose(W, ref[4], rtol=1e-6)
    np.testing.assert_allclose(qlin, ref[5], rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(WF, ref[6], rtol=1e-6)
    np.testing.assert_allclose(qF, ref[7], rtol=1e-5, atol=1e-4)
    if style == "vdes_weight":
        assert np.any(qF != 0.0)
    np.testing.assert_allclose(lb, ref[8], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ub, ref[9], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(X0, ref[10], atol=1e-5, rtol=0)
    assert np.all(F0 == 0.0) and np.all(ref[11] == 0.0)


def test_compact_inputs_match_jax(tspec, jspec):
    st = states(B, seed=5)
    got = TKD._compact_inputs(tspec, *[torch.as_tensor(a, dtype=torch.float64) for a in st])
    ref = jax.vmap(lambda *a: JKD._compact_inputs(jspec, *a))(
        *[jnp.asarray(a, jnp.float64) for a in st])
    for name, a, b in zip(("q", "t", "v_des_w", "x_init", "ee", "hip", "amom"), got, ref):
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host_lib("fused", tmp_path_factory)


def run_host(lib, ins, pc, m, cfg):
    args, keep, out = cuda_fused.kernel_args(*ins, m, pc, cfg, H, NE)
    symbol = "fused_host_f64" if ins[0].dtype == torch.float64 else "fused_host_f32"
    call_host(lib, symbol, cuda_fused.ARGTYPES, args)
    X, F, viol, iters, cnt, r, dt, swing, _ = out
    return X, F, viol, iters, cnt, r, dt, swing > 0.5


@pytest.mark.parametrize("style", ["tiled_zero", "vdes_weight"])
def test_kernel_math_f64_matches_plain(lib, tspec, style):
    sp = styled(tspec, style)
    pc = TKD.make_prep_consts(sp)
    m = float(sp.model.total_mass)
    ins = compact(sp, torch.float64, 6, seed=4)
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, fista_max_iters=30)
    X, F, viol, iters, cnt, r, dt, swing = run_host(lib, ins, pc, m, cfg)
    ref = cuda_fused.solve_from_state(*ins, m, pc, cfg, H, NE)
    assert torch.equal(cnt, ref[4]) and torch.equal(swing, ref[7])
    torch.testing.assert_close(r, ref[5], atol=1e-12, rtol=0)
    torch.testing.assert_close(dt, ref[6], atol=1e-12, rtol=0)
    torch.testing.assert_close(X, ref[0], atol=1e-7, rtol=0)
    torch.testing.assert_close(F, ref[1], atol=1e-7, rtol=0)
    assert torch.equal(iters, ref[3])
    assert torch.all(viol < cfg.exit_tol)


def test_kernel_math_f32_matches_plain(lib, tspec):
    pc = TKD.make_prep_consts(tspec)
    m = float(tspec.model.total_mass)
    ins = compact(tspec, torch.float32, 6, seed=11)
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, max_admm_iters=4)
    X, F, viol, iters, cnt, r, dt, swing = run_host(lib, ins, pc, m, cfg)
    ref = cuda_fused.solve_from_state(*ins, m, pc, cfg, H, NE)
    assert torch.equal(cnt, ref[4]) and torch.equal(swing, ref[7])
    np.testing.assert_allclose(r.numpy(), ref[5].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(X.numpy(), ref[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(F.numpy(), ref[1].numpy(), rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(viol.numpy(), ref[2].numpy(), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("h", [1, 6, 10, 12, 20, 24, 30, 40])
def test_work_layout_matches_kernel(lib, h):
    """The wrapper's device-memory workspace and K1's shared-memory slice
    (K3 runs in it) are the kernel's, at every Solo12 gait's horizon (6, 10,
    12, 20, 24, 30) and 40."""
    for name, size in (("fused_work_size", cuda_fused.work_size),
                       ("fused_shared_size", cuda_admm.shared_size)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_int]
        assert fn(h) == size(h)


def test_fused_path_matches_unfused_path(tspec):
    """The whole solve with fuse_prep=True (compact inputs, K3's plain
    version, IK, interpolation) against the unfused solve, on the CPU; K3
    keeps no dual (the JAX package's fused path neither), so the fused
    path's ``P_opt`` is zeros where the unfused path returns K1's."""
    st = [torch.as_tensor(a, dtype=torch.float64) for a in trot_states(4)]
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, fista_max_iters=30)
    fused = TKD.solve_mpc_batch(tspec, *st, admm_cfg=cfg, fuse_prep=True)
    plain = TKD.solve_mpc_batch(tspec, *st, admm_cfg=cfg)
    assert torch.all(fused.P_opt == 0) and torch.any(plain.P_opt != 0)
    for field in TKD.MpcPlan._fields:
        if field == "P_opt":
            continue
        a, b = getattr(fused, field), getattr(plain, field)
        assert a.shape == b.shape, field
        if field == "admm_iters":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=field)
    assert torch.all(fused.dyn_violation < 1e-3)
    with pytest.raises(ValueError, match="fuse_prep"):
        TKD.solve_mpc_batch(tspec, *st, admm_cfg=cuda_admm.plain_config(cfg),
                            admm_backend="torch", fuse_prep=True)


@pytest.mark.parametrize("name", ["jump", "walk", "still"])
def test_kernel_math_at_gait_horizons(lib, name):
    """K3's per-problem math on a gait's own compact inputs
    (``workload.gait_states(name, 4)``: jump H=30 with all-flight knots,
    walk H=6, still with every foot in stance): the g++ build against K3's
    plain version in f64 with bench.py's config, the gates of
    ``test_kernel_math_f64_matches_plain``. Jump's problem 1 diverges in
    both (tests/test_torch_admm.py): its plan flags must still agree, its
    iterates are not compared."""
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS
    from bunmpc_tpu_torch.workload import gait_states

    g = GAITS[name]
    sp = TKD.make_cyclic_spec(TSolo.load_model(), g, TSolo.q0(), device="cpu")
    pc, m, Hg = TKD.make_prep_consts(sp), float(sp.model.total_mass), sp.horizon
    st = [torch.as_tensor(a, dtype=torch.float64) for a in gait_states(name, 4)]
    _, t, vdw, x_init, ee, hip, amom = TKD._compact_inputs(sp, *st)
    ins = (t, vdw, st[4], x_init, ee, hip, amom)
    cfg = cuda_admm.CudaAdmmConfig(rho=g.rho, fista_max_iters=30)
    args, keep, out = cuda_fused.kernel_args(*ins, m, pc, cfg, Hg, NE)
    call_host(lib, "fused_host_f64", cuda_fused.ARGTYPES, args)
    X, F, viol, iters, cnt, r, dt, swing, _ = out
    ref = cuda_fused.solve_from_state(*ins, m, pc, cfg, Hg, NE)
    assert X.shape == (4, Hg + 1, 9)
    assert torch.equal(cnt, ref[4]) and torch.equal(swing > 0.5, ref[7])
    torch.testing.assert_close(r, ref[5], atol=1e-12, rtol=0)
    torch.testing.assert_close(dt, ref[6], atol=1e-12, rtol=0)
    assert torch.equal(iters, ref[3])
    ok = ref[2] < cfg.exit_tol
    assert int(ok.sum()) == (3 if name == "jump" else 4)
    torch.testing.assert_close(X[ok], ref[0][ok], atol=1e-7, rtol=0)
    torch.testing.assert_close(F[ok], ref[1][ok], atol=1e-7, rtol=0)
    assert bool((viol[~ok] > 1e3).all() and torch.isfinite(X).all())
