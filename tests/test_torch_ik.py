"""K2's plain version (``mpc/ik.py`` + ``solvers/ddp.py``) and K2's
per-problem math (``csrc/ddp.cu`` built for the host with g++) against the
JAX package's kinematic GN-DDP (``ik.solve_ik``), on the random IK problem of
tests/test_pallas_ddp.py (H=3) from two start states.

Tolerances: residual weights and residuals rtol 1e-6 (the JAX package's own
gate); the full DdpConfig in f64, xs atol 1e-8 (the same algorithm in double
precision, rounding amplified by the conditioning of Quu) and us atol 2e-7:
the controls are the velocity increments of xs over a knot, us_k =
(v_{k+1} - v_k) / dt, so an error at the xs gate shows in us divided by
dt = 0.05; one iteration with one alpha in f32, the JAX package's
Pallas-vs-XLA gates (xs 2e-4, us 2e-3, cost rtol 1e-4)."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bunmpc_tpu.mpc import ik as JIK
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu.solvers import ddp as JDDP
from bunmpc_tpu_torch.mpc import ik as TIK
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TSolo
from bunmpc_tpu_torch.solvers import cuda_ddp
from bunmpc_tpu_torch.solvers import ddp as TDDP

from torch_port_helpers import call_host, host_lib

H, NV = 3, 18
EFF = tuple(TSolo.eff_names)
ONE = dict(n_iters=1, alphas=(1.0,))
US_ATOL_F64 = 1e-8 / 0.05


def task_data(seed=7):
    rng = np.random.default_rng(seed)
    return dict(
        ee_targets=rng.normal(size=(H, 4, 3)) * 0.1,
        ee_wts=rng.uniform(0.5, 2.0, size=(H, 4)),
        com_ref=rng.normal(size=(H + 1, 3)) * 0.05,
        mom_ref=rng.normal(size=(H + 1, 6)) * 0.05,
        state_wt=rng.uniform(0.1, 1.0, size=2 * NV),
        ctrl_wt=rng.uniform(0.1, 1.0, size=NV),
        x_reg=np.concatenate([TSolo.q0(), np.zeros(NV)]),
    )


def start_states(seed=11):
    rng = np.random.default_rng(seed)
    x0 = np.concatenate([TSolo.q0(), np.zeros(NV)])
    x1 = x0.copy()
    x1[7:19] += rng.normal(size=12) * 0.05
    x1[19:] += rng.normal(size=NV) * 0.1
    return np.stack([x0, x1])


def jax_tasks(d, dtype):
    c = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return JIK.IkTasks(
        ee_targets=c(d["ee_targets"]), ee_wts=c(d["ee_wts"]), com_ref=c(d["com_ref"]),
        mom_ref=c(d["mom_ref"]), com_wt=c(3.0), mom_wt=c(2.0), state_wt=c(d["state_wt"]),
        x_reg=c(d["x_reg"]), reg_wt_state=0.7, reg_wt_ctrl=1e-4, ctrl_wt=c(d["ctrl_wt"]),
        dts=jnp.full(H, 0.05, dtype),
    )


def torch_tasks(d, B, dtype):
    rep = lambda a: torch.as_tensor(np.broadcast_to(a, (B,) + np.shape(a)).copy(), dtype=dtype)  # noqa: E731,E501
    return TIK.IkTasks(
        ee_targets=rep(d["ee_targets"]), ee_wts=rep(d["ee_wts"]), com_ref=rep(d["com_ref"]),
        mom_ref=rep(d["mom_ref"]), com_wt=3.0, mom_wt=2.0,
        state_wt=torch.as_tensor(d["state_wt"], dtype=dtype),
        x_reg=torch.as_tensor(d["x_reg"], dtype=dtype), reg_wt_state=0.7, reg_wt_ctrl=1e-4,
        ctrl_wt=torch.as_tensor(d["ctrl_wt"], dtype=dtype), dts=rep(np.full(H, 0.05)),
    )


def jax_solve(d, x0s, cfg, dtype):
    model = JSolo.load_model()
    tasks = jax_tasks(d, dtype)
    fn = jax.jit(jax.vmap(lambda x: tuple(JIK.solve_ik(model, EFF, x, tasks, cfg))))
    return [np.asarray(a) for a in fn(jnp.asarray(x0s, dtype))]


def dense_args(d, x0s, dtype):
    model = TSolo.load_model()
    tasks = torch_tasks(d, len(x0s), dtype)
    w_stage, w_term, ctrl_w, x_reg = TIK.dense_weights(model, EFF, tasks)
    return (model, EFF, torch.as_tensor(x0s, dtype=dtype), tasks.ee_targets, tasks.com_ref,
            tasks.mom_ref, x_reg, w_stage, w_term, ctrl_w, tasks.dts)


def host_solve(lib, d, x0s, cfg, dtype):
    args, keep, out = cuda_ddp.kernel_args(*dense_args(d, x0s, dtype), cfg)
    call_host(lib, "ddp_host_f64" if dtype == torch.float64 else "ddp_host_f32",
              cuda_ddp.ARGTYPES, args)
    return [a.numpy() for a in out]


@pytest.fixture(scope="module")
def data():
    return task_data(), start_states()


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host_lib("ddp", tmp_path_factory)


def test_dense_weights_and_residuals(data):
    d, x0s = data
    jm, tm = JSolo.load_model(), TSolo.load_model()
    jt, tt = jax_tasks(d, jnp.float64), torch_tasks(d, 2, torch.float64)
    j_stage, j_term, j_ctrl = JIK.build_residual_fns(jm, EFF, jt)
    t_stage, t_term, t_ctrl = TIK.build_residual_fns(tm, EFF, tt)
    jw = JIK.dense_weights(jm, EFF, jt)
    tw = TIK.dense_weights(tm, EFF, tt)
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(t_ctrl[1].numpy(), np.asarray(j_ctrl), rtol=1e-6)
    xs = torch.as_tensor(x0s, dtype=torch.float64)
    for k in range(H):
        r_t, w_t = t_stage(xs, k)
        for i in range(2):
            r_j, w_j = j_stage(jnp.asarray(x0s[i]), k)
            np.testing.assert_allclose(r_t[i].numpy(), np.asarray(r_j), rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(w_t[i].numpy(), np.asarray(w_j), rtol=1e-6)
    r_t, _ = t_term(xs)
    for i in range(2):
        np.testing.assert_allclose(r_t[i].numpy(), np.asarray(j_term(jnp.asarray(x0s[i]))[0]),
                                   rtol=1e-6, atol=1e-12)


@pytest.fixture(scope="module")
def full_f64(data):
    d, x0s = data
    return jax_solve(d, x0s, JDDP.DdpConfig(), jnp.float64)


@pytest.fixture(scope="module")
def one_f32(data):
    d, x0s = data
    return jax_solve(d, x0s, JDDP.DdpConfig(**ONE), jnp.float32)


def test_plain_full_config_f64(data, full_f64):
    d, x0s = data
    res = TIK.solve_dense(*dense_args(d, x0s, torch.float64), TDDP.DdpConfig())
    np.testing.assert_allclose(res.xs.numpy(), full_f64[0], atol=1e-8, rtol=0)
    np.testing.assert_allclose(res.us.numpy(), full_f64[1], atol=US_ATOL_F64, rtol=0)
    np.testing.assert_allclose(res.cost.numpy(), full_f64[2], rtol=1e-10)


def test_plain_single_iteration_f32(data, one_f32):
    d, x0s = data
    res = TIK.solve_dense(*dense_args(d, x0s, torch.float32), TDDP.DdpConfig(**ONE))
    np.testing.assert_allclose(res.xs.numpy(), one_f32[0], atol=2e-4, rtol=0)
    np.testing.assert_allclose(res.us.numpy(), one_f32[1], atol=2e-3, rtol=0)
    np.testing.assert_allclose(res.cost.numpy(), one_f32[2], rtol=1e-4)


def test_kernel_math_full_config_f64(lib, data, full_f64):
    d, x0s = data
    xs, us, cost = host_solve(lib, d, x0s, cuda_ddp.CudaDdpConfig(), torch.float64)
    np.testing.assert_allclose(xs, full_f64[0], atol=1e-8, rtol=0)
    np.testing.assert_allclose(us, full_f64[1], atol=US_ATOL_F64, rtol=0)
    np.testing.assert_allclose(cost, full_f64[2], rtol=1e-10)


def test_kernel_math_single_iteration_f32(lib, data, one_f32):
    d, x0s = data
    xs, us, cost = host_solve(lib, d, x0s, cuda_ddp.CudaDdpConfig(**ONE), torch.float32)
    np.testing.assert_allclose(xs, one_f32[0], atol=2e-4, rtol=0)
    np.testing.assert_allclose(us, one_f32[1], atol=2e-3, rtol=0)
    np.testing.assert_allclose(cost, one_f32[2], rtol=1e-4)


@pytest.mark.parametrize("h", [1, 3, 5, 6, 10, 12, 15, 20, 40])
def test_scratch_layout_matches_kernel(lib, h):
    """The wrapper's sizes of a problem's shared-memory slice and device
    scratch are the kernel's layout, at every Solo12 gait's IK horizon (3,
    5, 6, 10, 12, 15), 20 and 40, for each joint count the kernel is built
    for (12: nq 19, nv 18; 8: nq 15, nv 14); another joint count has none."""
    for name, size in (("ddp_scratch_size", cuda_ddp.scratch_size),
                       ("ddp_shared_size", cuda_ddp.shared_size)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        assert cuda_ddp.JOINT_COUNTS == (12, 8)
        for nj in cuda_ddp.JOINT_COUNTS:
            assert fn(nj, h) == size(h, nj + 7, nj + 6)
        assert fn(10, h) == -1


def test_horizon_past_shared_memory_raises():
    """A horizon whose one problem fits a block's shared memory runs with
    fewer problems a block; past that the launch raises, naming the limit."""
    assert cuda_ddp.launch_per_block(10) == cuda_ddp.PER_BLOCK
    assert 1 <= cuda_ddp.launch_per_block(40) < cuda_ddp.PER_BLOCK
    with pytest.raises(ValueError, match="232448 bytes a thread block"):
        cuda_ddp.launch_per_block(100)


def test_kernel_math_single_iteration_f64(lib, data):
    """One Gauss-Newton step in f64: the kernel's hand-derived tangent
    Jacobians, block-structured Riccati and Cholesky against the plain version's
    autodiff-chart Jacobians and batched LAPACK (the same step to rounding)."""
    d, x0s = data
    xs, us, cost = host_solve(lib, d, x0s, cuda_ddp.CudaDdpConfig(**ONE), torch.float64)
    res = TIK.solve_dense(*dense_args(d, x0s, torch.float64), TDDP.DdpConfig(**ONE))
    np.testing.assert_allclose(xs, res.xs.numpy(), atol=1e-11, rtol=0)
    np.testing.assert_allclose(us, res.us.numpy(), atol=1e-9, rtol=0)
    np.testing.assert_allclose(cost, res.cost.numpy(), rtol=1e-12)


@pytest.mark.parametrize("name", ["jump", "walk", "still"])
def test_kernel_math_at_gait_horizons(lib, name):
    """K2's per-problem math on a gait's own IK problems (jump IK H=15,
    walk 3, still 10), built from the plain ADMM's converged solves of
    ``workload.gait_states(name, 4)``: the g++ build against the plain
    version in f64, one Gauss-Newton step with one alpha at the gates of
    ``test_kernel_math_single_iteration_f64``, and the full DdpConfig at the
    whole plan's f64 gate on real problems (tests/test_torch_kino_dyn.py:
    xs 1e-6; us 1e-6 / dt): six steps on these weights (1e-5..1e4) move
    f64 rounding to ~1e-8."""
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS
    from bunmpc_tpu_torch.solvers import cuda_admm
    from bunmpc_tpu_torch.workload import gait_states

    g = GAITS[name]
    model = TSolo.load_model()
    spec = KD.make_cyclic_spec(model, g, TSolo.q0(), device="cpu")
    pr = KD._prepare_problem(spec, *[torch.as_tensor(a, dtype=torch.float64)
                                     for a in gait_states(name, 4)])
    cfg = cuda_admm.CudaAdmmConfig(rho=g.rho, fista_max_iters=30)
    X, _, viol, _, _ = cuda_admm.solve_plain(
        pr["plan"], model.total_mass, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"], pr["X_wm"],
        pr["F_wm"], pr["x_bounds"], cfg)
    ok = viol < cfg.exit_tol  # jump's problem 1 diverges (test_torch_admm.py)
    tasks, x0 = KD._build_ik_tasks(spec, pr, X)
    w_stage, w_term, ctrl_w, x_reg = TIK.dense_weights(model, EFF, tasks)
    args = tuple(a[ok].contiguous() for a in (x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref,
                                              x_reg, w_stage, w_term, ctrl_w, tasks.dts))
    assert args[-1].shape[1] == spec.ik_hor
    for cfg_, xs_tol, us_tol, c_tol in ((cuda_ddp.CudaDdpConfig(**ONE), 1e-11, 1e-9, 1e-12),
                                        (cuda_ddp.CudaDdpConfig(), 1e-6, 1e-6 / 0.05, 1e-10)):
        kargs, keep, out = cuda_ddp.kernel_args(model, EFF, *args, cfg_)
        call_host(lib, "ddp_host_f64", cuda_ddp.ARGTYPES, kargs)
        ref = cuda_ddp.solve_ik_batch_plain(model, EFF, *args, cfg=cfg_)
        np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=xs_tol, rtol=0)
        np.testing.assert_allclose(out[1].numpy(), ref[1].numpy(), atol=us_tol, rtol=0)
        np.testing.assert_allclose(out[2].numpy(), ref[2].numpy(), rtol=c_tol)
