"""The slice as a whole: the port's ``solve_mpc_batch`` (problem assembly,
ADMM, IK task build, GN-DDP, 1 kHz interpolation) against the JAX package's,
and against the committed native fixture.

* Plain path ("torch", "torch") against the JAX package's ("xla", "xla") with
  bench.py's ADMM config at B=4 in float64: every MpcPlan field within atol
  1e-6 and equal ADMM iteration counts.
* The native fixture tests/fixtures/solo12_trot_e2e.npz with the reference
  ADMM schedule of tests/test_e2e_parity.py (thomas X-solve, dual_relax 1,
  rho_growth 1). K1's per-problem math (the g++ build of csrc/admm.cu) in f32
  at exit_tol 1e-5: viol < 1e-4, |dX| < 1e-3, |dF| < 5e-3 (:161-176). The
  whole plain path in f64 with the default DdpConfig, at the exit_tol 1e-6 of
  that file's full-chain check (at 1e-5 the remaining X error of ~3e-4 shows
  as ~1e-2 in the accelerations): additionally |dxs| < 1e-3, |dus| < 5e-3
  (:136-139).
* Under ``utils.profiling.recording()`` a solve records ``mpc.solve`` around
  its five stages, in order, and the largest of its ADMM iteration counts.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot as jtrot
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu.solvers.biconvex import BiconvexConfig as JBiconvexConfig
from bunmpc_tpu_torch import convert
from bunmpc_tpu_torch.kin import algorithms as TK
from bunmpc_tpu_torch.mpc import kino_dyn as TKD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TSolo
from bunmpc_tpu_torch.solvers import cuda_admm
from bunmpc_tpu_torch.solvers.biconvex import BiconvexConfig
from bunmpc_tpu_torch.solvers.ddp import DdpConfig
from bunmpc_tpu_torch.utils import profiling
from bunmpc_tpu_torch.workload import trot_states

from torch_port_helpers import call_host, host_lib

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "solo12_trot_e2e.npz")
B = 4


@pytest.fixture(scope="module")
def tspec():
    return TKD.make_cyclic_spec(TSolo.load_model(), trot, TSolo.q0(), device="cpu")


@pytest.fixture(scope="module")
def plans(tspec):
    states = trot_states(B)
    # jitted, the JAX package's first-knot dt degenerates to ~1e-18 where
    # mod(t, gait_dt) rounds up to gait_dt (tests/test_torch_prep.py); these
    # states are clear of it
    assert np.all(np.round(np.mod(states[2], 0.05), 2) < 0.05)
    jspec = JKD.make_cyclic_spec(JSolo.load_model(), jtrot, JSolo.q0())
    jcfg = JBiconvexConfig(rho=jtrot.rho, x_solver="thomas", fista_max_iters=30)
    jplan = jax.jit(lambda *a: JKD.solve_mpc_batch(
        jspec, *a, admm_cfg=jcfg, admm_backend="xla", ik_backend="xla"))(
        *[jnp.asarray(a, jnp.float64) for a in states])
    tcfg = BiconvexConfig(rho=trot.rho, x_solver="thomas", fista_max_iters=30)
    tplan = TKD.solve_mpc_batch(
        tspec, *[torch.as_tensor(a, dtype=torch.float64) for a in states], admm_cfg=tcfg,
        admm_backend="torch", ik_backend="torch",
    )
    return jplan, tplan


@pytest.mark.parametrize("field", list(TKD.MpcPlan._fields))
def test_plain_path_matches_jax(plans, field):
    jplan, tplan = plans
    got = convert.plan_to_numpy(tplan)[field]
    ref = convert.plan_to_numpy(jplan)[field]
    assert got.shape == ref.shape
    if field == "admm_iters":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_plan_is_converged(plans):
    _, tplan = plans
    assert torch.all(tplan.dyn_violation < 1e-3)
    assert torch.all(torch.isfinite(tplan.xs_int))


def test_cuda_backends_on_cpu_run_the_plain_path(tspec):
    states = [torch.as_tensor(a, dtype=torch.float64) for a in trot_states(2, seed=3)]
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, fista_max_iters=30, max_admm_iters=8)
    got = TKD.solve_mpc_batch(tspec, *states, admm_cfg=cfg)
    ref = TKD.solve_mpc_batch(tspec, *states, admm_cfg=cuda_admm.plain_config(cfg),
                              admm_backend="torch", ik_backend="torch")
    for field in ("xs_int", "us_int", "f_int", "X_opt", "F_opt", "xs", "us", "P_opt"):
        torch.testing.assert_close(getattr(got, field), getattr(ref, field), atol=0, rtol=0)
    assert torch.any(got.P_opt != 0)  # K1's plain version returns the dual


def test_solve_records_its_five_stages(tspec):
    states = [torch.as_tensor(a, dtype=torch.float64) for a in trot_states(2, seed=3)]
    cfg = BiconvexConfig(rho=trot.rho, fista_max_iters=30, max_admm_iters=8)
    with profiling.recording() as rec:
        plan = TKD.solve_mpc_batch(tspec, *states, admm_cfg=cfg, ddp_cfg=DdpConfig(n_iters=1),
                                   admm_backend="torch", ik_backend="torch")
    solve, *stages = rec.spans
    assert solve.name == "mpc.solve" and solve.parent is None
    assert [s.name for s in stages] == ["mpc.prep", "mpc.k1", "mpc.ik_build", "mpc.k2",
                                        "mpc.finish"]
    assert all(s.parent == s.root == solve.id for s in stages)
    assert solve.start <= stages[0].start and stages[-1].end <= solve.end
    assert all(a.end <= b.start for a, b in zip(stages, stages[1:]))
    assert rec.counters == {"mpc.admm_iters_max": [float(plan.admm_iters.max())]}


def test_model_from_jax_arrays():
    """The JAX RobotModel's fields, carried over as numpy arrays, give the
    port's model: same constants, same kinematics."""
    jm = JSolo.load_model()
    got = convert.model_from_arrays(dataclasses.asdict(jm))
    ref = TSolo.load_model()
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "frames":
            assert a.keys() == b.keys()
            for n in a:
                assert a[n].body == b[n].body
                np.testing.assert_array_equal(a[n].pos, b[n].pos)
                np.testing.assert_array_equal(a[n].rot, b[n].rot)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    q = torch.as_tensor(np.tile(TSolo.q0(), (2, 1)))
    for a, b in zip(TK.fk(got, q), TK.fk(ref, q)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_warm_start_from_arrays():
    X = np.zeros((3, 21, 9))
    F = np.ones((3, 20, 4, 3))
    Xt, Ft = convert.warm_start_from_arrays(X, F, "cpu")
    assert Xt.dtype == Ft.dtype == torch.float32 and Xt.is_contiguous()
    assert tuple(Xt.shape) == (3, 21, 9) and float(Ft.sum()) == 3 * 20 * 12
    with pytest.raises(ValueError):
        convert.warm_start_from_arrays(X[:, :20], F, "cpu")


def _fixture_problem(spec, dtype):
    fx = np.load(FIXTURE)
    row = lambda a: torch.as_tensor(np.asarray(a, np.float64)[None], dtype=dtype)  # noqa: E731
    states = (row(fx["q"]), row(fx["v"]), row(float(fx["t"])), row(fx["v_des"]),
              row(float(fx["w_des"])))
    return fx, states


REFERENCE_SCHEDULE = dict(x_solver="thomas", exit_tol=1e-5, max_admm_iters=500,
                          dual_relax=1.0, rho_growth=1.0)


def test_plain_path_matches_native_fixture(tspec):
    fx, states = _fixture_problem(tspec, torch.float64)
    schedule = dict(REFERENCE_SCHEDULE, exit_tol=1e-6, max_admm_iters=1200)
    plan = TKD.solve_mpc_batch(
        tspec, *states, admm_cfg=BiconvexConfig(rho=trot.rho, **schedule),
        admm_backend="torch", ik_backend="torch",
    )
    assert float(plan.dyn_violation[0]) < 1e-4
    assert np.abs(plan.X_opt[0].numpy() - fx["X_opt"]).max() < 1e-3
    assert np.abs(plan.F_opt[0].numpy() - fx["F_opt"]).max() < 5e-3
    assert np.abs(plan.xs[0].numpy() - fx["xs"]).max() < 1e-3
    assert np.abs(plan.us[0].numpy() - fx["us"]).max() < 5e-3


def test_kernel_math_matches_native_fixture(tspec, tmp_path_factory):
    """K1's per-problem math in f32 on the fixture window, as chip_smoke.py
    holds the kernel on the card."""
    lib = host_lib("admm", tmp_path_factory)
    fx, states = _fixture_problem(tspec, torch.float32)
    prob = TKD._prepare_problem(tspec, *states)
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, **REFERENCE_SCHEDULE)
    args, keep, out = cuda_admm.kernel_args(
        prob["plan"], tspec.model.total_mass, prob["x_init"], prob["W"], prob["X_ref"],
        prob["W_F"], prob["X_wm"], prob["F_wm"], prob["x_bounds"], cfg,
    )
    call_host(lib, "admm_host_f32", cuda_admm.ARGTYPES, args)
    X, F, viol = out[0][0].double().numpy(), out[1][0].double().numpy(), float(out[2][0])
    assert viol < 1e-4
    assert np.abs(X - fx["X_opt"]).max() < 1e-3
    assert np.abs(F - fx["F_opt"]).max() < 5e-3
