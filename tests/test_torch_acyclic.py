"""The acyclic motions in the port (``mpc/motions/solo12_acyclic.py``,
``mpc/motions/params.py``'s ``ACyclicMotionParams``, ``mpc/acyclic.py``)
against the JAX package's, on the same seeded numpy inputs.

* The six Solo12 motion tables and every field of ``make_acyclic_spec``
  equal the JAX package's.
* ``_lookup`` at, just before and just after every segment start, before
  the first and past the last, against the JAX ``_lookup`` (exact).
* Knot times and first-knot durations against the eager JAX expressions in
  float64 at the batch's clocks (1e-12), and the segments they select equal.
* The whole plain solve of each motion in float64 at B=2 against the JAX
  package's jitted ``solve_acyclic_mpc`` (tests/torch_acyclic_reference.py,
  the fixture tests/fixtures/torch_acyclic_solo12.npz; ``hifive`` at the
  fixture's plan_freq): every ``MpcPlan`` field within atol 1e-6, equal
  ADMM iterations, on the problems that converge; rearing's and hifive's
  start diverges in both packages. The ``slow`` test regenerates the
  fixture.
* tests/test_acyclic.py's ``stand`` and ``jump_fwd`` assertions on the
  port's plain solve.
* At hifive's own plan_freq the plan covers the whole horizon: the port
  repeats the last force knot (the JAX package's reshape raises there).
* The kernels' per-problem math (g++ builds) on acyclic problems: K1
  against its plain version, K2 at IK H 30 (``stand``) against its plain
  version; one problem of IK H 30 fits a block's shared memory for K1 and
  K2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_acyclic_reference as REF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.mpc import acyclic as JAC
from bunmpc_tpu.mpc.motions import solo12_acyclic as jmotions
from bunmpc_tpu.robots.solo12 import Solo12Config as JC
from bunmpc_tpu_torch import _build, convert, workload
from bunmpc_tpu_torch.mpc import acyclic as TAC
from bunmpc_tpu_torch.mpc import ik as TIK
from bunmpc_tpu_torch.mpc import kino_dyn as TKD
from bunmpc_tpu_torch.mpc.motions import solo12_acyclic as tmotions
from bunmpc_tpu_torch.solvers import biconvex, cuda_admm, cuda_ddp, ddp
from torch_port_helpers import call_host, host_lib

F64 = torch.float64
NAMES = list(jmotions.MOTIONS)
SPEC_ARRAYS = ("dt_arr", "cnt_starts", "cnt_vals", "xnom_starts", "xnom_vals", "x_ter",
               "bounds_starts", "bounds_vals", "swing_starts", "swing_ends", "swing_vals",
               "sreg_starts", "sreg_wt", "sreg_x", "sreg_scale", "creg_starts", "creg_wt",
               "creg_scale")


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def same(a, b):
    """Equal tables: arrays element by element, lists and scalars as arrays."""
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a, dtype=object if isinstance(a, str) else float),
                          np.asarray(b, dtype=object if isinstance(b, str) else float))


def test_motion_tables_match_jax():
    assert list(tmotions.MOTIONS) == NAMES == ["jump_fwd", "cartwheel", "rearing", "stand",
                                               "hifive", "rearing_jump"]
    for name in NAMES:
        t, j = tmotions.MOTIONS[name], jmotions.MOTIONS[name]
        for f in dataclasses.fields(j):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if isinstance(b, str):
                assert a == b, (name, f.name)
            else:
                assert same(a, b), (name, f.name)


@pytest.mark.parametrize("name", NAMES)
def test_acyclic_spec_matches_jax(name):
    tspec = workload.acyclic_spec(name, device="cpu")
    jspec = JAC.make_acyclic_spec(JC.load_model(), jmotions.MOTIONS[name])
    for f in ("horizon", "ik_hor", "size", "n_int", "plan_freq", "eff_frames"):
        assert getattr(tspec, f) == getattr(jspec, f), f
    for f in SPEC_ARRAYS:
        np.testing.assert_array_equal(getattr(tspec, f), getattr(jspec, f), err_msg=f)
    assert 20 <= tspec.horizon <= 30 and tspec.ik_hor == tspec.horizon


def test_lookup_at_segment_edges():
    """Segment starts taken exactly, an ulp either side, before the first
    and past the last segment (clamped), on every motion's contact table."""
    for name in NAMES:
        spec = workload.acyclic_spec(name, device="cpu")
        starts = spec.cnt_starts
        ft = np.concatenate([starts, np.nextafter(starts, -np.inf), np.nextafter(starts, np.inf),
                             [-1.0, 0.0, 5.0, starts[-1] + 0.013]])[None]
        got = TAC._lookup(starts, spec.cnt_vals, t64(ft)).numpy()
        ref = np.asarray(JAC._lookup(starts, spec.cnt_vals, jnp.asarray(ft)))
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_knot_times_match_eager_jax(name):
    """The knot times (rounded to 1 ms) and the first knot's duration of a
    batch at the workload's clocks, against the JAX package's expressions
    (acyclic.py:160-163) run eagerly in float64, and the contact segments
    they select."""
    spec = workload.acyclic_spec(name, device="cpu")
    _, _, t = workload.acyclic_states(name, 16)
    knot_t, dts = TAC.knot_times(spec, t64(t))
    dt_arr = jnp.asarray(spec.dt_arr)
    for b in range(16):
        jt = jnp.asarray(t[b])
        ref_kt = jnp.round(jt - dt_arr[0] + jnp.cumsum(dt_arr), 3)
        dt0 = dt_arr[0] - jnp.round(jnp.mod(jt, dt_arr[0]), 2)
        ref_dt = dt_arr.at[0].set(jnp.where(dt0 == 0.0, dt_arr[0], dt0))
        np.testing.assert_allclose(knot_t[b].numpy(), np.asarray(ref_kt), atol=1e-12, rtol=0)
        np.testing.assert_allclose(dts[b].numpy(), np.asarray(ref_dt), atol=1e-12, rtol=0)
        np.testing.assert_array_equal(
            TAC._lookup(spec.cnt_starts, spec.cnt_vals, knot_t[b:b + 1]).numpy()[0],
            np.asarray(JAC._lookup(spec.cnt_starts, spec.cnt_vals, ref_kt)))
    assert (dts > 0.0).all()


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


@pytest.mark.parametrize("name", NAMES)
def test_plain_solve_matches_jax(reference, name):
    spec = workload.acyclic_spec(name, device="cpu", plan_freq=REF.PLAN_FREQ.get(name))
    plan = TAC.solve_acyclic_mpc_batch(spec, *[t64(a) for a in REF.inputs(name)],
                                       admm_backend="torch", ik_backend="torch")
    got = convert.plan_to_numpy(plan)
    # a problem the JAX package's ADMM diverges on (violation above 1e3 or
    # NaN: rearing's and hifive's start) diverges on the port too; its
    # values are rounding grown without bound, so only the others compare
    div = ~(reference[f"{name}/dyn_violation"] <= 1e3)
    np.testing.assert_array_equal(~(got["dyn_violation"] <= 1e3), div)
    assert div.sum() == (1 if name in ("rearing", "hifive") else 0) and not div[1]
    for field in TKD.MpcPlan._fields:
        ref = reference[f"{name}/{field}"]
        assert got[field].shape == ref.shape, field
        if field == "admm_iters":
            np.testing.assert_array_equal(got[field][~div], ref[~div], err_msg=field)
        else:
            np.testing.assert_allclose(got[field][~div], ref[~div], atol=1e-6, rtol=0,
                                       err_msg=field)


def solve(name, **cfg):
    """tests/test_acyclic.py's solve: the motion's start at t=0 on the plain
    backends in float64 with its ADMM cap and 3 DDP iterations."""
    spec = workload.acyclic_spec(name, device="cpu")
    p = tmotions.MOTIONS[name]
    q, v, t = workload.acyclic_states(name, 1)
    return spec, TAC.solve_acyclic_mpc_batch(
        spec, t64(q), t64(v), t64(t), admm_backend="torch", ik_backend="torch",
        admm_cfg=biconvex.BiconvexConfig(rho=p.rho, **cfg), ddp_cfg=ddp.DdpConfig(n_iters=3))


def test_stand_solve_converges():
    """tests/test_acyclic.py:33-50 on the port."""
    _, plan = solve("stand", max_admm_iters=60)
    assert float(plan.dyn_violation[0]) < 2e-3
    X = plan.X_opt[0].numpy()
    assert np.all(np.abs(X[:, 2] - 0.22) < 0.03)
    np.testing.assert_allclose(plan.F_opt[0, ..., 2].sum(-1).mean().item(), 2.5 * 9.81, atol=3.0)


def test_jump_flight_phase():
    """tests/test_acyclic.py:53-73 on the port: no contact in the flight
    window [0.4, 0.7) s, contact elsewhere, a converged plan."""
    spec, plan = solve("jump_fwd", max_admm_iters=80)
    cnt = plan.cnt_plan[0, ..., 0].numpy()
    knot_times = np.arange(spec.horizon) * tmotions.jump_fwd.dt_arr[0]
    flight = (knot_times >= 0.4) & (knot_times < 0.7)
    assert cnt[flight].sum() == 0
    assert cnt[~flight].sum() > 0
    assert float(plan.dyn_violation[0]) < 5e-3


def test_hifive_plan_covering_the_horizon_repeats_the_last_force():
    """At its own plan_freq (1.4 s) hifive interpolates as many knots as the
    horizon has: the forces' last knot is repeated, so the 1 kHz forces
    past the last knot's start hold F's last knot."""
    spec = workload.acyclic_spec("hifive", device="cpu")
    assert spec.size == spec.horizon == 25
    q, v, t = workload.acyclic_states("hifive", 1)
    plan = TAC.solve_acyclic_mpc_batch(spec, t64(q), t64(v), t64(t), admm_backend="torch",
                                       ik_backend="torch")
    assert plan.f_int.shape == (1, spec.n_int, 12)
    last = int(round(float(plan.cnt_plan.shape[1] - 1) * 0.05 / 0.001))  # the last knot, in ms
    torch.testing.assert_close(plan.f_int[0, last:], plan.F_opt[0, -1].reshape(1, 12).expand(
        spec.n_int - last, 12), atol=0, rtol=1e-12)


def test_backend_names_are_checked():
    spec = workload.acyclic_spec("stand", device="cpu")
    st = [t64(a) for a in workload.acyclic_states("stand", 1)]
    with pytest.raises(ValueError, match="admm_backend"):
        TAC.solve_acyclic_mpc_batch(spec, *st, admm_backend="pallas")
    with pytest.raises(ValueError, match="ik_backend"):
        TAC.solve_acyclic_mpc_batch(spec, *st, ik_backend="xla")


@pytest.mark.slow
def test_fixture_is_the_jax_acyclic_solve():
    """The committed reference is what the JAX package computes today
    (minutes: one compile of the JAX solve per motion)."""
    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)


# ---- the kernels' per-problem math (g++ builds) on acyclic problems ----


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return {name: host_lib(name, tmp_path_factory) for name in ("admm", "ddp")}


def problems(name, n=3):
    spec = workload.acyclic_spec(name, device="cpu")
    q, v, t = (t64(a) for a in workload.acyclic_states(name, n))
    pr = TAC._prepare(spec, q, v, t)
    args = (pr["plan"], spec.model.total_mass, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"],
            pr["X_wm"], pr["F_wm"], pr["x_bounds"])
    return spec, (q, v, t), pr, args


def test_one_problem_at_ik_h30_fits_a_block():
    """K1 at H 30 and K2 at IK H 30 (stand, the longest motion) fit one
    problem a block at least, in the 227 KB a block may take."""
    for H in (20, 24, 25, 30):
        assert 1 <= cuda_admm.launch_per_block(H) <= cuda_admm.PER_BLOCK
        k2 = cuda_ddp.launch_per_block(H)
        assert 1 <= k2 < cuda_ddp.PER_BLOCK
        assert k2 * 4 * cuda_ddp.shared_size(H, 19, 18) <= _build.SMEM_PER_BLOCK


@pytest.mark.parametrize("name", ["stand", "jump_fwd"])
def test_k1_kernel_math_on_acyclic_problems(libs, name):
    """K1's g++ build in f64 on the motion's problems (per-knot contact plan,
    box and nominal state from the segments, no force reference) with the
    motion's default config: X, F, P within 1e-7 of its plain version and
    equal iterations."""
    spec, _, _, args = problems(name)
    cfg = cuda_admm.CudaAdmmConfig(rho=tmotions.MOTIONS[name].rho, x_solver="thomas")
    kargs, keep, out = cuda_admm.kernel_args(*args, cfg)
    call_host(libs["admm"], "admm_host_f64", cuda_admm.ARGTYPES, kargs)
    ref = cuda_admm.solve_plain(*args, cfg)
    np.testing.assert_array_equal(out[3].numpy(), ref[3].numpy())
    for i, j in ((0, 0), (1, 1), (5, 4)):
        np.testing.assert_allclose(out[i].numpy(), ref[j].numpy(), atol=1e-7, rtol=0)


def test_k2_kernel_math_at_ik_h30(libs):
    """K2's g++ build on stand's IK problems at IK H 30, with per-knot
    regularization weights and reference states, built from the plain
    ADMM's solves: one Gauss-Newton step with one alpha in f64 (xs 1e-9, us
    1e-7, cost rtol 1e-10) and the full DdpConfig at the plan's f64 gate
    (xs 1e-6, us 1e-6 / dt, cost rtol 1e-10)."""
    spec, (q, v, _), pr, args = problems("stand")
    X = cuda_admm.solve_plain(*args, cuda_admm.CudaAdmmConfig(rho=tmotions.stand.rho))[0]
    tasks = TAC._ik_tasks(spec, pr, X)
    model, eff = spec.model, spec.eff_frames
    w_stage, w_term, ctrl_w, x_reg = TIK.dense_weights(model, eff, tasks)
    dargs = (torch.cat([q, v], -1), tasks.ee_targets, tasks.com_ref, tasks.mom_ref, x_reg,
             w_stage, w_term, ctrl_w, tasks.dts)
    assert dargs[-1].shape[1] == 30
    for cfg_, xs_tol, us_tol, c_tol in (
            (cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,)), 1e-9, 1e-7, 1e-10),
            (cuda_ddp.CudaDdpConfig(), 1e-6, 1e-6 / 0.04, 1e-10)):
        kargs, keep, out = cuda_ddp.kernel_args(model, eff, *dargs, cfg_)
        call_host(libs["ddp"], "ddp_host_f64", cuda_ddp.ARGTYPES, kargs)
        ref = cuda_ddp.solve_ik_batch_plain(model, eff, *dargs, cfg=cfg_)
        np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=xs_tol, rtol=0)
        np.testing.assert_allclose(out[1].numpy(), ref[1].numpy(), atol=us_tol, rtol=0)
        np.testing.assert_allclose(out[2].numpy(), ref[2].numpy(), rtol=c_tol)
