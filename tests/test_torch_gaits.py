"""Every Solo12 cyclic gait of the port (``mpc/motions/solo12_cyclic.GAITS``)
against the JAX package's, on the same seeded numpy inputs.

* The gait tables and each spec: every table field equal, the horizon math
  of tests/test_mpc.py:163-174, and the spec's constants (hip offsets,
  composite inertia, horizon, IK horizon, interpolation knots) within 1e-12.
* Problem assembly (stage 1 of the main path): ``_prepare_problem`` against
  the eager JAX function (as tests/test_torch_prep.py: jitted, the JAX
  package's first-knot dt degenerates on knot clocks) at B=4 in float64:
  contact flags and the swing mask exact, every other field within atol
  1e-9. K3's plain prologue ``cuda_fused.prep_values`` on the compact
  inputs: against the JAX package's (an f32 function) in float32 under
  tests/test_fused_prep.py's gates, and against ``_prepare_problem`` in
  float64 within 1e-12. The eager JAX functions' outputs come from the
  fixture below (seconds a gait).
* The whole plain path ("torch", "torch") in float64 against the JAX
  package's ("xla", "xla") at B=2 with bench.py's ADMM config: every
  ``MpcPlan`` field within atol 1e-6 and equal ADMM iteration counts
  (tests/test_torch_kino_dyn.py's gate), through the fixture
  tests/fixtures/torch_gaits_solo12.npz (tests/torch_gaits_reference.py: the
  jitted JAX solve compiles once per horizon, minutes each); the ``slow``
  test regenerates and compares it. Problem 0 is the gait's own check from
  q0 at rest: ``dyn_violation`` under the JAX test's bound (tests/test_mpc.py:
  1e-3 for bound_turn and air_bound, 1e-2 for walk; the exit tolerance 1e-3
  elsewhere) and, for those three, the CoM within 8 cm of the nominal
  height. A problem on which the JAX package's ADMM diverges (jump's problem
  1) must diverge in the port too, at the same iteration count; its plan is
  not compared.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_gaits_reference as REF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import GAITS as JGAITS
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu_torch import convert
from bunmpc_tpu_torch.mpc import kino_dyn as TKD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TSolo
from bunmpc_tpu_torch.solvers import cuda_fused
from bunmpc_tpu_torch.solvers.biconvex import BiconvexConfig

F64 = torch.float64
ATOL = 1e-9
NAMES = list(JGAITS)
# the JAX package's bound on problem 0 where it solves the gait
# (tests/test_mpc.py:177-221); the ADMM's exit tolerance elsewhere
VIOLATION_BOUND = {"walk": 1e-2}


def test_gait_registry_matches_jax():
    assert list(GAITS) == NAMES
    assert len(NAMES) == 10


@pytest.fixture(scope="module")
def models():
    return JSolo.load_model(), TSolo.load_model()


def specs(models, name):
    jm, tm = models
    return (JKD.make_cyclic_spec(jm, JGAITS[name], JSolo.q0()),
            TKD.make_cyclic_spec(tm, GAITS[name], TSolo.q0(), device="cpu"))


@pytest.mark.parametrize("name", NAMES)
def test_gait_spec_matches_jax(models, name):
    g, jg = GAITS[name], JGAITS[name]
    for f in dataclasses.fields(jg):
        np.testing.assert_array_equal(np.asarray(getattr(g, f.name)),
                                      np.asarray(getattr(jg, f.name)), err_msg=f.name)
    assert g.horizon == int(np.round(g.gait_horizon * g.gait_period / g.gait_dt, 2))
    assert g.state_wt.shape == (36,) and g.ctrl_wt.shape == (18,)
    assert g.W_X.shape == (9,) and g.W_F.shape == (12,)
    jspec, tspec = specs(models, name)
    np.testing.assert_allclose(tspec.hip_offsets, np.asarray(jspec.hip_offsets), atol=1e-12)
    np.testing.assert_allclose(tspec.I_comp, np.asarray(jspec.I_comp), atol=1e-12)
    assert (tspec.horizon, tspec.ik_hor, tspec.size, tspec.n_int) == (
        jspec.horizon, jspec.ik_hor, jspec.size, jspec.n_int)
    assert tspec.gait == dataclasses.replace(
        tspec.gait, **{f.name: getattr(jspec.gait, f.name)
                       for f in dataclasses.fields(jspec.gait)})


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


@pytest.mark.parametrize("name", NAMES)
def test_prepare_problem_matches_jax(models, reference, name):
    _, tspec = specs(models, name)
    tp = TKD._prepare_problem(tspec, *[torch.as_tensor(a, dtype=F64)
                                       for a in REF.prep_inputs(name)])
    got = dict(tp, cnt=tp["plan"].cnt, r=tp["plan"].r, dt=tp["plan"].dt,
               lb=tp["x_bounds"][0], ub=tp["x_bounds"][1])
    for key in REF.PREP_FIELDS:
        a, b = got[key].numpy(), reference[f"{name}/prep/{key}"]
        assert a.shape == b.shape, key
        if key in ("cnt", "swing_mask"):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=key)
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], atol=ATOL, rtol=0, err_msg=key)
    cnt = reference[f"{name}/prep/cnt"]
    if name == "still":  # stance 1.0: every foot in contact at every knot, no swing
        assert np.all(cnt == 1) and not np.any(reference[f"{name}/prep/swing_mask"])
    if name == "jump":  # every foot in phase: knots with all feet in flight
        assert np.any(cnt.sum(-1) == 0) and np.all((cnt.sum(-1) == 0) | (cnt.sum(-1) == 4))


@pytest.mark.parametrize("name", NAMES)
def test_prep_values_matches_jax(models, reference, name):
    """K3's plain prologue on the compact inputs: in float32 against the JAX
    package's ``prep_values`` (eager on its (.., T) layout; an f32 function,
    its constants are f32) under the gates of tests/test_fused_prep.py:95-116
    (cnt and swing exact, dt 1e-6, r 1e-5, W and WF rtol 1e-6, qlin rtol 2e-5
    atol 1e-4, qF rtol 1e-5 atol 1e-4, lb/ub rtol 1e-6 atol 1e-5, X0 1e-5); in
    float64 against the port's ``_prepare_problem`` (held to the JAX
    package's above) within 1e-12."""
    jspec, tspec = specs(models, name)
    pc = TKD.make_prep_consts(tspec)
    jpc = cuda_fused.PrepConsts(**dataclasses.asdict(JKD.make_prep_consts(jspec)))
    np.testing.assert_allclose(pc.as_array(), jpc.as_array(), rtol=1e-12, atol=0)
    m, H, ne = float(tspec.model.total_mass), tspec.horizon, tspec.n_eff
    ci = REF.compact_inputs(name)
    for f in REF.COMPACT:
        np.testing.assert_array_equal(ci[f], reference[f"{name}/compact/{f}"], err_msg=f)
    ins = [torch.as_tensor(ci[f]) for f in REF.COMPACT]
    got = dict(zip(REF.PREP_VALUES, (a.numpy() for a in cuda_fused.prep_values(
        *ins, pc=pc, m=m, H=H, ne=ne))))
    ref = {f: reference[f"{name}/prep_values/{f}"] for f in REF.PREP_VALUES}
    np.testing.assert_array_equal(got["cnt"], ref["cnt"])
    np.testing.assert_allclose(got["r"], ref["r"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["dt"], ref["dt"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["swing"], ref["swing"])
    np.testing.assert_allclose(got["W"], ref["W"], rtol=1e-6)
    np.testing.assert_allclose(got["qlin"], ref["qlin"], rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got["WF"], ref["WF"], rtol=1e-6)
    np.testing.assert_allclose(got["qF"], ref["qF"], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["lb"], ref["lb"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got["ub"], ref["ub"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got["X0"], ref["X0"], atol=1e-5, rtol=0)
    assert np.all(got["F0"] == 0.0) and np.all(ref["F0"] == 0.0)

    st = [torch.as_tensor(a, dtype=F64) for a in REF.prep_inputs(name)]
    _, t, vdw, x_init, ee, hip, amom = TKD._compact_inputs(tspec, *st)
    got = cuda_fused.prep_values(t, vdw, st[4], x_init, ee, hip, amom, pc=pc, m=m, H=H, ne=ne)
    pr = TKD._prepare_problem(tspec, *st)
    pairs = {"cnt": pr["plan"].cnt, "r": pr["plan"].r, "dt": pr["plan"].dt,
             "swing": pr["swing_mask"], "W": pr["W"], "qlin": -2.0 * pr["W"] * pr["X_ref"],
             "WF": pr["W_F"], "lb": pr["x_bounds"][0], "ub": pr["x_bounds"][1], "X0": pr["X_wm"],
             "F0": pr["F_wm"]}
    for key, a in zip(REF.PREP_VALUES, got):
        if key not in pairs:
            continue
        b = pairs[key].to(F64)
        assert a.shape == b.shape, key
        fin = torch.isfinite(b)  # the prologue's box holds a large sentinel where unbounded
        assert torch.all(a[~fin].abs() > 1e30), key
        torch.testing.assert_close(a.to(F64)[fin], b[fin], atol=1e-12, rtol=0, msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_plain_path_matches_jax(models, reference, name):
    _, tspec = specs(models, name)
    g = GAITS[name]
    st = [torch.as_tensor(a, dtype=F64) for a in REF.inputs(name)]
    plan = TKD.solve_mpc_batch(
        tspec, *st, admm_cfg=BiconvexConfig(rho=g.rho, x_solver="thomas", fista_max_iters=30),
        admm_backend="torch", ik_backend="torch")
    got = convert.plan_to_numpy(plan)
    # jump from a mid-trot draw (problem 1: seven knots of flight from the
    # window's start) diverges in the JAX package's ADMM (violation 1.2e7 at
    # the iteration cap): the port's must diverge alike; rounding grows
    # without bound there, so the plans of such problems are not compared
    diverged = reference[f"{name}/dyn_violation"] > 1e3
    assert list(np.nonzero(diverged)[0]) == ([1] if name == "jump" else [])
    assert np.all(got["dyn_violation"][diverged] > 1e3)
    live = ~diverged
    for field in TKD.MpcPlan._fields:
        ref = reference[f"{name}/{field}"]
        assert got[field].shape == ref.shape, field
        if field == "admm_iters":
            np.testing.assert_array_equal(got[field], ref, err_msg=field)
        else:
            np.testing.assert_allclose(got[field][live], ref[live], atol=1e-6, rtol=0,
                                       err_msg=field)
    assert np.all(np.isfinite(got["xs_int"]))
    assert got["dyn_violation"][0] < VIOLATION_BOUND.get(name, 1e-3)
    if name in ("walk", "bound_turn", "air_bound"):  # the JAX tests' height band
        np.testing.assert_array_less(np.abs(got["X_opt"][0, :, 2] - g.nom_ht), 0.08)


@pytest.mark.slow
def test_fixture_is_the_jax_solve():
    """The committed reference is what the JAX package computes today
    (several minutes: one compile of the JAX solve per gait)."""
    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)
