"""Uneven ground and touchdown noise in the port (``sim/physics.py``
``Terrain``/``random_terrain``/``step(terrain=)``, ``mpc/gait.py``
``create_cnt_plan(noise_xy=, terrain=, terrain_offset=)``,
``mpc/kino_dyn.py`` ``_prepare_problem``/``solve_mpc_batch(noise_xy=,
terrain=)``, ``sim/rollout.py`` ``rollout_mpc(terrain=)``/``rollout_policy(
terrain=)``) against the JAX package's, on the same seeded numpy inputs.

* ``height_at`` on random numpy grids, inside and beyond their edges
  (clamped), against the JAX ``Terrain.height_at`` in float64 (1e-12);
  ``random_terrain``'s recipe (a blurred normal draw of the generator).
* The contact plan with touchdown noise, a heightfield and a plan-origin
  offset, and the whole problem assembly on uneven ground, against the
  eager JAX functions in float64 at clocks off the knot-rounding fault of
  ROADMAP "Faults found" (1e-12, flags exact).
* tests/test_terrain.py's cases on the port: a zero heightfield is the flat
  plan exactly, a plateau lifts every re-planned touchdown, a slope's
  touchdowns follow the local height, the offset maps the plan frame to the
  world, and a full solve on a plateau rides nom_ht above it.
* One ``physics.step`` on a 10% slope, two windows of the ``trot_sim`` loop
  on it (``rollout_mpc``, plain backends, (X, F, P) carried) and 100 steps
  of a policy on it (``rollout_policy``), against the JAX package's
  (tests/torch_terrain_reference.py, the fixture
  tests/fixtures/torch_terrain.npz): states 1e-12 for the step, every
  record within atol 1e-9 for the loops, flags and failure steps equal.
* A zero heightfield gives the flat loop bit for bit; the fused path (K3,
  which plans flat ground without noise) refuses terrain and noise.
* The float32-against-float64 spread of two windows on the slope, which
  ``chip_smoke.py`` phase 13b's gate (phase 7a's tolerances) is built on:
  the gate holds at least 3x the spread.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_learning_reference as POLICY_REF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
import torch_rollout_reference as ROLLOUT_REF
import torch_terrain_reference as REF
from bunmpc_tpu.kin import algorithms as JK
from bunmpc_tpu.mpc import gait as JG
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot as jtrot
from bunmpc_tpu.robots.solo12 import Solo12Config as JC
from bunmpc_tpu.sim import physics as JP
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.kin import algorithms as TK
from bunmpc_tpu_torch.mpc import gait as TG
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot, trot_sim
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.sim import physics
from bunmpc_tpu_torch.sim import rollout as TR
from bunmpc_tpu_torch.solvers import biconvex, ddp

F64 = torch.float64
EFF = tuple(TC.eff_names)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def both(heights, origin, cell):
    """The same heightfield as the port's and the JAX package's Terrain."""
    return (physics.Terrain(heights=t64(heights), origin=origin, cell=cell),
            JP.Terrain(heights=jnp.asarray(heights), origin=origin, cell=cell))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_height_at_matches_jax(seed):
    """Random grids (non-square, random origin and cell) sampled at points
    inside, on the cell corners and beyond every edge."""
    rng = np.random.default_rng(seed)
    n, m = rng.integers(3, 12, size=2)
    origin, cell = tuple(rng.uniform(-1.0, 1.0, size=2)), float(rng.uniform(0.05, 0.3))
    t, j = both(rng.normal(size=(n, m)) * 0.05, origin, cell)
    lo, hi = np.array(origin), np.array(origin) + cell * np.array([n - 1, m - 1])
    xy = np.concatenate([
        rng.uniform(lo, hi, size=(50, 2)),
        lo + cell * rng.integers(0, [n, m], size=(10, 2)),  # on grid points
        rng.uniform(lo - 1.0, hi + 1.0, size=(50, 2)),  # beyond the edges: clamped
    ]).reshape(11, 10, 2)
    got = t.height_at(t64(xy))
    assert got.shape == (11, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(j.height_at(jnp.asarray(xy))),
                               atol=1e-12, rtol=0)


def test_random_terrain_recipe():
    """``random_terrain``: amplitude times the generator's normal draw on a
    (2 extent / cell)^2 grid, box-blurred ``smooth`` times (the JAX
    package's recipe; its draws come from a key), centred on the origin."""
    g = torch.Generator().manual_seed(5)
    ter = physics.random_terrain(g, extent=1.0, cell=0.1, amplitude=0.02, smooth=3,
                                 dtype=F64)
    h = 0.02 * torch.randn((20, 20), generator=torch.Generator().manual_seed(5),
                           dtype=F64).numpy()
    for _ in range(3):
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0) + np.roll(h, 1, 1)
             + np.roll(h, -1, 1)) / 5.0
    np.testing.assert_allclose(ter.heights.numpy(), h, atol=1e-15, rtol=0)
    assert ter.origin == (-1.0, -1.0) and ter.cell == 0.1
    d = workload.terrain_draw(0, device="cpu")
    assert d.heights.shape == (160, 160) and d.heights.dtype == torch.float32
    assert 0.0 < float(d.heights.abs().max()) < 0.05


@pytest.fixture(scope="module")
def spec():
    return KD.make_cyclic_spec(TC.load_model(), trot, TC.q0(), device="cpu")


@pytest.fixture(scope="module")
def jspec():
    return JKD.make_cyclic_spec(JC.load_model(), jtrot, JC.q0())


def plan_inputs(n=4, seed=3):
    """Trot draws whose clocks sit off the knots (the jitted and eager
    first-knot dt agree there), xy spread over the ground."""
    q, v, t, v_des, w_des = workload.trot_states(n, seed)
    q[:, 0:2] = np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 2))
    t = np.round(t, 2) + 0.013
    assert np.all(np.round(np.mod(t, 0.05), 2) < 0.05)
    return q, v, t, v_des, w_des


def noise_draw(n, H, seed=4):
    return np.random.default_rng(seed).normal(size=(n, H, 4, 2)) * 0.05


@pytest.mark.parametrize("case", ["noise", "terrain", "terrain_offset", "all"])
def test_create_cnt_plan_matches_jax(spec, jspec, case):
    q, v, t, v_des, w_des = plan_inputs()
    rng = np.random.default_rng(6)
    tter, jter = both(rng.normal(size=(40, 40)) * 0.03, (-2.0, -2.0), 0.1)
    noise = noise_draw(4, spec.horizon) if case in ("noise", "all") else None
    off = q[:, 0:2] if case in ("terrain_offset", "all") else None
    with_ter = case != "noise"
    jm, tm = JC.load_model(), TC.load_model()
    q0 = q.copy()
    q0[:, 0:2] = 0.0
    com = np.asarray(JK.com(jm, q0))
    ee = np.asarray(JK.frame_positions(jm, q0, EFF))
    jplan, jmask = JG.create_cnt_plan(
        jspec.gait, jspec.planner, jspec.horizon, jnp.asarray(q0), jnp.asarray(t),
        jnp.asarray(v_des), jnp.asarray(w_des), jnp.asarray(com), jnp.asarray(ee),
        noise_xy=None if noise is None else jnp.asarray(noise),
        terrain=jter if with_ter else None,
        terrain_offset=None if off is None else jnp.asarray(off))
    tplan, tmask = TG.create_cnt_plan(
        spec.gait, spec.planner, spec.horizon, t64(q0), t64(t), t64(v_des), t64(w_des),
        TK.com(tm, t64(q0)), TK.frame_positions(tm, t64(q0), EFF),
        noise_xy=None if noise is None else t64(noise), terrain=tter if with_ter else None,
        terrain_offset=None if off is None else t64(off))
    np.testing.assert_array_equal(tplan.cnt.numpy(), np.asarray(jplan.cnt))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tplan.r.numpy(), np.asarray(jplan.r), atol=1e-12, rtol=0)
    np.testing.assert_allclose(tplan.dt.numpy(), np.asarray(jplan.dt), atol=1e-12, rtol=0)
    if with_ter:  # the re-planned touchdowns left the flat ground
        assert np.abs(tplan.r.numpy()[:, 12:, :, 2] - spec.planner.foot_size).max() > 1e-3


def test_prepare_problem_on_terrain_matches_jax(spec, jspec):
    """The whole assembly with noise and a heightfield: the plan, the
    nominal and terminal CoM heights over the local ground, the box."""
    import jax

    q, v, t, v_des, w_des = plan_inputs()
    tter, jter = both(np.random.default_rng(8).normal(size=(40, 40)) * 0.03, (-2.0, -2.0), 0.1)
    noise = noise_draw(4, spec.horizon)
    jp = jax.vmap(lambda q, v, t, vd, wd, nz: JKD._prepare_problem(
        jspec, q, v, t, vd, wd, noise_xy=nz, terrain=jter))(
        *[jnp.asarray(a) for a in (q, v, t, v_des, w_des, noise)])
    tp = KD._prepare_problem(spec, *[t64(a) for a in (q, v, t, v_des, w_des)],
                             noise_xy=t64(noise), terrain=tter)
    np.testing.assert_array_equal(tp["plan"].cnt.numpy(), np.asarray(jp["plan"].cnt))
    for f, a, b in (("r", tp["plan"].r, jp["plan"].r), ("X_ref", tp["X_ref"], jp["X_ref"]),
                    ("lb", tp["x_bounds"][0], jp["x_bounds"][0]),
                    ("ub", tp["x_bounds"][1], jp["x_bounds"][1]), ("W", tp["W"], jp["W"]),
                    ("X_wm", tp["X_wm"], jp["X_wm"])):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], atol=1e-12, rtol=0, err_msg=f)
    z = tp["X_ref"][:, :, 2].numpy()
    assert np.abs(z - trot.nom_ht).max() > 1e-3  # the ground moved the nominal height


# ---- tests/test_terrain.py's cases on the port ----


def _flat(h0, extent=4.0, cell=0.5):
    n = int(2 * extent / cell)
    return physics.Terrain(heights=torch.full((n, n), h0, dtype=F64), origin=(-extent, -extent),
                           cell=cell)


def _slope(grade, extent=4.0, cell=0.1):
    return workload.slope_terrain(grade, extent, cell, device="cpu", dtype=F64)


def _plan(spec, terrain=None, terrain_offset=None, t=0.12, vx=0.3):
    model = spec.model
    q = t64(TC.q0())[None]
    return TG.create_cnt_plan(
        spec.gait, spec.planner, spec.horizon, q, t64([t]), t64([[vx, 0.0, 0.0]]), t64([0.0]),
        TK.com(model, q), TK.frame_positions(model, q, spec.eff_frames), terrain=terrain,
        terrain_offset=terrain_offset)


_SETTLED = 12  # every foot has re-touched after one trot period


def test_flat_terrain_matches_no_terrain(spec):
    plan0, mask0 = _plan(spec)
    plan1, mask1 = _plan(spec, terrain=_flat(0.0))
    assert torch.equal(plan1.r, plan0.r) and torch.equal(mask1, mask0)


def test_constant_height_offsets_touchdowns(spec):
    plan, _ = _plan(spec, terrain=_flat(0.10))
    np.testing.assert_allclose(plan.r[0, _SETTLED:, :, 2].numpy(),
                               0.10 + spec.planner.foot_size, atol=1e-6)


def test_slope_touchdown_follows_local_height(spec):
    plan, _ = _plan(spec, terrain=_slope(0.1))
    r = plan.r[0].numpy()
    np.testing.assert_allclose(r[_SETTLED:, :, 2], 0.1 * r[_SETTLED:, :, 0]
                               + spec.planner.foot_size, atol=1e-3)


def test_terrain_offset_maps_plan_frame_to_world(spec):
    plan, _ = _plan(spec, terrain=_slope(0.1), terrain_offset=t64([[1.0, 0.0]]))
    r = plan.r[0].numpy()
    np.testing.assert_allclose(r[_SETTLED:, :, 2], 0.1 * (r[_SETTLED:, :, 0] + 1.0)
                               + spec.planner.foot_size, atol=1e-3)


def test_solve_mpc_on_plateau(spec):
    """A full plain solve on a plateau: the terminal CoM rides nom_ht above
    it (tests/test_terrain.py:104-122)."""
    h0 = 0.08
    q = TC.q0()
    q[2] += h0
    plan = KD.solve_mpc_batch(spec, t64(q[None]), torch.zeros(1, 18, dtype=F64),
                              t64([0.0]), t64([[0.2, 0.0, 0.0]]), t64([0.0]), terrain=_flat(h0),
                              admm_backend="torch", ik_backend="torch")
    assert float(plan.dyn_violation[0]) < 1e-2
    assert abs(float(plan.X_opt[0, -1, 2]) - (trot.nom_ht + h0)) < 0.03
    assert bool(torch.isfinite(plan.xs_int).all())


def test_fused_path_refuses_terrain_and_noise(spec):
    st = [t64(a) for a in plan_inputs(2)]
    for kw in (dict(terrain=_flat(0.0)), dict(noise_xy=noise_draw(2, spec.horizon))):
        with pytest.raises(ValueError, match="fuse_prep=False"):
            KD.solve_mpc_batch(spec, *st, fuse_prep=True, **kw)


# ---- the physics and the loops on a 10% slope, against the fixture ----


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


def slope_of(ref):
    return physics.Terrain(heights=t64(ref["heights"]), origin=(-REF.EXTENT, -REF.EXTENT),
                           cell=REF.CELL)


def test_fixture_slope_is_the_workload_slope(reference):
    ter = workload.slope_terrain(REF.GRADE, REF.EXTENT, REF.CELL, device="cpu", dtype=F64)
    np.testing.assert_allclose(ter.heights.numpy(), reference["heights"], atol=1e-15, rtol=0)


def test_physics_step_on_slope_matches_jax(reference):
    ref = reference
    new, info = physics.step(TC.load_model(), EFF, workload.closed_loop_sim_params(),
                             physics.SimState(t64(ref["step/q"]), t64(ref["step/v"])),
                             t64(ref["step/tau"]), terrain=slope_of(ref))
    np.testing.assert_array_equal(info.in_contact.numpy(), ref["step/in_contact"])
    assert ref["step/in_contact"].any() and not ref["step/in_contact"].all()
    np.testing.assert_allclose(new.q.numpy(), ref["step/q_next"], atol=1e-12, rtol=0)
    np.testing.assert_allclose(new.v.numpy(), ref["step/v_next"], atol=1e-10, rtol=0)
    np.testing.assert_allclose(info.forces.numpy(), ref["step/forces"], atol=1e-9, rtol=0)


@pytest.fixture(scope="module")
def loop_spec():
    return KD.make_cyclic_spec(TC.load_model(), trot_sim, TC.q0(), device="cpu")


def loop_inputs(ref, B=REF.B):
    start = np.load(ROLLOUT_REF.FIXTURE)
    state0 = physics.SimState(q=t64(start["q0"]).expand(B, -1).contiguous(),
                              v=t64(start["v0"]).expand(B, -1).contiguous())
    cfg = TR.RolloutConfig(episode_length=REF.T, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    return state0, cfg, t64(start["v_des"][:B]), t64(start["w_des"][:B])


def assert_records_match(res, ref, prefix):
    got = {f: getattr(res, f).numpy() for f in REF.FIELDS}
    got["final_q"], got["final_v"] = res.final_state.q.numpy(), res.final_state.v.numpy()
    for f, a in got.items():
        r = ref[f"{prefix}/{f}"]
        assert a.shape == r.shape, f
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, r, err_msg=f)
        else:
            np.testing.assert_allclose(a, r, atol=1e-9, rtol=0, err_msg=f)


def test_rollout_mpc_on_slope_matches_jax(loop_spec, reference):
    state0, cfg, v_des, w_des = loop_inputs(reference)
    res = TR.rollout_mpc(
        loop_spec, workload.closed_loop_sim_params(), cfg, state0, v_des, w_des,
        terrain=slope_of(reference),
        admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60),
        ddp_cfg=ddp.DdpConfig(n_iters=4), admm_backend="torch", ik_backend="torch")
    assert_records_match(res, reference, "mpc")


def test_rollout_policy_on_slope_matches_jax(loop_spec, reference):
    pol = np.load(POLICY_REF.FIXTURE)
    bundle = convert.policy_bundle_from_flax(
        POLICY_REF.unflat_params(pol, "vc/params"), pol["state_mean"], pol["state_std"],
        pol["vc/goal_mean"], pol["vc/goal_std"])
    state0, cfg, v_des, w_des = loop_inputs(reference)
    res = TR.rollout_policy(loop_spec, workload.closed_loop_sim_params(), cfg, state0, v_des,
                            w_des, bundle, terrain=slope_of(reference))
    assert_records_match(res, reference, "policy")


def test_zero_heights_give_the_flat_loop_bit_for_bit(loop_spec):
    """Two windows of the plain loop at B=2 in float32 from the settled start
    of tests/fixtures/torch_rollout_solo12_trot_sim.npz on a zero
    heightfield equal the loop without terrain in every record."""
    start = np.load(ROLLOUT_REF.FIXTURE)
    st = physics.SimState(*(torch.as_tensor(start[k], dtype=torch.float32).expand(2, -1)
                            .contiguous() for k in ("q0", "v0")))
    v_np, w_np = workload.command_draw(2)
    cfg = TR.RolloutConfig(episode_length=100, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    zero = physics.Terrain(heights=torch.zeros(20, 20), origin=(-1.0, -1.0), cell=0.1)
    out = [TR.rollout_mpc(loop_spec, workload.closed_loop_sim_params(), cfg, st,
                          torch.as_tensor(v_np, dtype=torch.float32),
                          torch.as_tensor(w_np, dtype=torch.float32), terrain=ter,
                          admm_backend="torch", ik_backend="torch") for ter in (None, zero)]
    for f in REF.FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f


def test_slope_f32_spread_is_inside_the_card_gate(loop_spec):
    """Two windows of the plain loop on the 10% slope from the settled start
    (the JAX package's 500 ms settle, tests/fixtures/
    torch_rollout_solo12_trot_sim.npz) with the reference-envelope
    commands, float32 against float64 on 8 episodes: chip_smoke.py phase 13b
    holds the card's end q and v against the plain path in float64 within
    phase 7a's TWO_WINDOW_Q_TOL and TWO_WINDOW_V_TOL, which must be at least
    3x this spread."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    n = 8
    start = np.load(ROLLOUT_REF.FIXTURE)
    st = physics.SimState(t64(start["q0"])[None], t64(start["v0"])[None])
    v_des, w_des = workload.command_draw(n)
    cfg = TR.RolloutConfig(episode_length=100, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    out = {}
    for dt in (torch.float32, F64):
        s = physics.SimState(st.q.to(dt).expand(n, -1).contiguous(),
                             st.v.to(dt).expand(n, -1).contiguous())
        out[dt] = TR.rollout_mpc(
            loop_spec, workload.closed_loop_sim_params(), cfg, s,
            torch.as_tensor(v_des, dtype=dt), torch.as_tensor(w_des, dtype=dt),
            terrain=workload.slope_terrain(0.1, device="cpu", dtype=dt), admm_backend="torch",
            ik_backend="torch")
    a, b = out[torch.float32].final_state, out[F64].final_state
    dq = float((a.q.double() - b.q).abs().max())
    dv = float((a.v.double() - b.v).abs().max())
    print(f"two-window slope f32 vs f64 spread: q {dq:.3e}, v {dv:.3e}; card gates "
          f"q {chip_smoke.TWO_WINDOW_Q_TOL:.1e}, v {chip_smoke.TWO_WINDOW_V_TOL:.1e}")
    assert not out[F64].failed.any()
    assert 0.0 < dq and 3.0 * dq <= chip_smoke.TWO_WINDOW_Q_TOL
    assert 0.0 < dv and 3.0 * dv <= chip_smoke.TWO_WINDOW_V_TOL


@pytest.mark.slow
def test_fixture_is_the_jax_terrain_rollout():
    """The committed reference is what the JAX package computes today
    (minutes: tracing the JAX loop)."""
    import jax

    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)
