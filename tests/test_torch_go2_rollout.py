"""The closed loop's per-episode options in the port (``sim/rollout.py``,
``sim/physics.py``, ``sim/controllers.py``) against the JAX package's, on the
Go2 and on the same seeded numpy inputs.

* ``leg_joint_mask``, ``swing_blend_scale`` and ``_measure`` (sensor bias,
  the quaternion renormalised) against the JAX functions under ``vmap``, in
  float64 within 1e-12.
* One physics step with per-episode contact, joint damping and torque
  limits, the ID controller with per-episode gains with ``f_scale``, and
  five steps of the per-episode PD settle, against the JAX functions under
  ``vmap`` in float64 (1e-12; the settle chatters, ~7.5x a step, so 1e-10
  over five steps, as tests/test_torch_sim.py holds it).
* Two windows (100 steps) of the Go2 ``trot_sim`` loop at B=3 on the plain
  backends in float64 with per-episode gains, contact, ``swing_blend``,
  ``force_gate``, sensor biases and commands, with the "vdes" default (no
  carry) and with (X, F, P) carried, and 50 steps of a policy rollout with
  the same biases, against the JAX package's ``vmap(rollout_mpc)`` and
  ``vmap(rollout_policy)`` (tests/torch_go2_rollout_reference.py, the fixture
  tests/fixtures/torch_rollout_go2_trot_sim.npz): every record within atol
  1e-9, flags and failure steps equal. The ``slow`` test regenerates the
  fixture.
* The float32-against-float64 spread of one window of the plain path in
  phase 11b's configuration, which ``chip_smoke.py``'s 11b gate is built
  on: the gate holds at least 3x the spread.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_go2_rollout_reference as REF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.robots.go2 import Go2Config as JC
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu.sim import controllers as JCtl
from bunmpc_tpu.sim import physics as JP
from bunmpc_tpu.sim import rollout as JR
from bunmpc_tpu_torch import workload
from bunmpc_tpu_torch.mpc.motions.go2_cyclic import trot_sim
from bunmpc_tpu_torch.robots.go2 import Go2Config as TC
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TSolo
from bunmpc_tpu_torch.sim import controllers, physics
from bunmpc_tpu_torch.sim import rollout as TR
from bunmpc_tpu_torch.solvers import biconvex, ddp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (phase 11b's gates)

F64 = torch.float64
EFF = tuple(TC.eff_names)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


@pytest.mark.parametrize("robot", ["go2", "solo12"])
def test_leg_joint_mask_matches_jax(robot):
    tc, jc = (TC, JC) if robot == "go2" else (TSolo, JSolo)
    got = TR.leg_joint_mask(tc.load_model(), tuple(tc.eff_names))
    ref = JR.leg_joint_mask(jc.load_model(), tuple(jc.eff_names))
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (4, 12) and np.all(got.sum(0) == 1) and np.all(got.sum(1) == 3)


def test_swing_blend_scale_matches_jax():
    rng = np.random.default_rng(0)
    B = 16
    mask = JR.leg_joint_mask(JC.load_model(), EFF)
    planned = (rng.random((B, 4)) > 0.5).astype(np.float64)
    meas = rng.random((B, 4)) > 0.5
    sb = rng.uniform(0.0, 1.0, B)
    ref = jax.vmap(lambda p, c, s: JR.swing_blend_scale(jnp.asarray(mask, jnp.float64), p, c,
                                                        s))(planned, meas, sb)
    got = TR.swing_blend_scale(t64(mask), t64(planned), torch.as_tensor(meas), t64(sb)[:, None])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    one = TR.swing_blend_scale(t64(mask), t64(planned), torch.as_tensor(meas), 0.5)
    ref1 = jax.vmap(lambda p, c: JR.swing_blend_scale(jnp.asarray(mask, jnp.float64), p, c,
                                                      0.5))(planned, meas)
    np.testing.assert_allclose(one.numpy(), np.asarray(ref1), atol=1e-12, rtol=0)
    assert np.any(one.numpy() == 0.5) and np.any(one.numpy() == 1.0)


def test_measure_matches_jax():
    rng = np.random.default_rng(1)
    B = 5
    q = np.tile(JC.q0(), (B, 1)) + rng.normal(size=(B, 19)) * 0.05
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    v = rng.normal(size=(B, 18))
    qn, vn = rng.normal(size=(B, 19)) * 0.02, rng.normal(size=(B, 18)) * 0.05
    for kq, kv in ((qn, vn), (qn, None), (None, vn), (None, None)):
        ref = jax.vmap(lambda a, b, c, d: JR._measure(a, b, c, d),
                       in_axes=(0, 0, None if kq is None else 0, None if kv is None else 0))(
            q, v, kq, kv)
        got = TR._measure(t64(q), t64(v), None if kq is None else t64(kq),
                          None if kv is None else t64(kv))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-12, rtol=0)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-12, rtol=0)
    assert abs(float(torch.linalg.norm(got[0][:, 3:7], dim=-1).max()) - 1.0) < 1e-12


def per_episode_params(o):
    """The fixture rows' simulators, as the port and the JAX package take them."""
    B = len(o["kn"])

    def full(x):
        return np.full(B, x)

    cols = dict(foot_radius=full(TC.foot_size), kn=o["kn"], dn=o["dn"], kt=o["kt"], mu=full(1.0))
    tsp = physics.SimParams(contact=physics.ContactParams(**{k: t64(v) for k, v in cols.items()}),
                            joint_damping=t64(full(0.02)), torque_limit=t64(full(23.7)))
    jsp = JP.SimParams(contact=JP.ContactParams(**{k: jnp.asarray(v) for k, v in cols.items()}),
                       joint_damping=jnp.asarray(full(0.02)), torque_limit=jnp.asarray(full(23.7)))
    return tsp, jsp


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


def test_physics_controller_and_settle_per_episode_match_jax(reference):
    """One physics step, the ID controller and five settle steps with
    per-episode parameters, on the fixture's settled starts and rows."""
    o = {k: reference[k] for k in ("kp", "kd", "kn", "dn", "kt")}
    tsp, jsp = per_episode_params(o)
    model, jm = TC.load_model(), JC.load_model()
    q, v = reference["q0"], reference["v0"]
    rng = np.random.default_rng(2)
    tau = rng.normal(size=(REF.B, 12)) * 30.0  # past the 23.7 N m limit on some joints
    ref = jax.vmap(lambda p, a, b, c: JP.step(jm, EFF, p, JP.SimState(a, b), c))(jsp, q, v, tau)
    got = physics.step(model, EFF, tsp, physics.SimState(t64(q), t64(v)), t64(tau))
    for a, b in ((got[0].q, ref[0].q), (got[0].v, ref[0].v), (got[1].forces, ref[1].forces)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(got[1].in_contact.numpy(), np.asarray(ref[1].in_contact))
    assert np.asarray(ref[1].in_contact).any()

    q_des = q + rng.normal(size=q.shape) * 0.02
    v_des, a_des = rng.normal(size=v.shape) * 0.1, rng.normal(size=v.shape)
    f_ff = rng.normal(size=(REF.B, 12)) * 20.0
    f_scale = rng.uniform(0, 1, size=(REF.B, 4))
    jg = JCtl.IdControllerGains(kp=jnp.asarray(o["kp"]), kd=jnp.asarray(o["kd"]))
    ref = jax.vmap(lambda g, *a: JCtl.id_joint_torques(jm, EFF, g, *a))(
        jg, q, v, q_des, v_des, a_des, f_ff, f_scale)
    got = controllers.id_joint_torques(
        model, EFF, controllers.IdControllerGains(kp=t64(o["kp"]), kd=t64(o["kd"])), t64(q),
        t64(v), t64(q_des), t64(v_des), t64(a_des), t64(f_ff), f_scale=t64(f_scale))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10, rtol=0)

    s0 = JP.SimState(jnp.asarray(JC.q0()), jnp.zeros(18))
    ref = jax.vmap(lambda p, kp, kd: JR.settle_state(jm, EFF, p, s0, kp, kd, ms=5))(
        jsp, jnp.asarray(o["kp"]), jnp.asarray(o["kd"]))
    got = TR.settle_state(model, EFF, tsp, physics.SimState(t64(np.tile(TC.q0(), (REF.B, 1))),
                                                            torch.zeros(REF.B, 18, dtype=F64)),
                          t64(o["kp"]), t64(o["kd"]), ms=5)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref.q), atol=1e-10, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref.v), atol=1e-10, rtol=0)


def test_scalar_parameters_equal_uniform_tensors():
    """A (B,) tensor of one value per field steps exactly as the float does
    (the per-episode path changes nothing for the existing calls)."""
    model = TC.load_model()
    rng = np.random.default_rng(3)
    B = 4
    q = t64(np.tile(TC.q0(), (B, 1)))
    q[:, 2] = 0.27
    v, tau = t64(rng.normal(size=(B, 18)) * 0.3), t64(rng.normal(size=(B, 12)) * 10)
    sp = workload.go2_sim_params()
    full = physics.SimParams(
        contact=physics.ContactParams(**{f: torch.full((B,), float(getattr(sp.contact, f)),
                                                       dtype=F64)
                                         for f in ("foot_radius", "kn", "dn", "mu", "kt")}),
        joint_damping=torch.full((B,), sp.joint_damping, dtype=F64),
        torque_limit=torch.full((B,), sp.torque_limit, dtype=F64))
    a = physics.step(model, EFF, sp, physics.SimState(q, v), tau)
    b = physics.step(model, EFF, full, physics.SimState(q, v), tau)
    assert torch.equal(a[0].q, b[0].q) and torch.equal(a[0].v, b[0].v)
    assert torch.equal(a[1].forces, b[1].forces)


def fixture_inputs(reference, dtype=F64, rows=None):
    o = {k: reference[k] for k in ("kp", "kd", "kn", "dn", "kt", "swing_blend", "force_gate",
                                   "v_des", "w_des", "q_noise", "v_noise", "q0", "v0")}
    if rows is not None:
        o = {k: v[rows] for k, v in o.items()}
    tsp, _ = per_episode_params(o)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    tsp = physics.SimParams(contact=physics.ContactParams(
        **{f: t(getattr(tsp.contact, f)) for f in ("foot_radius", "kn", "dn", "mu", "kt")}),
        joint_damping=t(tsp.joint_damping), torque_limit=t(tsp.torque_limit))
    return dict(sim_params=tsp, state0=physics.SimState(t(o["q0"]), t(o["v0"])),
                v_des=t(o["v_des"]), w_des=t(o["w_des"]),
                gains=controllers.IdControllerGains(kp=t(o["kp"]), kd=t(o["kd"])),
                swing_blend=t(o["swing_blend"]), force_gate=t(o["force_gate"]),
                q_noise=t(o["q_noise"]), v_noise=t(o["v_noise"]))


def assert_records(res, ref, variant):
    got = {f: getattr(res, f).numpy() for f in REF.FIELDS}
    got["final_q"], got["final_v"] = res.final_state.q.numpy(), res.final_state.v.numpy()
    assert not got["failed"].any()
    for f, a in got.items():
        r = ref[f"{variant}/{f}"]
        assert a.shape == r.shape, f
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, r, err_msg=f)
        else:
            np.testing.assert_allclose(a, r, atol=1e-9, rtol=0, err_msg=f)


@pytest.fixture(scope="module")
def spec():
    return workload.go2_spec("trot_sim", device="cpu")


@pytest.mark.parametrize("variant", list(REF.VARIANTS))
def test_go2_loop_matches_jax_rollout(spec, reference, variant):
    kw = fixture_inputs(reference)
    cfg = TR.RolloutConfig(episode_length=REF.T, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    sp, state0 = kw.pop("sim_params"), kw.pop("state0")
    v_des, w_des = kw.pop("v_des"), kw.pop("w_des")
    res = TR.rollout_mpc(
        spec, sp, cfg, state0, v_des, w_des,
        admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60),
        ddp_cfg=ddp.DdpConfig(n_iters=4), warm_start_carry=REF.VARIANTS[variant],
        admm_backend="torch", ik_backend="torch", **kw)
    assert_records(res, reference, variant)
    # the options bite: force_gate 0 and swing_blend 0.2 rows differ from the gate's 1 and 0.5
    assert set(reference["force_gate"]) == {0.0, 1.0} and 0.2 in set(reference["swing_blend"])


def test_policy_rollout_with_sensor_bias_matches_jax(spec, reference):
    kw = fixture_inputs(reference)
    wf, wg = (t64(w) for w in REF.policy_weights())
    q0j = t64(TC.q0()[7:])
    cfg = TR.RolloutConfig(episode_length=REF.POLICY_T, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    res = TR.rollout_policy(
        spec, kw["sim_params"], cfg, kw["state0"], kw["v_des"], kw["w_des"],
        lambda feat, goal: REF.policy_action(torch, feat, goal, wf, wg, q0j),
        q_noise=kw["q_noise"], v_noise=kw["v_noise"])
    assert_records(res, reference, "policy")


@pytest.mark.slow
def test_fixture_is_the_jax_go2_rollout():
    """The committed reference is what the JAX package computes today
    (~10 min: the JAX rollouts' traces and compiles)."""
    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)


def test_go2_window_f32_spread_is_inside_the_card_gate(spec):
    """One window (50 steps) of the plain path in phase 11b's configuration
    (``workload.go2_window_inputs(64)``: the sweep's 40 rows as per-episode
    gains and contact, each from its own float32 settle, swing_blend 0.5,
    force_gate 1.0, sensor biases), float32 against float64 from the same
    float32 starts: chip_smoke.py holds the card's end q and v against the
    plain path in float64 within GO2_WINDOW_Q_TOL and GO2_WINDOW_V_TOL,
    which must be at least 3x this spread."""
    n = 64
    case = workload.go2_window_inputs(n)
    rows = torch.as_tensor(case["rows"])
    gains, sp, _, _ = workload.go2_sweep_options(workload.go2_sweep_grid(), device="cpu")
    start = workload.go2_settled_start(len(gains.kp), device="cpu", sim_params=sp, kp=gains.kp,
                                       kd=gains.kd)
    cfg = TR.RolloutConfig(episode_length=50, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    out = {}
    for dt in (torch.float32, F64):
        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt)[rows] if a is not None else None

        p = physics.SimParams(contact=physics.ContactParams(
            **{f: t(getattr(sp.contact, f)) for f in ("foot_radius", "kn", "dn", "mu", "kt")}),
            joint_damping=t(sp.joint_damping), torque_limit=t(sp.torque_limit))
        out[dt] = TR.rollout_mpc(
            spec, p, cfg, physics.SimState(t(start.q), t(start.v)),
            torch.as_tensor(case["v_des"], dtype=dt), torch.as_tensor(case["w_des"], dtype=dt),
            gains=controllers.IdControllerGains(kp=t(gains.kp), kd=t(gains.kd)),
            swing_blend=0.5, force_gate=1.0, q_noise=torch.as_tensor(case["q_noise"], dtype=dt),
            v_noise=torch.as_tensor(case["v_noise"], dtype=dt), admm_backend="torch",
            ik_backend="torch")
    a, b = out[torch.float32].final_state, out[F64].final_state
    dq = float((a.q.double() - b.q).abs().max())
    dv = float((a.v.double() - b.v).abs().max())
    print(f"Go2 window f32 vs f64 spread: q {dq:.3e}, v {dv:.3e}; card gates "
          f"q {chip_smoke.GO2_WINDOW_Q_TOL:.1e}, v {chip_smoke.GO2_WINDOW_V_TOL:.1e}")
    assert 0.0 < dq and 3.0 * dq <= chip_smoke.GO2_WINDOW_Q_TOL
    assert 0.0 < dv and 3.0 * dv <= chip_smoke.GO2_WINDOW_V_TOL
