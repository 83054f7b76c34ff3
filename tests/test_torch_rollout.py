"""The closed loop (``bunmpc_tpu_torch/sim/rollout.py``) against the JAX
package's ``bunmpc_tpu/sim/rollout.py`` on the same seeded numpy inputs.

* The window clock: ``kino_dyn.window_clock`` against the JAX expression
  ``round(start_time + w * plan_freq, 3)`` in float32 and float64 at every
  window of a 3000-step episode, from starts that put the ROADMAP's
  knot-aligned times (0.35, 0.398, ...) on a window: equal to numpy's
  round, within one ulp of JAX's, and the first knot never degenerates
  (the JAX package's does in float32).
* The action encodings, the state features, the vc goal and the failure
  predicate in float64 (atol 1e-12).
* Two windows (100 steps) of the loop at B=3 on the plain backends in
  float64, cold and with (X, F, P) carried, against the JAX package's
  ``vmap(rollout_mpc)`` (tests/torch_rollout_reference.py, the fixture
  tests/fixtures/torch_rollout_solo12_trot_sim.npz): every record within
  atol 1e-9, flags and failure steps equal.
* The float32-against-float64 spread of one window of the plain path, which
  ``chip_smoke.py`` phase 7a's end-of-window gate is built on: the gate
  holds at least 3x the spread.
* The carried dual on ``admm_backend="cuda"`` (K1's plain version on CPU
  tensors) against the same fixture's carried rollout.
* Terrain on a zero heightfield gives the flat loop; per-episode options
  of the wrong shape raise.
* Under ``utils.profiling.recording()`` the loop records, per window, one
  ``mpc.solve`` and then one ``rollout.substeps`` span.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
import torch_rollout_reference as REF
from bunmpc_tpu.mpc import gait as JG
from bunmpc_tpu.robots.solo12 import Solo12Config as JC
from bunmpc_tpu.sim import rollout as JR
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.mpc import gait as TG
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.sim import controllers, physics
from bunmpc_tpu_torch.sim import rollout as TR
from bunmpc_tpu_torch.solvers import biconvex, cuda_admm, ddp
from bunmpc_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (phase 7a's gates)

F64 = torch.float64
EFF = tuple(TC.eff_names)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


@pytest.fixture(scope="module")
def spec():
    return KD.make_cyclic_spec(TC.load_model(), trot_sim, TC.q0(), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("start_time", [0.0, 0.048])
def test_window_clock_against_jax(spec, dtype, start_time):
    """Every window clock of a 3000-step episode equals the reference's
    expression with numpy's round (which divides by 1000) and lies within
    one ulp of the JAX package's (``jnp.round`` is jitted, and XLA multiplies
    by the reciprocal), and the port's first knot never degenerates. The JAX
    package's own first knot does, in float32 (ROADMAP "Faults found"): at 7
    of the 60 windows from t=0 (0.25, 0.5, 1.0, ...) and at all 60 from
    t=0.048, where round(mod(t, 0.05), 2) lands one ulp below 0.05 and the
    zero test that restores the full knot misses (dt0 3.7e-9 s)."""
    like = torch.zeros((), dtype=getattr(torch, dtype))
    jdt, ndt = getattr(jnp, dtype), getattr(np, dtype)
    degenerate = []
    for w in range(60):
        got = KD.window_clock(start_time, w, 0.05, like)
        ref = np.round(ndt(start_time) + ndt(w) * ndt(0.05) * 1.0, 3)
        assert got.item() == float(ref), (w, got.item(), float(ref))
        jax_t = jnp.round(jdt(start_time) + jnp.asarray(w, jdt) * jdt(0.05) * 1.0, 3)
        assert abs(got.item() - float(jax_t)) <= float(np.spacing(ref)), (w, float(jax_t))
        dt0 = TG.first_knot_dt(spec.gait, got[None]).item()
        assert dt0 > 0.0099, (w, dt0)
        jax_dt0 = float(JG.first_knot_dt(spec.gait, jax_t[None])[0])
        if jax_dt0 < 1e-6:
            degenerate.append(w)
        else:
            assert jax_dt0 == pytest.approx(dt0, abs=1e-6)
    # 0.35 lies on a knot: the first knot keeps its full length
    assert TG.first_knot_dt(spec.gait, KD.window_clock(0.0, 7, 0.05, like)[None]).item() \
        == pytest.approx(0.05)
    expected = {("float32", 0.0): 7, ("float32", 0.048): 60}.get((dtype, start_time), 0)
    assert len(degenerate) == expected, degenerate


@pytest.mark.parametrize("action_type", ["torque", "pd_target", "structured"])
def test_action_encodings_match_jax(action_type):
    rng = np.random.default_rng(0)
    q = np.tile(JC.q0(), (4, 1)) + rng.normal(size=(4, 19)) * 0.1
    v = rng.normal(size=(4, 18))
    tau, tau_ff = rng.normal(size=(4, 12)), rng.normal(size=(4, 12))
    q_des, v_des = q + 0.01, v * 0.5
    jcfg = JR.RolloutConfig(episode_length=100, action_type=action_type, kp=12.0, kd=0.5)
    tcfg = convert.rollout_config_from(jcfg)
    ref = JR._extract_action(jcfg, tau, q, v, tau_ff=tau_ff, q_des=q_des, v_des_traj=v_des)
    got = TR._extract_action(tcfg, t64(tau), t64(q), t64(v), tau_ff=t64(tau_ff), q_des=t64(q_des),
                             v_des_traj=t64(v_des))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    action = np.asarray(ref)
    np.testing.assert_allclose(
        TR._decode_action(tcfg, t64(action), t64(q), t64(v)).numpy(),
        np.asarray(JR._decode_action(jcfg, action, q, v)), atol=1e-12, rtol=0)


def test_features_goal_and_failure_match_jax():
    jm, tm = JC.load_model(), TC.load_model()
    rng = np.random.default_rng(1)
    B = 6
    q = np.tile(JC.q0(), (B, 1))
    q[:, 7:] += rng.normal(size=(B, 12)) * 0.1
    # tilted bases (two beyond 30 degrees of roll or pitch) and low ones
    ang = np.deg2rad([0.0, 10.0, 35.0, 0.0, 0.0, 25.0])
    axis = [0, 0, 0, 1, 1, 1]
    for b in range(B):
        quat = np.zeros(4)
        quat[axis[b]] = np.sin(ang[b] / 2)
        quat[3] = np.cos(ang[b] / 2)
        q[b, 3:7] = quat
    q[3, 2] = 0.05
    q[4, 2] = 0.3
    q[5, 3:7] = [0.0, np.sin(np.deg2rad(32) / 2), 0.0, np.cos(np.deg2rad(32) / 2)]
    v = rng.normal(size=(B, 18))
    v_des = rng.uniform(0.0, 0.3, size=(B, 3))
    w_des = rng.uniform(-0.3, 0.3, size=B)
    cfg = JR.RolloutConfig(episode_length=100)
    tcfg = convert.rollout_config_from(cfg)
    np.testing.assert_allclose(
        TR.state_features(tm, EFF, t64(q), t64(v)).numpy(),
        np.asarray(JR.state_features(jm, EFF, q, v)), atol=1e-12, rtol=0)
    for step in (0, 137, 2999):
        ref = np.stack([np.asarray(JR.vc_goal(cfg, step, v_des[b], w_des[b])) for b in range(B)])
        got = TR.vc_goal(tcfg, torch.tensor(float(step), dtype=F64), t64(v_des), t64(w_des))
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-12, rtol=0)
    for elapsed in (100, 501):
        ref = np.asarray(JR.failed_state(cfg, q, elapsed))
        np.testing.assert_array_equal(TR.failed_state(tcfg, t64(q), elapsed).numpy(), ref)
        assert ref.any() == (elapsed > 500)


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


@pytest.mark.parametrize("variant", ["cold", "carry"])
def test_closed_loop_matches_jax_rollout(spec, reference, variant):
    ref = reference
    B = REF.B
    state0 = physics.SimState(q=t64(ref["q0"]).expand(B, -1).contiguous(),
                              v=t64(ref["v0"]).expand(B, -1).contiguous())
    cfg = TR.RolloutConfig(episode_length=REF.T, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    res = TR.rollout_mpc(
        spec, workload.closed_loop_sim_params(), cfg, state0, t64(ref["v_des"]),
        t64(ref["w_des"]), admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60),
        ddp_cfg=ddp.DdpConfig(n_iters=4), warm_start_carry=variant == "carry",
        admm_backend="torch", ik_backend="torch")
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


def test_one_window_f32_spread_is_inside_the_card_gate(spec):
    """One window (50 steps) of the plain path from the settled start with
    the reference-envelope commands, float32 against float64 on 8 episodes:
    chip_smoke.py phase 7a holds the card's end-of-window q and v against the
    plain path in float64 within WINDOW_Q_TOL and WINDOW_V_TOL, which must
    be at least 3x this spread."""
    n = 8
    st = workload.settled_start(1, device="cpu", dtype=F64)
    v_des, w_des = workload.command_draw(n)
    cfg = TR.RolloutConfig(episode_length=50, kp=trot_sim.kp, kd=trot_sim.kd)
    out = {}
    for dt in (torch.float32, F64):
        s = physics.SimState(st.q.to(dt).expand(n, -1).contiguous(),
                             st.v.to(dt).expand(n, -1).contiguous())
        out[dt] = TR.rollout_mpc(
            spec, workload.closed_loop_sim_params(), cfg, s, torch.as_tensor(v_des, dtype=dt),
            torch.as_tensor(w_des, dtype=dt), admm_backend="torch", ik_backend="torch")
    a, b = out[torch.float32].final_state, out[F64].final_state
    dq = float((a.q.double() - b.q).abs().max())
    dv = float((a.v.double() - b.v).abs().max())
    print(f"one-window f32 vs f64 spread: q {dq:.3e}, v {dv:.3e}; card gates "
          f"q {chip_smoke.WINDOW_Q_TOL:.1e}, v {chip_smoke.WINDOW_V_TOL:.1e}")
    assert 0.0 < dq and 3.0 * dq <= chip_smoke.WINDOW_Q_TOL
    assert 0.0 < dv and 3.0 * dv <= chip_smoke.WINDOW_V_TOL


def test_two_window_f32_spread_is_inside_the_card_gate(spec):
    """Two windows (100 steps) of the plain path from the settled start with
    the reference-envelope commands and (X, F, P) carried into the second
    solve (the default on "tiled" specs), float32 against float64 on 8
    episodes: chip_smoke.py phase 7a holds the card's end q and v against
    the plain path in float64 within TWO_WINDOW_Q_TOL and TWO_WINDOW_V_TOL,
    which must be at least 3x this spread."""
    n = 8
    st = workload.settled_start(1, device="cpu", dtype=F64)
    v_des, w_des = workload.command_draw(n)
    cfg = TR.RolloutConfig(episode_length=100, kp=trot_sim.kp, kd=trot_sim.kd)
    out = {}
    for dt in (torch.float32, F64):
        s = physics.SimState(st.q.to(dt).expand(n, -1).contiguous(),
                             st.v.to(dt).expand(n, -1).contiguous())
        out[dt] = TR.rollout_mpc(
            spec, workload.closed_loop_sim_params(), cfg, s, torch.as_tensor(v_des, dtype=dt),
            torch.as_tensor(w_des, dtype=dt), admm_backend="torch", ik_backend="torch")
    a, b = out[torch.float32].final_state, out[F64].final_state
    dq = float((a.q.double() - b.q).abs().max())
    dv = float((a.v.double() - b.v).abs().max())
    print(f"two-window f32 vs f64 spread: q {dq:.3e}, v {dv:.3e}; card gates "
          f"q {chip_smoke.TWO_WINDOW_Q_TOL:.1e}, v {chip_smoke.TWO_WINDOW_V_TOL:.1e}")
    assert 0.0 < dq and 3.0 * dq <= chip_smoke.TWO_WINDOW_Q_TOL
    assert 0.0 < dv and 3.0 * dv <= chip_smoke.TWO_WINDOW_V_TOL


def _later_kwargs():
    zero = physics.Terrain(heights=torch.zeros(10, 10, dtype=F64), origin=(-1.0, -1.0), cell=0.2)
    return {"terrain": dict(terrain=zero)}


@pytest.mark.parametrize("option", list(_later_kwargs()))
def test_options_left_for_later_raise(spec, option):
    """The options once left for later now run: one window of the plain
    loop with a zero heightfield equals the loop without terrain in every
    record (tests/test_torch_terrain.py holds terrain against the JAX
    package)."""
    kwargs = dict(_later_kwargs()[option])
    st = physics.SimState(t64(np.tile(TC.q0(), (2, 1))), torch.zeros(2, 18, dtype=F64))
    cfg = TR.RolloutConfig(episode_length=50)
    out = [TR.rollout_mpc(spec, workload.closed_loop_sim_params(), cfg, st,
                          torch.zeros(2, 3, dtype=F64), torch.zeros(2, dtype=F64),
                          admm_backend="torch", ik_backend="torch", **kw)
           for kw in ({}, kwargs)]
    for f in REF.FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f


def _bad_option_kwargs():
    return {
        "per-episode dt": dict(sim_params=physics.SimParams(dt=torch.full((2,), 1e-3,
                                                                            dtype=F64))),
        "gains of another batch": dict(gains=controllers.IdControllerGains(
            kp=torch.full((3,), 12.0, dtype=F64), kd=0.5)),
        "contact of another batch": dict(sim_params=physics.SimParams(
            contact=physics.ContactParams(kn=torch.full((5,), 1e4, dtype=F64)))),
        "swing_blend of another batch": dict(swing_blend=torch.full((3,), 0.5, dtype=F64)),
        "q_noise of another width": dict(q_noise=torch.zeros(18, dtype=F64)),
        "v_noise of another batch": dict(v_noise=torch.zeros(3, 18, dtype=F64)),
    }


@pytest.mark.parametrize("option", list(_bad_option_kwargs()))
def test_per_episode_options_check_their_shapes(spec, option):
    """A per-episode option is a float or one value per episode, a sensor
    bias (n,) or (B, n), and the step ``dt`` one float for the batch."""
    kwargs = dict(_bad_option_kwargs()[option])
    sp = kwargs.pop("sim_params", workload.closed_loop_sim_params())
    st = physics.SimState(t64(np.tile(TC.q0(), (2, 1))), torch.zeros(2, 18, dtype=F64))
    cfg = TR.RolloutConfig(episode_length=100)
    with pytest.raises(ValueError):
        TR.rollout_mpc(spec, sp, cfg, st, torch.zeros(2, 3, dtype=F64),
                       torch.zeros(2, dtype=F64), admm_backend="torch", ik_backend="torch",
                       **kwargs)


def test_cuda_backend_carries_the_dual(spec, reference):
    """``admm_backend="cuda"`` with (X, F, P) carried, on CPU tensors (K1's
    and K2's plain versions, K1's taking the carried dual in and giving it
    back), against the JAX package's carried rollout
    (tests/fixtures/torch_rollout_solo12_trot_sim.npz, "carry"): every record
    within atol 1e-9, flags and failure steps equal, as the "torch" case.
    The same call with the default ``warm_start_carry`` (None) carries too:
    the spec is "tiled"."""
    ref = reference
    B = REF.B
    state0 = physics.SimState(q=t64(ref["q0"]).expand(B, -1).contiguous(),
                              v=t64(ref["v0"]).expand(B, -1).contiguous())
    cfg = TR.RolloutConfig(episode_length=REF.T, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    for carry in (True, None):
        res = TR.rollout_mpc(
            spec, workload.closed_loop_sim_params(), cfg, state0, t64(ref["v_des"]),
            t64(ref["w_des"]), admm_cfg=cuda_admm.CudaAdmmConfig(rho=trot_sim.rho,
                                                                 max_admm_iters=60),
            ddp_cfg=ddp.DdpConfig(n_iters=4), warm_start_carry=carry, admm_backend="cuda",
            ik_backend="torch")
        got = {f: getattr(res, f).numpy() for f in REF.FIELDS}
        got["final_q"], got["final_v"] = res.final_state.q.numpy(), res.final_state.v.numpy()
        for f, a in got.items():
            r = ref[f"carry/{f}"]
            if a.dtype.kind in "bi":
                np.testing.assert_array_equal(a, r, err_msg=f)
            else:
                np.testing.assert_allclose(a, r, atol=1e-9, rtol=0, err_msg=f)


def test_rollout_records_one_substeps_span_per_window(spec):
    n = 2
    state0 = physics.SimState(q=t64(TC.q0()).expand(n, -1).contiguous(),
                              v=torch.zeros((n, spec.model.nv), dtype=F64))
    cfg = TR.RolloutConfig(episode_length=20, plan_freq=0.01, kp=trot_sim.kp, kd=trot_sim.kd)
    with profiling.recording() as rec:
        TR.rollout_mpc(spec, workload.closed_loop_sim_params(), cfg, state0,
                       torch.zeros((n, 3), dtype=F64), torch.zeros(n, dtype=F64),
                       admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=4),
                       ddp_cfg=ddp.DdpConfig(n_iters=1), admm_backend="torch",
                       ik_backend="torch")
    top = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in top] == ["mpc.solve", "rollout.substeps"] * cfg.n_windows
    assert all(a.end <= b.start for a, b in zip(top, top[1:]))
    assert len(rec.counters["mpc.admm_iters_max"]) == cfg.n_windows


@pytest.mark.slow
def test_fixture_is_the_jax_rollout():
    """The committed reference is what the JAX package computes today
    (~6 min: two traces and compiles of the JAX rollout_mpc)."""
    import jax

    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)
