"""The policy rollouts (``bunmpc_tpu_torch/sim/rollout.py``: ``rollout_policy``,
``cc_goal_fn``, ``rollout_policy_cc``) against the JAX package's on the same
seeded inputs.

* Three episodes of 100 steps in float64 with vc goals and with cc goals,
  each driven by the same flax policy carried across
  (``convert.policy_bundle_from_flax``), against the JAX package's
  ``vmap(rollout_policy[_cc])`` (tests/torch_learning_reference.py, the
  fixture tests/fixtures/torch_policy_rollout_solo12_trot_sim.npz): every
  record within atol 1e-9, flags and failure steps equal.
* The cc goal against the JAX ``cc_goal_fn`` on schedules padded by
  repeating a foot's last touchdown, at steps before, between and after the
  touchdowns, for goal horizons 1 and 2.
* The float32-against-float64 spread of the first 50 steps of a cc policy
  rollout of a policy trained at the BC config's widths, which
  ``chip_smoke.py`` phase 8c's gate is built on: the gate holds at least 3x
  the spread.
* Terrain on a zero heightfield gives the flat rollout; a CPU-only host
  refuses the default device.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_learning_reference as REF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
import torch_rollout_reference as ROLLOUT_REF
from bunmpc_tpu.robots.solo12 import Solo12Config as JC
from bunmpc_tpu.sim import rollout as JR
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.learning import bc, goals, networks
from bunmpc_tpu_torch.learning.contact_planner import ContactPlanner
from bunmpc_tpu_torch.learning.database import Database
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.sim import physics
from bunmpc_tpu_torch.sim import rollout as TR

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (phase 8c's gates)

F64 = torch.float64


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


@pytest.fixture(scope="module")
def spec():
    return KD.make_cyclic_spec(TC.load_model(), trot_sim, TC.q0(), device="cpu")


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


def _cfg(T):
    return TR.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                            gait_period=trot_sim.gait_period)


@pytest.mark.parametrize("variant", ["vc", "cc"])
def test_policy_rollout_matches_jax(spec, reference, variant):
    ref = reference
    B = REF.B
    bundle = convert.policy_bundle_from_flax(
        REF.unflat_params(ref, f"{variant}/params"), ref["state_mean"], ref["state_std"],
        ref[f"{variant}/goal_mean"], ref[f"{variant}/goal_std"])
    state0 = physics.SimState(q=t64(ref["q0"]).expand(B, -1).contiguous(),
                              v=t64(ref["v0"]).expand(B, -1).contiguous())
    args = (spec, workload.closed_loop_sim_params(), _cfg(REF.T), state0, t64(ref["v_des"]),
            t64(ref["w_des"]), bundle)
    if variant == "vc":
        res = TR.rollout_policy(*args)
    else:
        res = TR.rollout_policy_cc(*args, ref["schedule"])
    got = {f: getattr(res, f).numpy() for f in REF.FIELDS}
    got["final_q"], got["final_v"] = res.final_state.q.numpy(), res.final_state.v.numpy()
    assert not got["failed"].any()
    assert (res.mpc_usage == 0).all()
    for f, a in got.items():
        r = ref[f"{variant}/{f}"]
        assert a.shape == r.shape, f
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, r, err_msg=f)
        else:
            np.testing.assert_allclose(a, r, atol=1e-9, rtol=0, err_msg=f)


@pytest.mark.parametrize("goal_horizon", [1, 2])
def test_cc_goal_matches_jax(goal_horizon):
    """Per-foot touchdown counts differ (3, 1, 0 and 2 rows) and the schedule
    is padded by repeating each foot's last row: the port's batched goal
    equals the JAX goal of each episode at every probed step."""
    jm, tm = JC.load_model(), TC.load_model()
    eff = tuple(TC.eff_names)
    rng = np.random.default_rng(4)
    per_episode = []
    for b in range(2):
        counts = [3, 1, 0, 2] if b == 0 else [2, 2, 2, 2]
        feet = []
        for n in counts:
            steps = np.sort(rng.choice(np.arange(20, 400), size=n, replace=False)).astype(float)
            feet.append(np.concatenate([steps[:, None], rng.normal(size=(n, 2)) * 0.2,
                                        np.full((n, 1), 1e-3)], axis=1))
        per_episode.append(feet)
    n = max(len(f) for feet in per_episode for f in feet)
    sched = np.stack([REF.repeat_pad(feet, n) for feet in per_episode])
    q = np.tile(JC.q0(), (2, 1))
    q[:, 7:] += rng.normal(size=(2, 12)) * 0.1
    gfn = TR.cc_goal_fn(tm, eff, t64(sched), goal_horizon)
    for step in (0, 19, 20, 150, 399, 450):
        got = gfn(torch.tensor(step), t64(q)).numpy()
        for b in range(2):
            ref = JR.cc_goal_fn(jm, eff, sched[b], goal_horizon)(jnp.asarray(step), q[b])
            np.testing.assert_allclose(got[b], np.asarray(ref), atol=1e-12, rtol=0,
                                       err_msg=f"step {step}, episode {b}")


def spread_policy(planner):
    """A policy at the BC config's widths trained as phase 8b trains one
    (``bc.train_policy``, L1, Adam, 30 epochs of batch 64 here) on the
    expert records of tests/fixtures/torch_rollout_solo12_trot_sim.npz (3
    episodes x 100 steps of the closed loop), with cc goals against the
    episodes' ContactPlanner schedules."""
    fx = np.load(ROLLOUT_REF.FIXTURE)
    B = fx["cold/states"].shape[0]
    q0 = torch.as_tensor(fx["q0"]).expand(B, -1)
    sched, _ = planner.get_contact_schedule(q0, None, fx["v_des"], fx["w_des"], 3000, 0.0)
    db = Database(10_000)
    for b in range(B):
        cc = goals.construct_cc_goal(100, 4, sched[b], fx["cold/com"][b])
        db.append(fx["cold/states"][b], fx["cold/actions"][b], vc_goals=fx["cold/vc_goals"][b],
                  cc_goals=cc)
    bundle, _ = bc.train_policy(db, bc.BcConfig(n_epoch=30, batch_size=64), device="cpu")
    return bundle


def test_first_50_steps_f32_spread_is_inside_the_card_gate(spec):
    """The first 50 steps of a cc policy rollout from the settled start with
    the reference-envelope commands and their ContactPlanner schedules,
    float32 against float64 on 8 episodes: chip_smoke.py phase 8c holds the
    card's end q and v against the same rollout in float64 on the CPU within
    POLICY_Q_TOL and POLICY_V_TOL, which must be at least 3x this spread."""
    planner = ContactPlanner(spec)
    n = 8
    st = workload.settled_start(1, device="cpu", dtype=F64)
    v_des, w_des = workload.command_draw(n)
    q0, v0 = st.q.expand(n, -1).contiguous(), st.v.expand(n, -1).contiguous()
    sched, _ = planner.get_contact_schedule(q0, v0, v_des, w_des, 3000, 0.0)
    bundle = spread_policy(planner)
    out = {}
    for dt in (torch.float32, F64):
        bundle.module.to(dt)
        b = networks.PolicyBundle(bundle.module, *(x.to(dt) for x in (
            bundle.state_mean, bundle.state_std, bundle.goal_mean, bundle.goal_std)))
        out[dt] = TR.rollout_policy_cc(
            spec, workload.closed_loop_sim_params(), _cfg(50),
            physics.SimState(q0.to(dt), v0.to(dt)), torch.as_tensor(v_des, dtype=dt),
            torch.as_tensor(w_des, dtype=dt), b, sched).final_state
    a, b = out[torch.float32], out[F64]
    dq = float((a.q.double() - b.q).abs().max())
    dv = float((a.v.double() - b.v).abs().max())
    print(f"first-50-step f32 vs f64 spread: q {dq:.3e}, v {dv:.3e}; card gates "
          f"q {chip_smoke.POLICY_Q_TOL:.1e}, v {chip_smoke.POLICY_V_TOL:.1e}")
    assert 0.0 < dq and 3.0 * dq <= chip_smoke.POLICY_Q_TOL
    assert 0.0 < dv and 3.0 * dv <= chip_smoke.POLICY_V_TOL


def _later_kwargs():
    zero = physics.Terrain(heights=torch.zeros(10, 10, dtype=F64), origin=(-1.0, -1.0), cell=0.2)
    return {"terrain": dict(terrain=zero)}


@pytest.mark.parametrize("option", list(_later_kwargs()))
def test_policy_rollout_options_left_for_later_raise(spec, option):
    """The options once left for later now run: a zero heightfield gives
    the policy rollout without terrain in every record."""
    st = physics.SimState(t64(np.tile(TC.q0(), (2, 1))), torch.zeros(2, 18, dtype=F64))
    out = [TR.rollout_policy(spec, workload.closed_loop_sim_params(), _cfg(10), st,
                             torch.zeros(2, 3, dtype=F64), torch.zeros(2, dtype=F64),
                             lambda s, g: s[:, :12] * 0.0, **kw)
           for kw in ({}, _later_kwargs()[option])]
    for f in REF.FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f


def test_policy_rollout_defaults_to_the_card(spec):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal applies to CPU-only hosts")
    import dataclasses

    gpu_spec = dataclasses.replace(spec, device=torch.device("cuda"))
    st = physics.SimState(np.tile(TC.q0(), (2, 1)), np.zeros((2, 18)))
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.rollout_policy(gpu_spec, workload.closed_loop_sim_params(), _cfg(10), st,
                          np.zeros((2, 3)), np.zeros(2), lambda s, g: s[:, :12])


@pytest.mark.slow
def test_fixture_is_the_jax_policy_rollout():
    """The committed reference is what the JAX package computes today."""
    import jax

    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)
