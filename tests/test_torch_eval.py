"""The eval suite (``bunmpc_tpu_torch/eval/``) and the pushed rollouts it
needs, against the JAX package's ``bunmpc_tpu/eval/`` and
``bunmpc_tpu/sim/rollout.py`` on the same seeded inputs.

* ``rollout_mpc`` and ``rollout_policy`` with a (B, T, 3) push, and a
  ``cc_static`` policy rollout (goals read by the device step), at B=3 over
  two windows in float64, against the JAX package's ``vmap`` with
  ``push_force`` and with ``goal_fn`` (tests/torch_eval_reference.py, the
  fixture tests/fixtures/torch_eval_solo12_trot_sim.npz): every record within
  atol 1e-9, flags and failure steps equal. A push changes nothing before
  its first step (bit for bit) and a (T, 3) push is the (B, T, 3) push of
  the same rows.
* ``_evaluate``, both results' ``summary``/``to_csv``, ``desired_schedules``,
  ``static_cc_goals`` and the past-goals bookkeeping against the JAX
  functions on the same arrays: exact, or within 1e-12 in float64.
* ``max_force_search``'s history against the JAX one with the same
  ``survival_fraction`` stub on both sides; ``survival_fraction``'s push
  layout against the JAX package's.
* ``train_from_databases`` against the JAX one on two small h5 snapshots
  from the same initial parameters: losses within the BC tolerance of
  tests/test_torch_learning.py (float32 both sides, rtol 1e-5).
* Every driver once on the CPU on the plain backends; ``reconstruct_q`` and
  the two strip plots.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_eval_reference as REF
import torch_learning_reference as POLICY_REF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.eval import cc_replanning as JCCR
from bunmpc_tpu.eval import max_force as JMF
from bunmpc_tpu.eval import multi_database as JMDB
from bunmpc_tpu.eval import past_goals as JPG
from bunmpc_tpu.eval import velocity_grid as JVG
from bunmpc_tpu.eval import visualize as JVIS
from bunmpc_tpu.learning import bc as JBC
from bunmpc_tpu.learning.networks import GoalConditionedPolicyNet as JNet
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim as jtrot_sim
from bunmpc_tpu.robots.solo12 import Solo12Config as JC
from bunmpc_tpu.sim import rollout as JR
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.eval import cc_replanning as CCR
from bunmpc_tpu_torch.eval import max_force as MF
from bunmpc_tpu_torch.eval import multi_database as MDB
from bunmpc_tpu_torch.eval import past_goals as PG
from bunmpc_tpu_torch.eval import velocity_grid as VG
from bunmpc_tpu_torch.eval import visualize as VIS
from bunmpc_tpu_torch.learning import bc
from bunmpc_tpu_torch.learning.database import Database
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.sim import physics
from bunmpc_tpu_torch.sim import rollout as TR
from bunmpc_tpu_torch.solvers import biconvex, ddp

F64 = torch.float64


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


@pytest.fixture(scope="module")
def spec():
    return KD.make_cyclic_spec(TC.load_model(), trot_sim, TC.q0(), device="cpu")


@pytest.fixture(scope="module")
def jspec():
    return JKD.make_cyclic_spec(JC.load_model(), jtrot_sim, JC.q0())


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


@pytest.fixture(scope="module")
def policies():
    pol = dict(np.load(POLICY_REF.FIXTURE))
    return {name: convert.policy_bundle_from_flax(
        POLICY_REF.unflat_params(pol, f"{name}/params"), pol["state_mean"], pol["state_std"],
        pol[f"{name}/goal_mean"], pol[f"{name}/goal_std"]) for name in ("vc", "cc")}


def _cfg(T=REF.T):
    return TR.RolloutConfig(episode_length=T, kp=trot_sim.kp, kd=trot_sim.kd,
                            gait_period=trot_sim.gait_period)


def _start(ref, B=REF.B):
    return physics.SimState(q=t64(ref["q0"]).expand(B, -1).contiguous(),
                            v=t64(ref["v0"]).expand(B, -1).contiguous())


def _run(spec, ref, policies, variant, push=None, goals=None):
    args = (spec, workload.closed_loop_sim_params(), _cfg(), _start(ref), t64(ref["v_des"]),
            t64(ref["w_des"]))
    if variant == "mpc":
        return TR.rollout_mpc(
            *args, push_force=push, admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho,
                                                                     max_admm_iters=60),
            ddp_cfg=ddp.DdpConfig(n_iters=4), warm_start_carry=False, admm_backend="torch",
            ik_backend="torch")
    if variant == "policy":
        return TR.rollout_policy(*args, policies["vc"], push_force=push)
    return TR.rollout_policy(*args, policies["cc"], goal_fn=CCR.static_goal_fn(goals))


def _assert_records(res, ref, variant, atol=1e-9):
    got = {f: getattr(res, f).numpy() for f in REF.FIELDS}
    got["final_q"], got["final_v"] = res.final_state.q.numpy(), res.final_state.v.numpy()
    for f, a in got.items():
        r = ref[f"{variant}/{f}"]
        assert a.shape == r.shape, f
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, r, err_msg=f)
        else:
            np.testing.assert_allclose(a, r, atol=atol, rtol=0, err_msg=f)


def _static_goals(spec, ref):
    sched = CCR.desired_schedules(spec, ref["q0"], ref["v0"], ref["v_des"], ref["w_des"], REF.T)
    return CCR.static_cc_goals(spec, sched, ref["q0"], ref["v_des"], REF.T)


@pytest.mark.parametrize("variant", ["mpc", "policy", "cc_static"])
def test_rollouts_match_jax(spec, reference, policies, variant):
    ref = reference
    goals = None
    if variant == "cc_static":
        goals = _static_goals(spec, ref)
        np.testing.assert_allclose(goals, ref["static_goals"], atol=1e-12, rtol=0)
        goals = t64(goals)
    res = _run(spec, ref, policies, variant, push=t64(ref["push"]), goals=goals)
    assert not res.failed.any()
    _assert_records(res, ref, variant)
    if variant == "cc_static":
        np.testing.assert_array_equal(res.vc_goals.numpy(), goals.numpy())


def test_push_starts_at_its_step(spec, reference, policies):
    """Records before the push's first step are bit-equal to an unpushed
    run and differ after it; a (T, 3) push equals the (B, T, 3) push of the
    same rows for every episode."""
    ref = reference
    free = _run(spec, ref, policies, "policy")
    pushed = _run(spec, ref, policies, "policy", push=t64(ref["push"]))
    k = REF.PUSH_START
    for f in ("states", "actions", "base"):
        a, b = getattr(free, f), getattr(pushed, f)
        assert torch.equal(a[:, :k + 1], b[:, :k + 1]), f  # the push acts from step k on
        assert (a[:, k + 1:] != b[:, k + 1:]).any(dim=(1, 2)).all(), f
    row = t64(ref["push"][1])
    shared = _run(spec, ref, policies, "policy", push=row)
    each = _run(spec, ref, policies, "policy", push=row.expand(REF.B, -1, -1))
    assert torch.equal(shared.states, each.states)


@pytest.mark.parametrize("shape", [(REF.T, 2), (REF.B + 1, REF.T, 3), (REF.T - 1, 3)])
def test_push_shape_is_checked(spec, reference, policies, shape):
    with pytest.raises(ValueError, match="push_force"):
        _run(spec, reference, policies, "policy", push=torch.zeros(shape, dtype=F64))


# ---- host-side bookkeeping against the JAX functions on the same arrays ----


class _Records:
    """A rollout's records as both packages' evaluators read them."""

    def __init__(self, seed, B=6, T=40, tensors=False):
        rng = np.random.default_rng(seed)
        self.states = rng.normal(size=(B, T, 43)).astype(np.float32)
        self.failed = rng.random(B) < 0.4
        self.fail_step = np.where(self.failed, rng.integers(1, T, B), T).astype(np.int32)
        if tensors:
            for k in ("states", "failed", "fail_step"):
                setattr(self, k, torch.as_tensor(getattr(self, k)))


def _grid(seed):
    rng = np.random.default_rng(seed)
    v_des = np.stack([rng.uniform(-0.3, 0.5, 6), rng.uniform(-0.2, 0.2, 6), np.zeros(6)], -1)
    return v_des.astype(np.float32), rng.uniform(-0.3, 0.3, 6).astype(np.float32)


def _same_result(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, dict):
            assert x.keys() == y.keys()
            for k in y:
                np.testing.assert_array_equal(x[k], y[k])
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)


def _same_file(write_a, write_b, tmp_path):
    pa, pb = tmp_path / "a.csv", tmp_path / "b.csv"
    write_a(str(pa))
    write_b(str(pb))
    assert pa.read_text() == pb.read_text()


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_evaluation_matches_jax(seed, tmp_path):
    v_des, w_des = _grid(seed)
    ref = JVG._evaluate(_Records(seed), v_des, w_des, 8)
    got = VG._evaluate(_Records(seed, tensors=True), torch.as_tensor(v_des),
                       torch.as_tensor(w_des), 8)
    _same_result(got, ref)
    assert got.summary() == ref.summary()
    _same_file(got.to_csv, ref.to_csv, tmp_path)
    # the multi-database comparison over two such grids
    args = [dict(label=f"db{i}", bundle=None, db_size=100 * (i + 1), final_train_loss=0.1 / (i + 1),
                 final_valid_loss=0.2 / (i + 1)) for i in range(2)]
    jcmp = JMDB.ComparisonResult([JMDB.PolicyEntry(**a) for a in args], {"db0": ref, "db1": ref})
    tcmp = MDB.ComparisonResult([MDB.PolicyEntry(**a) for a in args], {"db0": got, "db1": got})
    assert tcmp.summary() == jcmp.summary()
    _same_file(tcmp.to_csv, jcmp.to_csv, tmp_path)


def test_cc_result_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    v_des, w_des = _grid(2)
    arrays = dict(v_des=v_des, w_des=w_des,
                  vx_mse={n: rng.random(6) for n in ("vc", "cc_static", "cc_replanned")},
                  vy_mse={n: rng.random(6) for n in ("vc", "cc_static", "cc_replanned")},
                  survived={n: rng.random(6) < 0.5 for n in ("vc", "cc_static", "cc_replanned")})
    arrays["survived"]["vc"][:] = False  # a variant without survivors: nan means
    got, ref = CCR.CcReplanResult(**arrays), JCCR.CcReplanResult(**arrays)
    assert repr(got.summary()) == repr(ref.summary())
    _same_file(got.to_csv, ref.to_csv, tmp_path)


def test_desired_schedules_and_static_goals_match_jax(spec, jspec, reference):
    """The port's schedules hold the JAX planner's touchdowns per foot,
    padded by repeating the foot's last one (the JAX planner pads with zero
    rows); ``static_cc_goals`` equals the JAX function on the same
    schedules, and on the port's own schedules the JAX package's goals."""
    ref = reference
    T, B = 1200, REF.B  # three touchdowns a foot
    jsched = JCCR.desired_schedules(jspec, ref["q0"], ref["v0"], ref["v_des"], ref["w_des"], T)
    sched = CCR.desired_schedules(spec, ref["q0"], ref["v0"], ref["v_des"], ref["w_des"], T)
    for b in range(B):
        for ee in range(spec.n_eff):
            real = jsched[b, ee][jsched[b, ee, :, 0] > 0]
            n = len(real)
            assert n > 0
            np.testing.assert_allclose(sched[b, ee, :n], real, atol=1e-12, rtol=0)
            np.testing.assert_array_equal(sched[b, ee, n:], np.broadcast_to(
                sched[b, ee, n - 1], sched[b, ee, n:].shape))
    for gh in (1, 2):
        ref_goals = JCCR.static_cc_goals(jspec, jsched, jnp.asarray(ref["q0"]), ref["v_des"], T,
                                         goal_horizon=gh)
        got = CCR.static_cc_goals(spec, jsched, ref["q0"], ref["v_des"], T, goal_horizon=gh)
        np.testing.assert_allclose(got, ref_goals, atol=1e-12, rtol=0)
        own = CCR.static_cc_goals(spec, sched, ref["q0"], ref["v_des"], T, goal_horizon=gh)
        np.testing.assert_allclose(own, ref_goals, atol=1e-12, rtol=0)


def test_max_force_history_matches_jax(monkeypatch):
    def stub(spec, sp, cfg, state0, v_des, w_des, magnitude, directions, push_start,
             push_duration, **kw):
        return float(np.clip(1.2 - magnitude / 25.0, 0.0, 1.0))

    monkeypatch.setattr(JMF, "survival_fraction", stub)
    monkeypatch.setattr(MF, "survival_fraction", stub)
    cfg = TR.RolloutConfig(episode_length=900)
    for kw in (dict(), dict(f_low=5.0, f_high=40.0, n_bisect=7, survival_threshold=0.3)):
        ref = JMF.max_force_search(None, None, cfg, None, None, 0.0, **kw)
        got = MF.max_force_search(None, None, cfg, None, None, 0.0, **kw)
        assert got == ref


def test_survival_fraction_push_layout(spec, monkeypatch):
    """The (B, T, 3) push ``survival_fraction`` builds on the device is the
    JAX package's numpy layout, and the survival it returns is 1 - the
    failed fraction."""
    seen = {}

    def fake(spec, sp, cfg, state, vd, wd, push_force=None, **kw):
        seen.update(push=push_force, state=state, vd=vd, wd=wd, kw=kw)
        failed = torch.zeros(push_force.shape[0], dtype=torch.bool)
        failed[::3] = True
        return TR.RolloutResult(*([None] * 8), failed=failed, fail_step=None, final_state=None,
                                mpc_usage=None)

    monkeypatch.setattr(TR, "rollout_mpc", fake)
    ang = np.linspace(0, 2 * np.pi, 5, endpoint=False)
    dirs = np.stack([np.cos(ang), np.sin(ang), np.zeros(5)], -1).astype(np.float32)
    cfg = TR.RolloutConfig(episode_length=120)
    st = physics.SimState(torch.as_tensor(TC.q0(), dtype=torch.float32), torch.zeros(18))
    frac = MF.survival_fraction(spec, None, cfg, st, [0.1, 0.0, 0.0], 0.2, 7.5, dirs, 40, 30,
                                admm_backend="torch", ik_backend="torch")
    push = np.zeros((5, 120, 3), np.float32)
    push[:, 40:70, :] = 7.5 * dirs[:, None, :]
    np.testing.assert_array_equal(seen["push"].numpy(), push)
    assert frac == pytest.approx(1.0 - 2 / 5, abs=1e-15)
    assert seen["state"].q.shape == (5, 19) and seen["vd"].shape == (5, 3)
    assert seen["kw"]["admm_backend"] == "torch"


# ---- the past-goals bookkeeping: stubbed rollouts and trainer on both sides ----


def _past_goal_data(n, T):
    rng = np.random.default_rng(6)
    states = rng.normal(size=(n, T, 43)).astype(np.float32)
    actions = rng.normal(size=(n, T, 12)).astype(np.float32)
    vc_goals = rng.normal(size=(n, T, 5)).astype(np.float32)
    mpc_fail = np.array([-1, 30, 80, -1, 1])[:n]  # failed at that step (-1: survived)
    pol_fail = np.array([-1, 1, 60, 20, -1])[:n]
    return states, actions, vc_goals, mpc_fail, pol_fail


def test_past_goals_bookkeeping_matches_jax(spec, monkeypatch):
    """Both drivers over the same per-goal records (the MPC's, and the
    policy's shifted by the iteration's training-set size so that rows
    differ): equal matrices, databases and BC seeds; only the rows j <= i
    are filled, NaN elsewhere."""
    n, T = 5, 120
    states, actions, vc_goals, mpc_fail, pol_fail = _past_goal_data(n, T)
    goal_list = np.stack([np.linspace(0.0, 0.4, n), np.zeros(n), np.zeros(n),
                          np.linspace(-0.2, 0.2, n)], -1).astype(np.float32)
    calls = {"jax": [], "torch": []}

    def goal_index(vd):
        return int(np.argmin(np.abs(goal_list[:, 0] - float(vd[0]))))

    # ---- the JAX driver (jitted MPC per goal, jitted vmapped policy batch) ----
    def j_mpc(spec, sp, cfg, state, vd, wd, **kw):
        j = jnp.argmin(jnp.abs(jnp.asarray(goal_list[:, 0]) - vd[0]))
        f = jnp.asarray(mpc_fail)[j]
        return JR.RolloutResult(
            states=jnp.asarray(states)[j], actions=jnp.asarray(actions)[j],
            vc_goals=jnp.asarray(vc_goals)[j], base=None, com=None, contact_forces=None,
            contact_pos=None, in_contact=None, failed=f >= 0,
            fail_step=jnp.where(f >= 0, f, T).astype(jnp.int32), final_state=None,
            mpc_usage=None)

    def j_policy(spec, sp, cfg, state, vd, wd, pf):
        j = jnp.argmin(jnp.abs(jnp.asarray(goal_list[:, 0]) - vd[0]))
        shift = pf(jnp.zeros(43), jnp.zeros(5))[0]
        f = jnp.asarray(pol_fail)[j]
        return JR.RolloutResult(
            states=jnp.asarray(states)[j] + shift, actions=None, vc_goals=None, base=None,
            com=None, contact_forces=None, contact_pos=None, in_contact=None, failed=f >= 0,
            fail_step=jnp.where(f >= 0, f, T).astype(jnp.int32), final_state=None,
            mpc_usage=None)

    class JModule:
        def apply(self, variables, x):
            return jnp.broadcast_to(variables["params"], x.shape[:-1] + (12,))

    def j_train(db, cfg, rng_seed, params=None):
        calls["jax"].append((rng_seed, len(db), db.states.copy(), None if params is None
                             else float(params)))
        z = jnp.zeros(())
        return type("P", (), dict(module=JModule(), params=jnp.asarray(1e-3 * len(db), jnp.float32),
                                  state_mean=z, state_std=z + 1, goal_mean=z, goal_std=z + 1)), None

    monkeypatch.setattr(JR, "rollout_mpc", j_mpc)
    monkeypatch.setattr(JR, "rollout_policy", j_policy)
    monkeypatch.setattr(JPG, "train_policy", j_train)
    ref = JPG.run_past_goals_eval(None, None, JR.RolloutConfig(episode_length=T), TC.q0(),
                                  np.zeros(18), goal_list, seed=3)

    # ---- the port's driver (one batched MPC call, one policy batch a goal set) ----
    def t_mpc(spec, sp, cfg, state, vd, wd, **kw):
        idx = [goal_index(v) for v in vd]
        f = mpc_fail[idx]
        return TR.RolloutResult(
            states=torch.as_tensor(states[idx]), actions=torch.as_tensor(actions[idx]),
            vc_goals=torch.as_tensor(vc_goals[idx]), base=None, com=None, contact_forces=None,
            contact_pos=None, in_contact=None, failed=torch.as_tensor(f >= 0),
            fail_step=torch.as_tensor(np.where(f >= 0, f, T).astype(np.int32)),
            final_state=None, mpc_usage=None)

    def t_policy(spec, sp, cfg, state, vd, wd, policy):
        idx = [goal_index(v) for v in vd]
        shift = policy(torch.zeros(1, 43), torch.zeros(1, 5))[0, 0]
        f = pol_fail[idx]
        return TR.RolloutResult(
            states=torch.as_tensor(states[idx]) + shift, actions=None, vc_goals=None, base=None,
            com=None, contact_forces=None, contact_pos=None, in_contact=None,
            failed=torch.as_tensor(f >= 0),
            fail_step=torch.as_tensor(np.where(f >= 0, f, T).astype(np.int32)),
            final_state=None, mpc_usage=None)

    class TModule:
        def __init__(self, value):
            self.value = value

        def state_dict(self):
            return {"value": self.value}

    def t_train(db, cfg, rng_seed, params=None, device="cuda"):
        calls["torch"].append((rng_seed, len(db), db.states.copy(), None if params is None
                               else float(params["value"])))
        value = torch.tensor(1e-3 * len(db), dtype=torch.float32)

        def policy(s, g):
            return value.expand(s.shape[:-1] + (12,))

        policy.module = TModule(value)
        return policy, None

    monkeypatch.setattr(TR, "rollout_mpc", t_mpc)
    monkeypatch.setattr(TR, "rollout_policy", t_policy)
    monkeypatch.setattr(PG, "train_policy", t_train)
    got = PG.run_past_goals_eval(spec, None, TR.RolloutConfig(episode_length=T), TC.q0(),
                                 np.zeros(18), goal_list, seed=3)

    for a, b in zip(calls["torch"], calls["jax"]):
        assert a[0] == b[0] and a[1] == b[1] and a[3] == pytest.approx(b[3], abs=0)
        np.testing.assert_array_equal(a[2], b[2])
    assert len(calls["torch"]) == len(calls["jax"]) == n
    _same_result(got, ref)
    assert got.forgetting() == ref.forgetting() or (np.isnan(got.forgetting())
                                                     and np.isnan(ref.forgetting()))
    upper = np.triu(np.ones((n, n), bool), 1)
    assert np.isnan(got.error_vx[upper]).all() and not got.survived[upper].any()
    assert np.isnan(got.error_vx[:, 1]).all()  # policy episode 1 failed at step 1
    db_len = [c[1] for c in calls["torch"]]
    # MPC episodes 1 and 4 fail at steps 30 and 1 (T <= 50: not appended),
    # episode 2 at step 80 (appended)
    assert db_len == [T, T, T + 80, 2 * T + 80, 2 * T + 80]


# ---- the multi-database trainer ----


def test_train_from_databases_matches_jax(tmp_path, monkeypatch):
    """Two vc snapshots written with h5py; both trainers start every policy
    from the same flax initialisation of ``rng_seed``."""
    rng = np.random.default_rng(9)
    paths = []
    for i, n in enumerate((300, 500)):
        db = Database(1000, goal_type="vc")
        states = rng.normal(size=(n, 43)).astype(np.float32)
        goals = rng.normal(size=(n, 5)).astype(np.float32)
        db.append(states, np.tanh(states[:, :12] + goals[:, :1]), vc_goals=goals)
        paths.append(str(tmp_path / f"snap_{n}.h5"))
        db.save(paths[-1])
    jcfg = JBC.BcConfig(batch_size=64, n_epoch=3, num_hidden_layer=2, hidden_dim=32)
    cfg = bc.BcConfig(**dataclasses.asdict(jcfg))

    def flax_init(generator, input_size, output_size=12, device="cpu", dtype=torch.float32,
                  **kw):
        params = JNet(output_size, kw["num_hidden_layer"], kw["hidden_dim"]).init(
            jax.random.PRNGKey(5), jnp.zeros((1, input_size)))["params"]
        return convert.policy_from_flax(jax.tree_util.tree_map(np.asarray, params), None,
                                        device, dtype)

    monkeypatch.setattr(bc, "init_policy", flax_init)
    ref = JMDB.train_from_databases(paths, cfg=jcfg, limit=1000, rng_seed=5)
    got = MDB.train_from_databases(paths, cfg=cfg, limit=1000, rng_seed=5, device="cpu")
    assert [e.label for e in got] == [e.label for e in ref] == ["snap_300", "snap_500"]
    for a, b in zip(got, ref):
        assert a.db_size == b.db_size
        np.testing.assert_allclose(a.final_train_loss, b.final_train_loss, rtol=1e-5)
        np.testing.assert_allclose(a.final_valid_loss, b.final_valid_loss, rtol=1e-5)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):  # a mesh is a parallel.mesh.Mesh
        MDB.train_from_databases(paths[:1], cfg=cfg, limit=1000, mesh=object(), device="cpu")


def test_snapshots_need_h5py(monkeypatch, tmp_path):
    """An hdf5 snapshot needs h5py (the port's .npz ones do not)."""
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    with pytest.raises(RuntimeError, match="h5py"):
        MDB.train_from_databases([str(tmp_path / "x.h5")], device="cpu")


# ---- the drivers on the CPU ----


def _f32_start(ref):
    return physics.SimState(torch.as_tensor(ref["q0"], dtype=torch.float32),
                            torch.as_tensor(ref["v0"], dtype=torch.float32))


def test_mpc_grid_runs_and_evaluates_its_records(spec, reference, monkeypatch):
    """``eval_mpc_grid`` on the plain backends (2 x 2 grid, two windows):
    one ``rollout_mpc`` call over the vx-major grid, whose records give the
    result; ``eval_policy_grid`` likewise with one ``rollout_policy`` call."""
    seen = []
    for name in ("rollout_mpc", "rollout_policy"):
        inner = getattr(TR, name)

        def spy(*a, inner=inner, **k):
            res = inner(*a, **k)
            seen.append((a, k, res))
            return res

        monkeypatch.setattr(TR, name, spy)
    sp, cfg = workload.closed_loop_sim_params(), _cfg()
    st = _f32_start(reference)
    grid = VG.eval_mpc_grid(spec, sp, cfg, st, [0.0, 0.2], [0.0, 0.1],
                            admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=30),
                            ddp_cfg=ddp.DdpConfig(n_iters=2), admm_backend="torch",
                            ik_backend="torch")
    pol = convert.policy_bundle_from_flax(**_policy_kwargs("vc", torch.float32))
    pgrid = VG.eval_policy_grid(spec, sp, cfg, st, pol, [0.0, 0.2], [0.0, 0.1])
    assert len(seen) == 2
    (a, k, res), (pa, _, pres) = seen
    np.testing.assert_array_equal(a[4].numpy(), np.float32([[0, 0, 0], [0, 0, 0], [0.2, 0, 0],
                                                            [0.2, 0, 0]]))
    np.testing.assert_array_equal(a[5].numpy(), np.float32([0, 0.1, 0, 0.1]))
    assert k["admm_backend"] == "torch" and res.states.dtype == torch.float32
    _same_result(grid, VG._evaluate(res, a[4], a[5], int(0.2 * cfg.episode_length)))
    _same_result(pgrid, VG._evaluate(pres, pa[4], pa[5], int(0.2 * cfg.episode_length)))
    assert pa[6] is pol


def _policy_kwargs(name, dtype):
    pol = dict(np.load(POLICY_REF.FIXTURE))
    return dict(params=POLICY_REF.unflat_params(pol, f"{name}/params"),
                state_mean=pol["state_mean"], state_std=pol["state_std"],
                goal_mean=pol[f"{name}/goal_mean"], goal_std=pol[f"{name}/goal_std"],
                dtype=dtype)


def test_compare_cc_replanning_runs(spec, reference, monkeypatch):
    """The three variants at B=3 x 100 steps in float64: the cc_static
    rollout reads the static goals row by row, the replanned one the goals
    ``cc_goal_fn`` computes on its recorded q, and the result is their
    tracking errors."""
    seen = []
    inner = TR.rollout_policy

    def spy(*a, **k):
        res = inner(*a, **k)
        seen.append((k.get("goal_fn"), res))
        return res

    monkeypatch.setattr(TR, "rollout_policy", spy)
    ref = reference
    vc = convert.policy_bundle_from_flax(**_policy_kwargs("vc", F64))
    cc = convert.policy_bundle_from_flax(**_policy_kwargs("cc", F64))
    st = physics.SimState(t64(ref["q0"]), t64(ref["v0"]))
    out = CCR.compare_cc_replanning(spec, workload.closed_loop_sim_params(), _cfg(), st, vc, cc,
                                    ref["v_des"], ref["w_des"])
    assert len(seen) == 3  # vc, cc_static, cc_replanned (through rollout_policy_cc)
    goals = _static_goals(spec, ref)
    np.testing.assert_array_equal(seen[1][1].vc_goals.numpy(), goals)
    sched = CCR.desired_schedules(spec, ref["q0"], ref["v0"], ref["v_des"], ref["w_des"], REF.T)
    gfn = TR.cc_goal_fn(spec.model, spec.eff_frames, t64(sched))
    rec = seen[2][1]
    q = VIS.reconstruct_q(rec)
    for k in (0, 37, 99):
        np.testing.assert_allclose(rec.vc_goals[:, k].numpy(),
                                   gfn(torch.tensor(k), t64(q[:, k])).numpy(), atol=1e-9, rtol=0)
    skip = int(0.2 * REF.T)
    for name, (_, res) in zip(("vc", "cc_static", "cc_replanned"), seen):
        v = res.states[:, skip:, 0:2].numpy()
        np.testing.assert_array_equal(
            out.vx_mse[name], np.mean((v[..., 0] - ref["v_des"][:, None, 0]) ** 2, axis=1))
        np.testing.assert_array_equal(out.survived[name], ~res.failed.numpy())
    assert set(out.summary()) == {"vc", "cc_static", "cc_replanned"}


def test_max_force_and_past_goals_run(spec, reference):
    """``max_force_search`` (two bisections over 3 directions) and
    ``run_past_goals_eval`` (2 goals, 1 BC epoch at 2 x 32) end to end on
    the plain backends in float32, 100 steps."""
    sp, cfg = workload.closed_loop_sim_params(), _cfg()
    st = _f32_start(reference)
    fast = dict(admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=30),
                ddp_cfg=ddp.DdpConfig(n_iters=2), admm_backend="torch", ik_backend="torch")
    ang = np.linspace(0, 2 * np.pi, 3, endpoint=False)
    dirs = np.stack([np.cos(ang), np.sin(ang), np.zeros(3)], -1)
    f_max, hist = MF.max_force_search(spec, sp, cfg, st, [0.1, 0.0, 0.0], 0.0, n_bisect=2,
                                      directions=dirs, push_start=40, push_duration=30, **fast)
    assert [h[0] for h in hist] == [15.0, 22.5 if hist[0][1] >= 0.5 else 7.5]
    assert all(0.0 <= h[1] <= 1.0 for h in hist) and f_max in (0.0, 7.5, 15.0, 22.5)
    goals = np.array([[0.0, 0, 0, 0], [0.2, 0, 0, 0]])
    res = PG.run_past_goals_eval(spec, sp, cfg, st.q, st.v, goals,
                                 bc_cfg=bc.BcConfig(n_epoch=1, batch_size=32, num_hidden_layer=2,
                                                    hidden_dim=32), **fast)
    assert res.error_vx.shape == (2, 2) and np.isnan(res.error_vx[0, 1])
    assert np.isfinite(res.error_vx[1]).all() or not res.survived[1].all()


# ---- visualisation ----


def test_reconstruct_q_and_strips(spec, reference, tmp_path):
    pytest.importorskip("matplotlib")
    ref = reference
    res = TR.RolloutResult(
        *(t64(ref[f"mpc/{f}"]) if ref[f"mpc/{f}"].dtype == np.float64
          else torch.as_tensor(ref[f"mpc/{f}"]) for f in REF.FIELDS[:8]),
        failed=torch.as_tensor(ref["mpc/failed"]), fail_step=torch.as_tensor(ref["mpc/fail_step"]),
        final_state=physics.SimState(t64(ref["mpc/final_q"]), t64(ref["mpc/final_v"])),
        mpc_usage=torch.ones(REF.B, REF.T, dtype=F64))
    ep = VIS.episode(res, 1)
    jres = JR.RolloutResult(**{f: ref[f"mpc/{f}"][1] for f in REF.FIELDS},
                            final_state=None, mpc_usage=np.ones(REF.T))
    np.testing.assert_array_equal(VIS.reconstruct_q(ep), JVIS.reconstruct_q(jres))
    np.testing.assert_array_equal(VIS.reconstruct_q(res)[1], JVIS.reconstruct_q(jres))
    # the reconstructed q is the rollout's state: base xy and q[2:]
    q = VIS.reconstruct_q(ep)
    np.testing.assert_allclose(q[-1, 2:], ref["mpc/states"][1, -1, 26:], atol=0)
    for fn in (VIS.rollout_strip, VIS.topdown_strip):
        path = str(tmp_path / f"{fn.__name__}.png")
        assert fn(ep, path) == path and os.path.getsize(path) > 1000
