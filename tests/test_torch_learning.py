"""The learning substrate (``bunmpc_tpu_torch/learning/``) against the JAX
package's ``bunmpc_tpu/learning/`` on the same seeded numpy inputs.

* Goals and the replay database bit for bit: command sampling, contact
  events, schedules and cc goals; the ring overwrite, the normalization,
  ``xy``, the shuffled batches and the hdf5 snapshot.
* The policy MLP with the flax parameters carried across, in float64 (atol
  1e-12), with and without BatchNorm; the Kaiming truncated-normal init.
* ``bc.train_policy`` against the JAX trainer from the same parameters and
  seed (2 x 32 hidden, 3 epochs): losses per epoch and final parameters
  within LOSS_RTOL and PARAM_ATOL (float32 on both sides), also where the
  first predictions equal the targets exactly (the L1 subgradient at zero);
  the float32-against-float64 spread of one Adam step at the BC widths,
  which ``chip_smoke.py`` phase 8b's gate is built on.
* The perturbation core (contact Jacobian, nullspace projection) on the
  same candidate draws (atol 1e-10), and stance feet kept by the sampler.
* ``ContactPlanner.get_contact_schedule`` against the JAX planner in float64.
* ``DataCollection._append_rollouts`` on one fixed set of records given to
  both packages: equal database contents.
* One port-only ``DataCollection.run_iteration`` on the plain backends.
* Entry points default to the card and refuse it on a CPU-only host.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.learning import bc as JBC
from bunmpc_tpu.learning import goals as JG
from bunmpc_tpu.learning import perturbations as JP
from bunmpc_tpu.learning.contact_planner import ContactPlanner as JPlanner
from bunmpc_tpu.learning.data_collection import DataCollection as JDataCollection
from bunmpc_tpu.learning.data_collection import DataCollectionConfig as JDcConfig
from bunmpc_tpu.learning.database import Database as JDatabase
from bunmpc_tpu.learning.networks import GoalConditionedPolicyNet as JNet
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim as j_trot_sim
from bunmpc_tpu.robots.solo12 import Solo12Config as JC
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.learning import bc, goals, networks, perturbations
from bunmpc_tpu_torch.learning import database as TDB
from bunmpc_tpu_torch.learning.contact_planner import ContactPlanner
from bunmpc_tpu_torch.learning.data_collection import DataCollection, DataCollectionConfig
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.sim import rollout as TR
from bunmpc_tpu_torch.solvers import biconvex, ddp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (phase 8b's gate)

F64 = torch.float64
EFF = tuple(TC.eff_names)
# float32 training on both sides, where the two frameworks' gradients differ
# in the last bits; measured after 27 steps: epoch losses within 3.3e-6
# relative, parameters within 8.9e-8 absolute
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def spec():
    return KD.make_cyclic_spec(TC.load_model(), trot_sim, TC.q0(), device="cpu")


def _toy(n, seed, goal_dim=12):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(n, 43)).astype(np.float32)
    g = rng.normal(size=(n, goal_dim)).astype(np.float32)
    W = rng.normal(size=(43 + goal_dim, 12)).astype(np.float32) * 0.3
    return states, g, (np.concatenate([states, g], -1) @ W).astype(np.float32)


def _gait_contacts(T, rng, chatter=0.02):
    """(T, 4) contact flags of a trot with random chatter, and positions."""
    t = np.arange(T) * 0.001
    phase = np.mod(t[:, None] + np.array([0.0, 0.5, 0.5, 0.0]) * 0.5, 0.5)
    flags = (phase <= 0.3) ^ (rng.random((T, 4)) < chatter)
    return flags, rng.normal(size=(T, 4, 3)) * 0.2


# ---- goals and database ----


def test_goals_match_jax():
    for seed in range(3):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for dist in ("uniform", "normal"):
            ref = JG.sample_velocities(a, (-0.3, 0.5), (-0.2, 0.2), (-0.3, 0.3), dist)
            got = goals.sample_velocities(b, (-0.3, 0.5), (-0.2, 0.2), (-0.3, 0.3), dist)
            np.testing.assert_array_equal(got[0], ref[0])
            assert got[1] == ref[1]
    rng = np.random.default_rng(5)
    flags, pos = _gait_contacts(1500, rng)
    ev = goals.contact_events_from_rollout(flags, pos)
    np.testing.assert_array_equal(ev, JG.contact_events_from_rollout(flags, pos))
    sched = goals.construct_contact_schedule(ev, 4)
    np.testing.assert_array_equal(sched, JG.construct_contact_schedule(ev, 4))
    com = rng.normal(size=(1500, 3))
    for gh, start in ((1, 0), (2, 0), (1, 100)):
        np.testing.assert_array_equal(
            goals.construct_cc_goal(1500, 4, sched, com, goal_horizon=gh, start_step=start),
            JG.construct_cc_goal(1500, 4, sched, com, goal_horizon=gh, start_step=start))
    steps = np.arange(0, 3000, 7)
    np.testing.assert_array_equal(goals.get_phase_percentage(steps, 0.001, 0.5),
                                  JG.get_phase_percentage(steps, 0.001, 0.5))
    v = rng.normal(size=(50, 3))
    w = rng.normal(size=50)
    assert goals.compute_vc_mse([0.1, 0.0, 0], 0.2, v, w) == JG.compute_vc_mse([0.1, 0.0, 0], 0.2,
                                                                              v, w)
    np.testing.assert_array_equal(goals.estimated_com_trajectory(com[0], v[0], 300),
                                  JG.estimated_com_trajectory(com[0], v[0], 300))
    assert goals.get_vc_gait_value("trot_sim") == JG.get_vc_gait_value("trot_sim") == 1.0


def _fill(db, chunks, goal_type):
    for states, g, actions in chunks:
        if goal_type == "vc":
            db.append(states, actions, vc_goals=g[:, :5])
        else:
            db.append(states, actions, vc_goals=g[:, :5], cc_goals=g)


@pytest.mark.parametrize("goal_type", ["vc", "cc"])
def test_database_matches_jax(goal_type, tmp_path):
    """Three appends into a 150-row ring (the third overwrites the oldest
    rows): every view, the normalization payload, xy and the shuffled
    batches are equal, and a port snapshot loads into the JAX database."""
    chunks = [_toy(n, seed) for n, seed in ((60, 0), (70, 1), (55, 2))]
    ours, theirs = TDB.Database(150, goal_type=goal_type), JDatabase(150, goal_type=goal_type)
    _fill(ours, chunks, goal_type)
    _fill(theirs, chunks, goal_type)
    assert len(ours) == len(theirs) == 150 and ours.start == theirs.start == 35
    for name in ("states", "actions", "vc_goals", "cc_goals"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.get_database_mean_std(), theirs.get_database_mean_std()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.xy(), theirs.xy()):
        np.testing.assert_array_equal(a, b)
    for (xa, ya), (xb, yb) in zip(ours.sample_batches(np.random.default_rng(3), 32, epochs=2),
                                  theirs.sample_batches(np.random.default_rng(3), 32, epochs=2)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    path = str(tmp_path / "db.hdf5")
    ours.save(path)
    loaded = JDatabase(1000, goal_type=goal_type)
    loaded.load_saved_database(path)
    for a, b in zip(loaded.xy(), ours.xy()):
        np.testing.assert_array_equal(a, b)


def test_database_snapshot_needs_h5py(monkeypatch, tmp_path):
    """An hdf5 snapshot needs h5py, imported where it is read or written
    (the card's machine has none; the port's own snapshot is .npz)."""
    db = TDB.Database(10)
    db.append(*_toy(4, 0)[:1], _toy(4, 0)[2], cc_goals=_toy(4, 0)[1])
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    with pytest.raises(RuntimeError, match="h5py"):
        db.save(str(tmp_path / "x.hdf5"))
    with pytest.raises(RuntimeError, match="h5py"):
        db.load_saved_database(str(tmp_path / "x.hdf5"))


# ---- the policy network ----


@pytest.mark.parametrize("batch_norm", [False, True])
def test_mlp_forward_matches_flax(batch_norm):
    rng = np.random.default_rng(6)
    jnet = JNet(output_size=12, num_hidden_layer=3, hidden_dim=64, batch_norm=batch_norm)
    x = rng.normal(size=(16, 55))
    variables = jnet.init(jax.random.PRNGKey(2), jnp.zeros((1, 55)))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables["params"])
    stats = None
    if batch_norm:  # a trained net's running statistics and affine parameters
        stats = {k: {"mean": rng.normal(size=64) * 0.3, "var": rng.uniform(0.5, 2.0, 64)}
                 for k in variables["batch_stats"]}
        for k in stats:
            params[k] = {"scale": rng.uniform(0.5, 1.5, 64), "bias": rng.normal(size=64) * 0.1}
    ref = jnet.apply({"params": params, **({"batch_stats": stats} if stats else {})}, x)
    module = convert.policy_from_flax(params, stats)
    assert isinstance(module, networks.GoalConditionedPolicyNet)
    got = module(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-12, rtol=0)


def test_init_is_flax_kaiming_truncated_normal():
    """Both inits draw a unit normal truncated to (-2, 2) scaled to std
    sqrt(2 / fan_in): the port's first kernel (512 x 55) and the flax one
    have the same scale, bound and quantiles (to sampling error)."""
    module = networks.init_policy(torch.Generator().manual_seed(0), 55, num_hidden_layer=3,
                                  hidden_dim=512)
    ours = module.dense[0].weight.detach().numpy().ravel()
    flax_params = JNet(12, 3, 512).init(jax.random.PRNGKey(0), jnp.zeros((1, 55)))["params"]
    theirs = np.asarray(flax_params["Dense_0"]["kernel"]).ravel()
    scale = np.sqrt(2.0 / 55)
    for w in (ours, theirs):
        assert abs(w.std() / scale - 1.0) < 0.02
        assert np.abs(w).max() <= 2.0 * scale / 0.87962566103423978 + 1e-6
    qs = [0.05, 0.25, 0.5, 0.75, 0.95]
    np.testing.assert_allclose(np.quantile(ours, qs), np.quantile(theirs, qs), atol=0.02 * scale)
    for layer in module.dense:
        assert not layer.bias.detach().any()
    assert module.dense[-1].weight.shape == (12, 512)


# ---- BC ----


def _bc_case(exact_zero: bool):
    """A cc database and starting flax params: a linear teacher, or (exact
    zero) zero targets with a zero head, so the first predictions equal the
    targets exactly."""
    states, g, actions = _toy(640, 7)
    if exact_zero:
        actions = np.zeros_like(actions)
    dbs = []
    for cls in (TDB.Database, JDatabase):
        db = cls(1000, goal_type="cc")
        db.append(states, actions, vc_goals=g[:, :5], cc_goals=g)
        dbs.append(db)
    params = JNet(12, 2, 32).init(jax.random.PRNGKey(3), jnp.zeros((1, 55)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    if exact_zero:
        params["Dense_2"] = {k: np.zeros_like(v) for k, v in params["Dense_2"].items()}
    return dbs, params


@pytest.mark.parametrize("exact_zero", [False, True])
def test_train_policy_matches_jax(exact_zero):
    (ours_db, theirs_db), params = _bc_case(exact_zero)
    jcfg = JBC.BcConfig(batch_size=64, n_epoch=3, num_hidden_layer=2, hidden_dim=32)
    cfg = bc.BcConfig(**dataclasses.asdict(jcfg))
    jbundle, jrep = JBC.train_policy(theirs_db, jcfg, rng_seed=4, params=params)
    bundle, rep = bc.train_policy(ours_db, cfg, rng_seed=4,
                                  params=convert.policy_params_from_flax(params), device="cpu")
    np.testing.assert_allclose(rep.train_losses, jrep.train_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(rep.valid_losses, jrep.valid_losses, rtol=LOSS_RTOL)
    ref = convert.policy_params_from_flax(jax.tree_util.tree_map(np.asarray, jbundle.params))
    got = bundle.module.state_dict()
    for k, a in ref.items():
        np.testing.assert_allclose(got[k].numpy(), a.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=k)
    if exact_zero:  # the zero head moved: the L1 subgradient at zero is +1, not 0
        assert (got["dense.2.bias"] != 0).all()
    for a, b in ((bundle.state_mean, jbundle.state_mean), (bundle.goal_std, jbundle.goal_std)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_l1_subgradient_at_zero_is_jax_s():
    d = torch.zeros(3, requires_grad=True)
    bc.loss_fn(d, torch.zeros(3)).backward()
    assert float(jax.grad(jnp.abs)(0.0)) == 1.0
    np.testing.assert_array_equal(d.grad.numpy(), np.full(3, 1.0 / 3, np.float32))


def test_adam_step_f32_spread_is_inside_the_card_gate():
    """One Adam step at the BC widths (3 x 512) from a net trained 3 epochs
    on a tanh teacher, float32 against float64 from the same parameters, on
    three batches: chip_smoke.py phase 8b holds the card's step against the
    CPU's within ADAM_Q_TOL (the 0.999-quantile of |d| over the parameters)
    and ADAM_MAX_TOL (the max), each at least 3x this spread. The max has a
    heavy tail: a gradient that cancels to ~eps makes Adam's normalised step
    sensitive to rounding (over six such datasets it ranged 5.5e-6..1.1e-4,
    the quantile 1.4e-8..1.5e-8)."""
    rng = np.random.default_rng(0)
    s = rng.normal(size=(4000, 43)).astype(np.float32)
    g = rng.normal(size=(4000, 12)).astype(np.float32)
    W = rng.normal(size=(55, 12)).astype(np.float32) * 0.3
    db = TDB.Database(10_000)
    db.append(s, np.tanh(np.concatenate([s, g], -1) @ W).astype(np.float32), cc_goals=g)
    bundle, _ = bc.train_policy(db, bc.BcConfig(n_epoch=3), device="cpu")
    sd = bundle.module.state_dict()
    x, y = db.xy()
    q, mx = 0.0, 0.0
    for lo in (0, 256, 512):
        out = {}
        for dt in (torch.float32, F64):
            net = networks.GoalConditionedPolicyNet(55, 12, 3, 512).to(dtype=dt)
            net.load_state_dict(sd)
            bc.train_step(net, bc.make_optimizer(net, 2e-3),
                          torch.as_tensor(x[lo:lo + 256], dtype=dt),
                          torch.as_tensor(y[lo:lo + 256], dtype=dt))
            out[dt] = net.state_dict()
        d = torch.cat([(out[torch.float32][k].double() - out[F64][k]).abs().flatten() for k in sd])
        q, mx = max(q, float(np.quantile(d.numpy(), 0.999))), max(mx, float(d.max()))
    print(f"one Adam step f32 vs f64: params |d| q0.999 {q:.3e}, max {mx:.3e}; card gates "
          f"{chip_smoke.ADAM_Q_TOL:.1e}, {chip_smoke.ADAM_MAX_TOL:.1e}")
    assert 0.0 < q and 3.0 * q <= chip_smoke.ADAM_Q_TOL
    assert 0.0 < mx and 3.0 * mx <= chip_smoke.ADAM_MAX_TOL


# ---- perturbations ----


def test_perturbation_core_matches_jax():
    jm, tm = JC.load_model(), TC.load_model()
    rng = np.random.default_rng(8)
    B, K = 4, 5
    q = np.tile(JC.q0(), (B, 1))
    q[:, 7:] += rng.normal(size=(B, 12)) * 0.1
    flags = np.array([[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0], [0, 0, 0, 0]], np.float64)
    vec = rng.normal(size=(B, K, 18))
    Jc = perturbations.contact_jacobian(tm, EFF, torch.as_tensor(q), torch.as_tensor(flags))
    proj = perturbations.nullspace_project(Jc, torch.as_tensor(vec)).numpy()
    for b in range(B):
        Jref = np.asarray(JP.contact_jacobian(jm, EFF, q[b], flags[b]))
        np.testing.assert_allclose(Jc[b].numpy(), Jref, atol=1e-10, rtol=0)
        for k in range(K):
            ref = np.asarray(JP.nullspace_project(Jref, vec[b, k]))
            np.testing.assert_allclose(proj[b, k], ref, atol=1e-10, rtol=0)
    # the projection keeps the stance rows still to first order
    moved = np.einsum("bmn,bkn->bkm", Jc.numpy(), proj)
    assert np.abs(moved).max() < 1e-10


def test_nullspace_perturbation_keeps_stance_feet():
    """Nullspace-projected perturbations must not move feet in contact
    (data_collection.py:243-247), for a whole batch in one draw."""
    model = TC.load_model()
    B = 4
    q0 = torch.as_tensor(np.tile(TC.q0(), (B, 1)))
    gen = torch.Generator().manual_seed(0)
    q_p, v_p, ok = perturbations.sample_perturbed_state(
        model, EFF, gen, q0, torch.zeros(B, 18, dtype=F64), torch.ones(B, 4, dtype=F64))
    assert bool(ok.all())
    from bunmpc_tpu_torch.kin import algorithms as K

    feet0 = K.frame_positions(model, q0, EFF).numpy()
    feet1 = K.frame_positions(model, q_p, EFF).numpy()
    # feet stay close (first-order nullspace projection on a nonlinear map)
    assert np.abs(feet1 - feet0).max() < 0.03
    # but every configuration did change, each differently
    assert (np.abs((q_p - q0).numpy()).max(axis=1) > 0.01).all()
    assert np.abs(np.diff(q_p.numpy(), axis=0)).max() > 0.01
    assert v_p.abs().max() > 0.01


# ---- contact planner ----


def test_contact_schedule_matches_jax(spec):
    """Three episodes planned in one call against the JAX planner per
    episode in float64: the plans equal, each foot's touchdowns equal the
    JAX schedule's rows of that foot, and the rows past a foot's last
    touchdown repeat it (the JAX schedule leaves zero rows there)."""
    jspec = JKD.make_cyclic_spec(JC.load_model(), j_trot_sim, JC.q0())
    rng = np.random.default_rng(9)
    B = 3
    q0 = np.tile(JC.q0(), (B, 1))
    q0[:, 7:] += rng.normal(size=(B, 12)) * 0.05
    q0[:, 0:2] += rng.normal(size=(B, 2)) * 0.1
    v_des = np.stack([rng.uniform(0, 0.3, B), rng.uniform(-0.1, 0.1, B), np.zeros(B)], -1)
    w_des = rng.uniform(-0.3, 0.3, B)
    for T, start in ((100, 0.0), (300, 0.12)):
        sched, plan = ContactPlanner(spec).get_contact_schedule(q0, None, v_des, w_des, T, start)
        for b in range(B):
            jsched, jplan = JPlanner(jspec).get_contact_schedule(q0[b], None, v_des[b], w_des[b],
                                                                 T, start)
            np.testing.assert_allclose(plan[b], jplan, atol=1e-12, rtol=0)
            for ee in range(4):
                n = int((jsched[ee, :, 0] != 0).sum())
                np.testing.assert_allclose(sched[b, ee, :n], jsched[ee, :n], atol=1e-12, rtol=0)
                assert (sched[b, ee, n:] == sched[b, ee, n - 1]).all()
                assert (jsched[ee, n:] == 0).all()


# ---- data collection ----


def _records(rng, B=3, T=600):
    """Fixed closed-loop records (numpy) for both packages' _append_rollouts;
    episode 1 failed."""
    flags, pos = zip(*(_gait_contacts(T, rng) for _ in range(B)))
    return TR.RolloutResult(
        states=rng.normal(size=(B, T, 43)).astype(np.float32),
        actions=rng.normal(size=(B, T, 12)).astype(np.float32),
        vc_goals=rng.normal(size=(B, T, 5)).astype(np.float32),
        base=None, com=np.cumsum(rng.normal(size=(B, T, 3)) * 1e-3, axis=1),
        contact_forces=None, contact_pos=np.stack(pos), in_contact=np.stack(flags),
        failed=np.array([False, True, False]), fail_step=None, final_state=None,
        mpc_usage=None)


def test_append_rollouts_matches_jax(spec):
    jspec = JKD.make_cyclic_spec(JC.load_model(), j_trot_sim, JC.q0())
    res = _records(np.random.default_rng(10))
    kw = dict(episode_length=600, database_size=5000)
    ours = DataCollection(spec, DataCollectionConfig(**kw))
    theirs = JDataCollection(jspec, JDcConfig(**kw))
    added = ours._append_rollouts(res)
    assert added == theirs._append_rollouts(res, None, None, None) > 0
    assert len(ours.database) == len(theirs.database) == added
    for name in ("states", "actions", "vc_goals", "cc_goals"):
        np.testing.assert_array_equal(getattr(ours.database, name),
                                      getattr(theirs.database, name))


def test_data_collection_iteration_runs(spec):
    """One iteration at episode_length=100 on the plain backends with a
    cut-down solver (tests/test_drivers.py's FAST_ADMM/FAST_DDP): a benchmark
    rollout and 2 replanning points x 2 perturbations; every appended row is
    a record of a live episode with a cc goal of the documented layout."""
    cfg = DataCollectionConfig(episode_length=100, num_perturbations_per_replanning=2,
                               vx_range=(0.0, 0.3), vy_range=(0.0, 0.0), w_range=(0.0, 0.0))
    dc = DataCollection(spec, cfg, sim_params=workload.closed_loop_sim_params(),
                        admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=40),
                        ddp_cfg=ddp.DdpConfig(n_iters=3, alphas=(1.0, 0.5, 0.1)),
                        admm_backend="torch", ik_backend="torch")
    calls = []
    rollout_mpc = TR.rollout_mpc

    def spy(*a, **k):
        calls.append(rollout_mpc(*a, **k))
        return calls[-1]

    TR.rollout_mpc = spy
    try:
        st = workload.settled_start(1, device="cpu")
        log = dc.run_iteration(st.q[0], st.v[0])
    finally:
        TR.rollout_mpc = rollout_mpc
    assert [c.states.shape[0] for c in calls] == [1, 4]
    assert log["datapoints_added"] == log["database_size"] == len(dc.database) > 0
    cc = dc.database.cc_goals
    assert cc.shape == (len(dc.database), 12) and (cc[:, 0::3] >= 0).all()
    # the rows are the live episodes' records from step 0 up to the earliest
    # of the feet's last touchdowns (the cc goal's end), episode by episode
    rows = [c.states[b, :cc_length(c.in_contact[b].numpy())].numpy()
            for c in calls for b in range(c.states.shape[0]) if not bool(c.failed[b])]
    np.testing.assert_array_equal(dc.database.states, np.concatenate(rows))


def cc_length(in_contact):
    """Rows a live episode adds: the step of the earliest of its feet's last
    touchdowns (0 where a foot never touches down)."""
    td = in_contact[1:] & ~in_contact[:-1]
    return min(int(np.nonzero(td[:, ee])[0].max()) + 1 if td[:, ee].any() else 0
               for ee in range(td.shape[1]))


def test_entry_points_default_to_the_card(spec):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal applies to CPU-only hosts")
    db = TDB.Database(100)
    db.append(*_toy(40, 0)[:1], _toy(40, 0)[2], cc_goals=_toy(40, 0)[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        bc.train_policy(db, bc.BcConfig(n_epoch=1, batch_size=8))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):  # a mesh is a parallel.mesh.Mesh
        bc.train_policy(db, mesh=object(), device="cpu")
    gpu_spec = dataclasses.replace(spec, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        DataCollection(gpu_spec)
