"""The DAgger family (``bunmpc_tpu_torch/sim/rollout.py``: ``state_is_dangerous``,
``rollout_safedagger``, ``rollout_dagger``, per-episode start times in
``rollout_mpc`` and ``rollout_policy``; ``bunmpc_tpu_torch/learning/``:
``bayes``, ``gp_bo``, ``dagger``) against the JAX package on the same seeded
numpy inputs.

* Three episodes of 100 steps in float64, each with its own start time, on
  the plain backends, against the JAX package's ``vmap`` of
  ``rollout_safedagger`` (one episode starts past the danger box: a
  takeover and a release), ``rollout_dagger`` (the JAX coins injected),
  ``rollout_mpc`` (the default carry) and ``rollout_policy``
  (tests/torch_dagger_reference.py, the fixture
  tests/fixtures/torch_gated_rollout_solo12_trot_sim.npz): every record,
  ``mpc_usage`` included, within atol 1e-9, flags and failure steps equal.
  Two of the fixture's window clocks (0.35 s and 1.15 s) lie one ulp below
  the JAX package's (its jitted round, ROADMAP "Faults found"), where the
  contact plan is discontinuous: a test says so and holds those windows'
  plans against the JAX package's eager semantics, and the records are
  compared in full on the JAX package's clocks.
* ``state_is_dangerous`` on seeded states around every edge of the box.
* ``bayes``, ``gp_bo``, ``weighted_vc_error``, ``select_rollout`` and the
  drivers' ``_aggregate`` (every flag) against the JAX functions on the same
  numpy inputs: identical.
* ``_perturbed_starts``: the candidates, start times and commands the JAX
  driver picks with the same numpy seed, and with zero sigmas the same
  states.
* The window clock with per-episode start times; the refusals
  (checkpoint and resume, the default device on a CPU-only host, a start
  time of the wrong shape).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dagger_reference as REF
import torch_learning_reference as POLICY_REF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
import torch_rollout_reference as ROLLOUT_REF
from bunmpc_tpu.learning import bayes as JB
from bunmpc_tpu.learning import dagger as JD
from bunmpc_tpu.learning import gp_bo as JGP
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot_sim as j_trot_sim
from bunmpc_tpu.robots.solo12 import Solo12Config as JC
from bunmpc_tpu.sim import rollout as JR
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.learning import bayes, bc, dagger, goals, gp_bo, networks, perturbations
from bunmpc_tpu_torch.learning.database import Database
from bunmpc_tpu_torch.mpc import gait as TG
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.sim import physics
from bunmpc_tpu_torch.sim import rollout as TR
from bunmpc_tpu_torch.solvers import biconvex, ddp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (phase 9d's gates)

F64 = torch.float64


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


@pytest.fixture(scope="module")
def spec():
    return KD.make_cyclic_spec(TC.load_model(), trot_sim, TC.q0(), device="cpu")


@pytest.fixture(scope="module")
def jspec():
    return JKD.make_cyclic_spec(JC.load_model(), j_trot_sim, JC.q0())


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


# ---- the rollouts against the JAX fixture ----


def port_window_clocks(start_times, n_windows):
    st = t64(start_times)
    return np.stack([KD.window_clock(st, w, 0.05, st).numpy() for w in range(n_windows)], 1)


# (episode, window) of the fixture where the port's clock (numpy's round, the
# reference's) lies one ulp below the JAX package's: 0.35 and 1.15 s
OFF_CLOCK = [(1, 0), (2, 1)]


def test_window_clocks_against_the_jax_package(spec, jspec, reference):
    """At two of the fixture's six window clocks, 0.35 s (episode 1, window
    0) and 1.15 s (episode 2, window 1), the port's clock, numpy's round of
    the start time plus the window, lies one ulp below the JAX package's,
    whose jitted round multiplies by a rounded reciprocal: just below the
    knot at 7 and 23 x 0.05 s, where the JAX package's lies just above it.
    The contact plan is discontinuous there (a swing foot's target moves by
    over a millimetre), so the records of those episodes part from the
    fixture from that window on. At each such window the port's plan, on
    the fixture's state at the window's start and the port's clock, is the
    JAX package's own eager ``_prepare_problem`` at that clock (as
    tests/test_torch_prep.py holds it), and differs from the plan at the
    JAX package's clock; ``test_rollout_matches_jax`` runs the whole
    fixture again on the JAX package's clocks."""
    ours = port_window_clocks(REF.START_TIMES, REF.T // 50)
    np.testing.assert_array_equal(reference["jax_clocks"],
                                  REF.jax_window_clocks(REF.START_TIMES, REF.T // 50))
    theirs = reference["jax_clocks"]
    np.testing.assert_array_equal(ours, np.round(REF.START_TIMES[:, None]
                                                 + np.arange(REF.T // 50) * 0.05, 3))
    off = list(zip(*np.nonzero(ours != theirs)))
    assert off == OFF_CLOCK
    for b, w in off:
        assert theirs[b, w] == np.nextafter(ours[b, w], np.inf)
        f = reference["mpc/states"][b, w * 50]  # features [v, base_wrt_foot, q[2:]]
        args = (np.concatenate([[0.0, 0.0], f[26:]])[None], f[None, :18], ours[b, w:w + 1],
                reference["v_des"][b:b + 1], reference["w_des"][b:b + 1])
        jp = jax.vmap(lambda *a: JKD._prepare_problem(jspec, *a))(*map(jnp.asarray, args))
        tp = KD._prepare_problem(spec, *map(t64, args))
        np.testing.assert_array_equal(tp["plan"].cnt.numpy(), np.asarray(jp["plan"].cnt))
        for name in ("r", "dt"):
            np.testing.assert_allclose(getattr(tp["plan"], name).numpy(),
                                       np.asarray(getattr(jp["plan"], name)), atol=1e-9, rtol=0)
        for key in ("x_init", "W", "X_ref", "W_F", "X_wm", "F_wm"):
            np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), atol=1e-9, rtol=0)
        at_jax_clock = KD._prepare_problem(spec, *map(t64, args[:2]), t64([theirs[b, w]]),
                                           *map(t64, args[3:]))
        assert float((at_jax_clock["plan"].r - tp["plan"].r).abs().max()) > 1e-3


_PER_EPISODE = ("failed", "fail_step", "final_q", "final_v")


def _compare(got, ref, variant, steps):
    """Every record of episode b up to step ``steps[b]``, its failure and
    end state where that is the episode's end."""
    for f, a in got.items():
        r = ref[f"{variant}/{f}"]
        assert a.shape == r.shape, f
        for b, n in enumerate(steps):
            if f in _PER_EPISODE and n < REF.T:
                continue
            x, y = (a[b], r[b]) if f in _PER_EPISODE else (a[b, :n], r[b, :n])
            if a.dtype.kind in "bi":
                np.testing.assert_array_equal(x, y, err_msg=f"{f}, episode {b}")
            else:
                np.testing.assert_allclose(x, y, atol=1e-9, rtol=0, err_msg=f"{f}, episode {b}")


@pytest.mark.parametrize("variant", REF.VARIANTS)
def test_rollout_matches_jax(spec, reference, variant, monkeypatch):
    """The port against the fixture on the JAX package's clocks, every
    record of every step; the MPC rollout also on the port's own clocks, up
    to each episode's first window off the JAX package's clock
    (``OFF_CLOCK``). The gated variants run their off-clock episodes under
    the policy, whose plans go unused, and the policy rollout has no
    clock."""
    ref = reference
    B = REF.B
    q0 = ref["q_tilt"] if variant == "safedagger" else np.tile(ref["q0"], (B, 1))
    state0 = physics.SimState(q=t64(q0), v=t64(ref["v0"]).expand(B, -1).contiguous())
    pol = dict(np.load(POLICY_REF.FIXTURE))
    bundle = convert.policy_bundle_from_flax(
        POLICY_REF.unflat_params(pol, "vc/params"), pol["state_mean"], pol["state_std"],
        pol["vc/goal_mean"], pol["vc/goal_std"])
    cfg = TR.RolloutConfig(episode_length=REF.T, kp=trot_sim.kp, kd=trot_sim.kd,
                           gait_period=trot_sim.gait_period)
    args = (spec, workload.closed_loop_sim_params(), cfg, state0, t64(ref["v_des"]),
            t64(ref["w_des"]))
    st = t64(ref["start_times"])
    solver = dict(admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=60),
                  ddp_cfg=ddp.DdpConfig(n_iters=4), admm_backend="torch", ik_backend="torch")

    def run():
        if variant == "safedagger":
            res = TR.rollout_safedagger(*args, bundle, num_steps_to_block=REF.NUM_STEPS_TO_BLOCK,
                                        start_time=st, **solver)
        elif variant == "dagger":
            res = TR.rollout_dagger(*args, bundle, coins=torch.as_tensor(ref["dagger/coins"]),
                                    start_time=st, **solver)
        elif variant == "mpc":
            res = TR.rollout_mpc(*args, start_time=st, **solver)
        else:
            res = TR.rollout_policy(*args, bundle, start_time=st)
        got = {f: getattr(res, f).numpy() for f in REF.FIELDS}
        got["final_q"], got["final_v"] = res.final_state.q.numpy(), res.final_state.v.numpy()
        assert not got["failed"].any()
        return got

    if variant == "mpc":
        steps = [REF.T] * B
        for b, w in OFF_CLOCK:
            steps[b] = min(steps[b], 50 * w)
        _compare(run(), ref, variant, steps)
    clocks = ref["jax_clocks"]
    monkeypatch.setattr(KD, "window_clock",
                        lambda start_time, w, plan_freq, like: t64(clocks[:, w]))
    got = run()
    _compare(got, ref, variant, [REF.T] * B)
    usage = got["mpc_usage"]
    if variant == "safedagger":  # a takeover at step 0 and a release
        assert usage[0, 0] == 1 and usage[0, -1] == 0 and not usage[1:].any()
    elif variant == "dagger":  # constant within each window, the coins
        np.testing.assert_array_equal(usage, np.repeat(ref["dagger/coins"], 50, axis=1))
        assert usage.any() and not usage.all()


def test_state_is_dangerous_matches_jax():
    """Seeded states on both sides of every edge of the safety box: height,
    roll, pitch and each joint's limits (the HAA boxes differ left and
    right)."""
    rng = np.random.default_rng(7)
    n = 400
    q = np.tile(JC.q0(), (n, 1))
    q[:, 2] = rng.uniform(0.1, 1.05, n)
    ang = rng.uniform(-0.6, 0.6, (n, 2)) * (rng.random((n, 1)) < 0.5)
    for i in range(n):
        r, p = ang[i]
        q[i, 3:7] = [np.sin(r / 2) * np.cos(p / 2), np.cos(r / 2) * np.sin(p / 2),
                     -np.sin(r / 2) * np.sin(p / 2), np.cos(r / 2) * np.cos(p / 2)]
    lo = np.array([-0.8, -2.0, -3.0, -1.5, -2.0, -3.0] * 2)
    hi = np.array([1.5, 2.0, 3.0, 0.8, 2.0, 3.0] * 2)
    j = rng.integers(0, 12, n)
    edge = np.where(rng.random(n) < 0.5, lo[j], hi[j]) + rng.normal(size=n) * 0.05
    q[np.arange(n), 7 + j] = np.where(rng.random(n) < 0.7, edge, q[np.arange(n), 7 + j])
    ref = np.asarray(jax.vmap(JR.state_is_dangerous)(jnp.asarray(q)))
    got = TR.state_is_dangerous(t64(q)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.2 < ref.mean() < 0.9


def test_window_clock_takes_per_episode_start_times():
    like = torch.zeros((), dtype=F64)
    st = t64([0.05, 0.35, 1.1, 0.048])
    for w in (0, 1, 37):
        got = KD.window_clock(st, w, 0.05, like)
        ref = np.round(st.numpy() + w * 0.05 * 1.0, 3)
        np.testing.assert_array_equal(got.numpy(), ref)
        for b in range(4):
            assert got[b].item() == KD.window_clock(float(st[b]), w, 0.05, like).item()


def test_start_time_of_the_wrong_shape_raises(spec):
    st = physics.SimState(t64(np.tile(TC.q0(), (2, 1))), torch.zeros(2, 18, dtype=F64))
    cfg = TR.RolloutConfig(episode_length=50)
    with pytest.raises(ValueError, match="start_time"):
        TR.rollout_policy(spec, workload.closed_loop_sim_params(), cfg, st,
                          torch.zeros(2, 3, dtype=F64), torch.zeros(2, dtype=F64),
                          lambda s, g: s[:, :12], start_time=torch.zeros(3, dtype=F64))


# ---- bayes, gp_bo ----


def test_bayes_matches_jax():
    grid = bayes.GoalGrid.make((-0.3, 0.5), (-0.2, 0.2), (-0.3, 0.3), n=12)
    jgrid = JB.GoalGrid.make((-0.3, 0.5), (-0.2, 0.2), (-0.3, 0.3), n=12)
    assert grid.shape == jgrid.shape
    post, jpost = grid.uniform_prior(), jgrid.uniform_prior()
    np.testing.assert_array_equal(post, jpost)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for it in range(6):
        goal = bayes.random_sample_from_distribution(rng, grid, post)
        np.testing.assert_array_equal(goal, JB.random_sample_from_distribution(jrng, jgrid, jpost))
        error = None if it % 2 == 0 else 0.3 * it
        like = bayes.compute_likelihood(grid, goal, error=error)
        np.testing.assert_array_equal(like, JB.compute_likelihood(jgrid, goal, error=error))
        invert = it == 3
        post = bayes.update_goal_distribution(post, like, invert=invert)
        jpost = JB.update_goal_distribution(jpost, like, invert=invert)
        np.testing.assert_array_equal(post, jpost)
    assert abs(post.sum() - 1.0) < 1e-12
    # a goal far outside the grid: the likelihood underflows to the uniform
    far = bayes.compute_likelihood(grid, np.array([50.0, 0.0, 0.0]), sigma=0.01)
    np.testing.assert_array_equal(far, JB.compute_likelihood(jgrid, np.array([50.0, 0.0, 0.0]),
                                                             sigma=0.01))


def test_gp_bo_matches_jax():
    def objective(x):
        return float((x[0] - 0.2) ** 2 + 0.5 * (x[1] + 0.1) ** 2)

    bounds = [(-0.3, 0.5), (-0.3, 0.3)]
    x, y = gp_bo.gp_minimize(objective, bounds, n_calls=6, seed=2)
    jx, jy = JGP.gp_minimize(objective, bounds, n_calls=6, seed=2)
    np.testing.assert_array_equal(x, jx)
    assert y == jy
    opt = gp_bo.GpLcbOptimizer(bounds=np.asarray(bounds), seed=5)
    jopt = JGP.GpLcbOptimizer(bounds=np.asarray(bounds), seed=5)
    for _ in range(5):
        a, b = opt.ask(), jopt.ask()
        np.testing.assert_array_equal(a, b)
        opt.tell(a, objective(a))
        jopt.tell(b, objective(b))
    xq = np.array([[0.1, 0.0], [0.4, -0.2]])
    for got, ref in zip(opt._gp_posterior(xq), jopt._gp_posterior(xq)):
        np.testing.assert_array_equal(got, ref)


# ---- the drivers' host-side rules ----


def _records(rng, B=4, T=600, usage=None):
    """Host records of B episodes: episode 1 failed at 300 (a prefix of 50
    < 100 rows), episode 2 at 520 (a prefix of 270), the others live."""
    failed = np.array([False, True, True, False][:B])
    fail_step = np.array([T, 300, 520, T][:B], np.int32)
    if usage is None:
        usage = (rng.random((B, T)) < 0.4).astype(np.float32)
        usage[3] = 0.0
    return TR.RolloutResult(
        states=rng.normal(size=(B, T, 43)).astype(np.float32),
        actions=rng.normal(size=(B, T, 12)).astype(np.float32),
        vc_goals=rng.normal(size=(B, T, 5)).astype(np.float32),
        base=None, com=None, contact_forces=None, contact_pos=None, in_contact=None,
        failed=failed, fail_step=fail_step, final_state=None, mpc_usage=usage)


def _drivers(spec, jspec, **cfg_kw):
    kw = dict(episode_length=600, database_size=20_000, **cfg_kw)
    ours = dagger.SafeDagger(spec, dagger.DaggerConfig(**kw), seed=4, admm_backend="torch",
                             ik_backend="torch")
    theirs = JD.SafeDagger(jspec, JD.DaggerConfig(**kw), seed=4)
    return ours, theirs


@pytest.mark.parametrize("skip_failed", [None, False, True])
@pytest.mark.parametrize("expert_only", [True, False])
def test_aggregate_matches_jax(spec, jspec, expert_only, skip_failed):
    ours, theirs = _drivers(spec, jspec, skip_failed_episodes=True)
    rng = np.random.default_rng(11)
    for keep in (None, np.array([True, True, False, True])):
        res = _records(rng)
        kw = dict(expert_only=expert_only, keep=keep, skip_failed=skip_failed)
        added = ours._aggregate(res, **kw)
        assert added == theirs._aggregate(res, **kw)
    assert len(ours.database) == len(theirs.database) > 0
    for name in ("states", "actions", "vc_goals"):
        np.testing.assert_array_equal(getattr(ours.database, name),
                                      getattr(theirs.database, name))


def test_weighted_vc_error_and_select_rollout_match_jax(spec, jspec):
    rng = np.random.default_rng(12)
    a, b = _records(rng), _records(rng)
    v_des, w_des = np.array([0.2, -0.05, 0.0]), 0.1
    fail_step = a.fail_step.copy()
    fail_step[2] = 1  # a prefix under two steps counts as an infinite error
    args = (a.states, fail_step, a.failed, v_des, w_des)
    assert dagger.weighted_vc_error(*args) == JD.weighted_vc_error(*args) == np.inf
    args = (a.states, a.fail_step, a.failed, v_des, w_des)
    assert dagger.weighted_vc_error(*args) == JD.weighted_vc_error(*args)
    ours = dagger.LocoSafeDagger(spec, dagger.DaggerConfig(), admm_backend="torch",
                                 ik_backend="torch", grid_n=5)
    theirs = JD.LocoSafeDagger(jspec, JD.DaggerConfig(), grid_n=5)
    np.testing.assert_array_equal(ours.posterior, np.asarray(theirs.posterior))
    for x, y in ((a, b), (b, a)):
        got = ours.select_rollout(x, y, v_des, w_des)
        assert got == theirs.select_rollout(x, y, v_des, w_des)
    assert {ours.select_rollout(a, b, v_des, w_des)[0],
            ours.select_rollout(b, a, v_des, w_des)[0]} == {"mpc", "policy"}


@pytest.mark.parametrize("sample_replans", [True, False])
def test_perturbed_starts_match_jax(spec, jspec, sample_replans):
    """The same candidates (episode, replanning point), start times and
    commands as the JAX driver with the same numpy seed, and the same numpy
    draws after; with zero sigmas both give the nominal state of each
    candidate, so the rows are the same candidates' states."""
    zero = dict(sigma_base_pos=0.0, sigma_base_ori=0.0, sigma_joint_pos=0.0, sigma_vel=0.0)
    ours, theirs = _drivers(spec, jspec, **zero)
    rng = np.random.default_rng(13)
    T = 300  # 6 windows: 6 candidate points an episode
    st0 = np.asarray(JR.state_features(JC.load_model(), tuple(JC.eff_names), JC.q0(),
                                       np.zeros(18)))
    states = (st0 + rng.normal(size=(3, T, 43)) * 1e-3).astype(np.float32)
    res = TR.RolloutResult(states=states, actions=None, vc_goals=None, base=None, com=None,
                           contact_forces=None, contact_pos=None, in_contact=None,
                           failed=np.array([False, True, True]),
                           fail_step=np.array([T, 120, 299], np.int32), final_state=None,
                           mpc_usage=None)
    vds = rng.uniform(-0.3, 0.5, (3, 3))
    wds = rng.uniform(-0.3, 0.3, 3)
    quota = 7
    got = ours._perturbed_starts(res, vds, wds, quota, sample_replans)
    ref = theirs._perturbed_starts(res, jnp.asarray(vds, jnp.float32),
                                   jnp.asarray(wds, jnp.float32), quota, sample_replans)
    for a, r in zip((got.st, got.v_des, got.w_des), ref[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    # episode 1 fell inside the first gait cycle: no candidate of it
    assert not np.isin(got.v_des.numpy()[:, 0], np.float32(vds[1, 0])).any()
    np.testing.assert_allclose(got.q.numpy(), np.asarray(ref[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(ref[1]), atol=1e-6, rtol=0)
    assert ours.rng.integers(1 << 31) == theirs.rng.integers(1 << 31)
    failed_all = res._replace(failed=np.array([True, True, True]),
                              fail_step=np.array([10, 120, 240], np.int32))
    assert ours._perturbed_starts(failed_all, vds, wds, quota, sample_replans) is None


# ---- refusals ----


def test_checkpoint_and_resume_raise(spec):
    drv = dagger.SafeDagger(spec, admm_backend="torch", ik_backend="torch")
    for kw in (dict(checkpoint_dir="ckpt"), dict(resume=True)):
        with pytest.raises(NotImplementedError, match="item 9"):
            drv.run(TC.q0(), np.zeros(18), **kw)


def test_drivers_default_to_the_card(spec):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal applies to CPU-only hosts")
    gpu_spec = dataclasses.replace(spec, device=torch.device("cuda"))
    for cls in (dagger.Dagger, dagger.SafeDagger, dagger.LocoSafeDagger):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(gpu_spec)


@pytest.mark.slow
def test_fixture_is_the_jax_gated_rollout():
    """The committed reference is what the JAX package computes today
    (~10 min: four traces and compiles of a JAX rollout)."""
    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)


def test_one_gated_window_f32_spread_is_inside_the_card_gate(spec):
    """One window (50 steps) of ``rollout_safedagger`` on the plain path
    from perturbed starts (the drivers' default sigmas, 8 episodes) with a
    policy trained at the BC widths, float32 against float64: chip_smoke.py
    phase 9d holds the card's end-of-window q and v against the plain path
    in float64, on the episodes whose gate agrees, within GATED_Q_TOL and
    GATED_V_TOL, which must be at least 3x this spread. Every episode here
    starts under the policy and hands over to the MPC within the window;
    the spread is heavy-tailed over episodes (q 1e-6 .. 2.7e-2), because
    the takeover runs a plan made for the window's start state from a state
    the policy has moved, so it is far above phase 7a's."""
    n = 8
    fx = np.load(ROLLOUT_REF.FIXTURE)
    db = Database(10_000, goal_type="vc")
    for b in range(fx["cold/states"].shape[0]):
        db.append(fx["cold/states"][b], fx["cold/actions"][b], vc_goals=fx["cold/vc_goals"][b])
    bundle, _ = bc.train_policy(db, bc.BcConfig(n_epoch=30, batch_size=64), device="cpu")
    st = workload.settled_start(1, device="cpu", dtype=F64)
    d = dagger.DaggerConfig()
    q, v, _ = perturbations.sample_perturbed_state(
        spec.model, spec.eff_frames, torch.Generator().manual_seed(0), st.q.expand(n, -1),
        st.v.expand(n, -1), TG.in_stance(spec.gait, torch.zeros(n, dtype=F64)),
        sigma_base_pos=d.sigma_base_pos, sigma_base_ori=d.sigma_base_ori,
        sigma_joint_pos=d.sigma_joint_pos, sigma_vel=d.sigma_vel)
    rng = np.random.default_rng(0)
    v_des, w_des = map(np.array, zip(*(goals.sample_velocities(rng, d.vx_range, d.vy_range,
                                                               d.w_range) for _ in range(n))))
    cfg = TR.RolloutConfig(episode_length=50, kp=trot_sim.kp, kd=trot_sim.kd)
    out = {}
    for dt in (torch.float32, F64):
        bundle.module.to(dt)
        pol = networks.PolicyBundle(bundle.module, *(x.to(dt) for x in (
            bundle.state_mean, bundle.state_std, bundle.goal_mean, bundle.goal_std)))
        out[dt] = TR.rollout_safedagger(
            spec, workload.closed_loop_sim_params(), cfg, physics.SimState(q.to(dt), v.to(dt)),
            torch.as_tensor(v_des, dtype=dt), torch.as_tensor(w_des, dtype=dt), pol,
            num_steps_to_block=d.num_steps_to_block, admm_backend="torch", ik_backend="torch")
    a, b = out[torch.float32], out[F64]
    agree = (a.mpc_usage == b.mpc_usage).all(1)
    assert agree.sum() >= n - 1
    mixed = int(((b.mpc_usage > 0).any(1) & (b.mpc_usage == 0).any(1)).sum())
    dq = float((a.final_state.q.double() - b.final_state.q)[agree].abs().max())
    dv = float((a.final_state.v.double() - b.final_state.v)[agree].abs().max())
    print(f"one gated window f32 vs f64 spread ({int(agree.sum())} of {n} agree, MPC steps "
          f"{float(b.mpc_usage.mean()):.3f}, {mixed} episodes switching): q {dq:.3e}, "
          f"v {dv:.3e}; card gates q {chip_smoke.GATED_Q_TOL:.1e}, v {chip_smoke.GATED_V_TOL:.1e}")
    assert 0.0 < dq and 3.0 * dq <= chip_smoke.GATED_Q_TOL
    assert 0.0 < dv and 3.0 * dv <= chip_smoke.GATED_V_TOL
