"""Checkpoint and resume of the port's DAgger drivers
(``bunmpc_tpu_torch/learning/dagger.py``) and the database snapshots, on the
plain backends on the CPU (``device="cpu"``; 50-step episodes, 1 BC epoch at
2 x 32, a cut-down solver, as tests/test_torch_dagger_drivers.py):

* the JAX package's scenarios (tests/test_drivers.py:133-236): a run of 1
  iteration resumed with a budget of 2 continues from the checkpoint (the
  first iteration's log entry restored, not re-run); a run killed by its
  eval hook in iteration 0 resumes from the warmup's checkpoint and
  completes both iterations; LocoSafeDagger's posterior survives a
  checkpoint;
* a run of 2 iterations equals 1 iteration + resume bit for bit: the
  database, the policy's parameters and the logs;
* the checkpoint's files: the JAX layout, the database as ``database.npz``;
* a ``database.hdf5`` written by the JAX package loads into the port with
  equal arrays, and the port's ``.npz`` snapshot round-trips (and holds no
  pickled object).
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.learning.database import Database as JDatabase
from bunmpc_tpu_torch import workload
from bunmpc_tpu_torch.learning import dagger
from bunmpc_tpu_torch.learning.bc import BcConfig
from bunmpc_tpu_torch.learning.database import Database
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.solvers import biconvex, ddp

CFG = dict(episode_length=50, rollouts_per_iteration=1, rollouts_warmup=1,
           episode_length_warmup=50, warmup_bc_epochs=1, ending_mpc_rollout_ms=50,
           num_steps_to_block=20, settle_ms=50, vx_range=(0.0, 0.3), vy_range=(0.0, 0.0),
           w_range=(0.0, 0.0), sigma_base_ori=0.3, sigma_vel=0.1,
           bc=BcConfig(n_epoch=1, batch_size=64, num_hidden_layer=2, hidden_dim=32))


@pytest.fixture(scope="module")
def spec():
    return KD.make_cyclic_spec(TC.load_model(), trot_sim, TC.q0(), device="cpu")


def driver(spec, cls=dagger.SafeDagger, seed=7, n_iterations=2, **kw):
    cfg = dagger.DaggerConfig(**CFG, n_iterations=n_iterations)
    return cls(spec, cfg, sim_params=workload.closed_loop_sim_params(), seed=seed,
               admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=10),
               ddp_cfg=ddp.DdpConfig(n_iters=1, alphas=(1.0,)), admm_backend="torch",
               ik_backend="torch", **kw)


def run(drv, **kw):
    return drv.run(TC.q0(), np.zeros(18), **kw)


def assert_same_state(a, b):
    assert len(a.database) == len(b.database) > 0
    for f in ("states", "actions", "vc_goals"):
        np.testing.assert_array_equal(getattr(a.database, f), getattr(b.database, f))
    sa, sb = a.policy.module.state_dict(), b.policy.module.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for f in ("state_mean", "state_std", "goal_mean", "goal_std"):
        assert torch.equal(getattr(a.policy, f), getattr(b.policy, f)), f
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.fixture(scope="module")
def straight(spec):
    """An uninterrupted run of 2 iterations."""
    drv = driver(spec, n_iterations=2)
    return drv, run(drv)


def test_resume_with_a_larger_budget_equals_the_straight_run(spec, straight, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    a = driver(spec, n_iterations=1)
    logs_a = run(a, checkpoint_dir=ckpt)
    assert len(logs_a) == 1
    assert sorted(os.listdir(ckpt)) == ["database.npz", "driver_state.npz", "policy",
                                        "state.json"]
    assert sorted(os.listdir(os.path.join(ckpt, "policy"))) == ["meta.json", "payload.npz"]
    with open(os.path.join(ckpt, "state.json")) as fh:
        state = json.load(fh)
    assert state["mode"] == "safedagger" and state["next_iteration"] == 1
    assert state["logs"] == logs_a

    b = driver(spec, n_iterations=2)
    calls = []
    b.warmup = lambda *a_: calls.append("warmup")
    logs_b = run(b, checkpoint_dir=ckpt, resume=True)
    assert calls == []  # restored, not re-run
    assert len(logs_b) == 2 and logs_b[0] == logs_a[0]
    assert logs_b[1]["database_size"] >= logs_a[0]["database_size"]
    assert b.policy(torch.zeros(43), torch.zeros(5)).shape == (12,)

    drv, logs = straight
    assert logs_b == logs
    assert_same_state(b, drv)


def test_crash_resume_loses_at_most_one_iteration(spec, straight, tmp_path):
    """An eval hook raising in iteration 0 (after its training) kills the
    run; the resumed run restores the warmup's checkpoint and its log
    entry, runs both iterations, and ends where the straight run ends."""
    ckpt = str(tmp_path / "crash")

    class Boom(RuntimeError):
        pass

    calls = {"n": 0}

    def crashing_hook(drv):
        calls["n"] += 1
        if calls["n"] == 2:  # the warmup's eval passes, iteration 0's raises
            raise Boom()
        return {"probe": calls["n"]}

    with pytest.raises(Boom):
        run(driver(spec, n_iterations=2), checkpoint_dir=ckpt, eval_hook=crashing_hook)
    b = driver(spec, n_iterations=2)
    logs = run(b, checkpoint_dir=ckpt, resume=True)
    iters = [e["iteration"] for e in logs if isinstance(e.get("iteration"), int)]
    assert iters == [0, 1]
    assert logs[0] == {"iteration": "warmup", "probe": 1}
    assert logs[1:] == straight[1]
    assert_same_state(b, straight[0])


def test_locosafedagger_posterior_roundtrip(spec, tmp_path):
    d = driver(spec, dagger.LocoSafeDagger, seed=1, grid_n=5)
    d.posterior = np.arange(d.posterior.size, dtype=np.float64).reshape(d.posterior.shape)
    d.database.append(np.zeros((4, 43), np.float32), np.zeros((4, 12), np.float32),
                      vc_goals=np.zeros((4, 5), np.float32))
    d.save_checkpoint(str(tmp_path / "l"), 3, [{"iteration": 0}])
    d2 = driver(spec, dagger.LocoSafeDagger, seed=99, grid_n=5)
    nxt, logs = d2.load_checkpoint(str(tmp_path / "l"))
    assert nxt == 3 and logs == [{"iteration": 0}]
    np.testing.assert_array_equal(d2.posterior, d.posterior)
    assert len(d2.database) == 4 and d2.policy is None
    assert d2.rng.bit_generator.state == d.rng.bit_generator.state
    assert torch.equal(d2.generator.get_state(), d.generator.get_state())


# ---- database snapshots ----


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(n, w)).astype(np.float32) for w in (43, 12, 5, 12))


def test_jax_hdf5_database_loads_in_the_port(tmp_path):
    theirs = JDatabase(100, goal_type="cc")
    s, a, vc, cc = _rows(130, 0)  # wraps the ring: 30 rows overwritten
    theirs.append(s[:70], a[:70], vc_goals=vc[:70], cc_goals=cc[:70])
    theirs.append(s[70:], a[70:], vc_goals=vc[70:], cc_goals=cc[70:])
    path = str(tmp_path / "database.hdf5")
    theirs.save(path)
    ours = Database(1000, goal_type="cc")
    ours.load_saved_database(path)
    assert len(ours) == len(theirs) == 100
    for f in ("states", "actions", "vc_goals", "cc_goals"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(theirs, f))
    for x, y in zip(ours.get_database_mean_std(), theirs.get_database_mean_std()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("goals", ["both", "vc"])
def test_npz_snapshot_round_trips(tmp_path, goals):
    db = Database(100, goal_type="vc")
    s, a, vc, cc = _rows(130, 1)
    db.append(s, a, vc_goals=vc, cc_goals=cc if goals == "both" else None)
    path = str(tmp_path / "db.npz")
    db.save(path)
    with np.load(path, allow_pickle=False) as z:
        assert sorted(z.files) == sorted(["states", "actions", "vc_goals"] +
                                         (["cc_goals"] if goals == "both" else []))
        assert all(z[k].dtype == np.float32 for k in z.files)
    again = Database(100, goal_type="vc")
    again.load_saved_database(path)
    for f in ("states", "actions", "vc_goals", "cc_goals"):
        x, y = getattr(again, f), getattr(db, f)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    for x, y in zip(again.xy(), db.xy()):
        np.testing.assert_array_equal(x, y)
