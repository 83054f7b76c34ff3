"""The port's CLI drivers (``bunmpc_tpu_torch/scripts/``) through ``main(argv)``
at tiny settings with ``device=cpu`` (the plain versions): each writes what
the JAX package's script of the same name writes.

* ``run_data_collection``: ``database_<rows>.npz`` (the port's snapshot; the
  JAX script writes ``.hdf5``) and ``metrics.jsonl``;
* ``run_bc``: the policy in the JAX checkpoint layout and ``metrics.jsonl``
  with one line per epoch;
* ``run_eval``: the MPC and the policy velocity grids as CSV;
* ``run_sweep``: the JSON of every grid point and the best (the grid cut to
  two points);
* ``run_dagger``: ``metrics.jsonl``, the final policy and the checkpoint;
  ``resume=true`` with a larger budget continues the run (no warmup).

The data collection runs the ``trot_sim`` gait (``gaits=['trot_sim']``, a
key of the config) for one 50-step episode and one perturbed one; the
DAgger run's episodes are 50 steps, with the driver's settle and ending
rollouts cut to 50 ms (its ``DaggerConfig`` defaults, which the script does
not expose, are patched)."""

import csv
import functools
import json
import os

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu_torch.learning import dagger
from bunmpc_tpu_torch.learning.database import Database
from bunmpc_tpu_torch.scripts import run_bc, run_dagger, run_data_collection, run_eval, run_sweep
from bunmpc_tpu_torch.utils.checkpoint import load_policy


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    out = tmp_path_factory.mktemp("data")
    rc = run_data_collection.main([
        "episode_length=50", "n_iteration=1", "num_perturbations_per_replanning=1",
        "gaits=['trot_sim']", f"data_save_path={out}", "device=cpu"])
    assert rc == 0
    return out


@pytest.fixture(scope="module")
def trained(collected, tmp_path_factory):
    out = tmp_path_factory.mktemp("bc") / "policy"
    rc = run_bc.main([f"database={database_path(collected)}", "n_epoch=2", "batch_size=16",
                      "num_hidden_layer=2", "hidden_dim=32", f"save_path={out}", "device=cpu"])
    assert rc == 0
    return out


def database_path(out):
    names = [n for n in os.listdir(out) if n.startswith("database_")]
    assert len(names) == 1 and names[0].endswith(".npz")
    return os.path.join(out, names[0])


def test_run_data_collection(collected):
    path = database_path(collected)
    db = Database(1000, goal_type="cc")
    db.load_saved_database(path)
    assert os.path.basename(path) == f"database_{len(db)}.npz" and len(db) > 0
    assert db.states.shape[1] == 43 and db.cc_goals.shape[1] == 12
    assert np.isfinite(db.states).all() and np.isfinite(db.actions).all()
    lines = (collected / "metrics.jsonl").read_text().splitlines()
    entry = json.loads(lines[0])
    assert len(lines) == 1 and entry["iteration"] == 0
    assert entry["database_size"] == str(len(db))


def test_run_bc(trained):
    assert sorted(os.listdir(trained)) == ["meta.json", "payload.npz"]
    with open(trained / "meta.json") as fh:
        assert json.load(fh) == {"output_size": 12, "num_hidden_layer": 2, "hidden_dim": 32,
                                 "batch_norm": False}
    lines = [json.loads(s) for s in (trained.parent / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in lines] == [0, 1]
    assert all(np.isfinite(e["Training Loss"]) for e in lines)
    pol = load_policy(str(trained), device="cpu")
    assert pol(torch.zeros(3, 43), torch.zeros(3, 12)).shape == (3, 12)


def test_run_bc_needs_a_database():
    with pytest.raises(SystemExit, match="database="):
        run_bc.main(["device=cpu"])


def read_csv(path):
    with open(path) as fh:
        return list(csv.reader(fh))


def test_run_eval_grids(collected, tmp_path, capsys):
    rc = run_eval.main(["mode=mpc_grid", "vx=0:0.2:2", "episode_length=50", "gait=trot_sim",
                        f"out={tmp_path / 'mpc.csv'}", "device=cpu"])
    assert rc == 0 and "survival_rate" in capsys.readouterr().out
    rows = read_csv(tmp_path / "mpc.csv")
    assert rows[0] == ["vx_des", "vy_des", "w_des", "vx_mse", "vy_mse", "survived", "mean_speed"]
    assert [float(r[0]) for r in rows[1:]] == [0.0, 0.2]
    # the policy grid runs vc goals: a policy trained by run_bc with goal_type=vc
    pol = tmp_path / "vc_policy"
    assert run_bc.main([f"database={database_path(collected)}", "goal_type=vc", "n_epoch=1",
                        "batch_size=16", "num_hidden_layer=2", "hidden_dim=32",
                        f"save_path={pol}", "device=cpu"]) == 0
    rc = run_eval.main(["mode=policy_grid", f"policy={pol}", "vx=0.1", "episode_length=50",
                        f"out={tmp_path / 'policy.csv'}", "device=cpu"])
    assert rc == 0
    rows = read_csv(tmp_path / "policy.csv")
    assert len(rows) == 2 and float(rows[1][0]) == 0.1


def test_run_sweep(collected, tmp_path, monkeypatch):
    monkeypatch.setattr(run_sweep, "SPACE", {"learning_rate": [1e-3, 5e-3], "batch_size": [16],
                                             "num_hidden_layer": [2], "hidden_dim": [32]})
    out = tmp_path / "sweep.json"
    rc = run_sweep.main([f"database={database_path(collected)}", "epochs=1", f"out={out}",
                         "device=cpu"])
    assert rc == 0
    got = json.loads(out.read_text())
    assert [r["learning_rate"] for r in got["results"]] == [1e-3, 5e-3]
    assert got["best"] == min(got["results"], key=lambda r: r["valid_loss"])


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flag, expected", [
    (None, False), ("resume=true", True), ("resume=True", True), ("resume=1", True),
    ("resume=false", False), ("resume=False", False), ("resume=0", False)])
def test_run_dagger_resume_flag(tmp_path, monkeypatch, flag, expected):
    """``resume=false`` does not resume: the override reaches the config as
    the string ``"false"``, which the driver parses as a boolean."""
    seen = []

    def run(self, q0, v0, checkpoint_dir=None, resume=False):
        seen.append(resume)
        raise _Stop

    monkeypatch.setattr(dagger.SafeDagger, "run", run)
    args = ["mode=safedagger", f"save_path={tmp_path}", "device=cpu"]
    with pytest.raises(_Stop):
        run_dagger.main(args + ([flag] if flag else []))
    assert seen == [expected]
    with pytest.raises(ValueError, match="boolean"):
        run_dagger.parse_flag("maybe")


def test_run_dagger_and_resume(tmp_path, monkeypatch):
    monkeypatch.setattr(dagger, "DaggerConfig", functools.partial(
        dagger.DaggerConfig, settle_ms=50, ending_mpc_rollout_ms=50, rollouts_warmup=1))
    warmups = []
    warmup = dagger._IterativeDriver.warmup
    monkeypatch.setattr(dagger._IterativeDriver, "warmup",
                        lambda self, *a: warmups.append(1) or warmup(self, *a))
    out = tmp_path / "sd"
    args = ["mode=safedagger", "episode_length=50", "rollouts_per_iteration=1",
            "warmup_bc_epochs=1", "bc_epochs=1", "vx_range=[0.0,0.2]", "vy_range=[0.0,0.0]",
            "w_range=[0.0,0.0]", f"save_path={out}", "device=cpu"]
    assert run_dagger.main(args + ["n_iterations=1"]) == 0
    assert sorted(os.listdir(out)) == ["checkpoint", "metrics.jsonl", "policy"]
    first = [json.loads(s) for s in (out / "metrics.jsonl").read_text().splitlines()]
    assert [e["iteration"] for e in first] == [0]
    state = json.loads((out / "checkpoint" / "state.json").read_text())
    assert state["next_iteration"] == 1 and state["mode"] == "safedagger"

    assert run_dagger.main(args + ["n_iterations=2", "resume=true"]) == 0
    assert len(warmups) == 1  # the resumed call ran none
    lines = [json.loads(s) for s in (out / "metrics.jsonl").read_text().splitlines()]
    assert [e["iteration"] for e in lines] == [0, 0, 1]  # the log appends both calls' entries
    assert {k: v for k, v in lines[1].items() if k != "_time"} == \
        {k: v for k, v in first[0].items() if k != "_time"}
    assert json.loads((out / "checkpoint" / "state.json").read_text())["next_iteration"] == 2
    pol = load_policy(str(out / "policy"), device="cpu")
    assert pol(torch.zeros(43), torch.zeros(5)).shape == (12,)
