"""The multi-device path of the port on CPU ranks over gloo, against the JAX
package where it has a counterpart.

* ``parallel/mesh.py``: ``pad_to_devices`` and ``scaling_efficiency`` equal
  to the JAX functions; shard, replicate and gather round trips on 4 ranks
  and on a 2-rank mesh of them (bit for bit, dtypes kept, a rank off the
  mesh refused); the (dcn=2, ici=2) mesh gives every rank the shard the
  4-rank batch mesh gives it; uneven batches and shapes refused.
* ``bc.train_policy(mesh=batch_mesh(4, device="cpu"))`` against the JAX
  ``train_policy(mesh=batch_mesh(4))`` on 4 virtual CPU devices
  (tests/conftest.py), from the same flax parameters: per-epoch losses
  within rtol 1e-5, final parameters within atol 1e-5 (float32 both sides,
  the batch of 66 rounded to 64 on both), the same parameters on every rank.
* The sharded solve: ``solve_mpc_batch`` on each of 2 ranks' shards
  (plain backends, float64), gathered, equal to the unsharded solve within
  1e-10 (which tests/test_torch_kino_dyn.py holds against JAX).
* ``train_from_databases(mesh=...)`` on 2 ranks against the unsharded run.
* ``launch``: a failing rank stops the others and raises with its
  traceback; the refusals that need no rank; ``shutdown`` raises where
  Python lacks the forkserver's stop hook.
* ``scripts/bench_multichip.py`` on 2 CPU ranks: the JAX script's keys (its
  CPU artifact's), both counts solved and converged, no kernel launched.
* ``_build``'s lock: two processes building one host library in one fresh
  directory build it once.

One launch of 4 ranks serves the file: a module fixture starts it in a
thread, so that the references compute while the ranks work.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.learning import bc as JBC
from bunmpc_tpu.learning.database import Database as JDatabase
from bunmpc_tpu.learning.networks import GoalConditionedPolicyNet as JNet
from bunmpc_tpu.parallel import mesh as JM
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.learning import bc
from bunmpc_tpu_torch.parallel import mesh as PM
from bunmpc_tpu_torch.scripts import bench_multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 training on both sides (tests/test_torch_learning.py's BC tolerance
# for the losses; the sharded mean of means rounds apart from one mean)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def flax_params():
    params = JNet(12, 2, 32).init(jax.random.PRNGKey(3), jnp.zeros((1, 55)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(flax_params, tmp_path_factory):
    """The 4 ranks' results (a future), the snapshots they trained on, and
    ``bench_multichip`` on 2 CPU ranks (a future of its output file),
    started together."""
    paths = R.write_snapshots(tmp_path_factory.mktemp("snapshots"))
    params = {k: v.numpy() for k, v in convert.policy_params_from_flax(flax_params).items()}
    out = str(tmp_path_factory.mktemp("bench") / "scaling.json")
    argv = ["device=cpu", "n_devices=2", "per_device=1", f"out={out}"]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        future = pool.submit(PM.launch, R.four_ranks, 4, args=(params, paths), device="cpu",
                             timeout=600)
        bench = pool.submit(lambda: (bench_multichip.main(argv), out))
        yield future, paths, bench


def test_sharded_bc_matches_jax(ranks, flax_params):
    jcfg = JBC.BcConfig(**R.BC_CFG)
    jbundle, jrep = JBC.train_policy(R.bc_database(JDatabase), jcfg, rng_seed=R.BC_SEED,
                                     mesh=JM.batch_mesh(4), params=flax_params)
    ref = convert.policy_params_from_flax(jax.tree_util.tree_map(np.asarray, jbundle.params))
    results = ranks[0].result()
    for res in results:
        got = res["bc"]
        np.testing.assert_allclose(got["train"], jrep.train_losses, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["valid"], jrep.valid_losses, rtol=LOSS_RTOL)
        for k, a in ref.items():
            np.testing.assert_allclose(got["params"][k], a.numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=k)
            np.testing.assert_array_equal(got["params"][k], results[0]["bc"]["params"][k])
    assert len(jrep.train_losses) == 3


def test_sharded_solve_equals_unsharded(ranks):
    ref = R.solve(workload.trot_states(R.SOLVE_B))
    results = ranks[0].result()
    for res in results[:2]:
        got = res["solve"]
        assert type(got).__name__ == "MpcPlan"
        for name, a in ref._asdict().items():
            b = getattr(got, name)
            assert b.shape == tuple(a.shape) and b.dtype == a.numpy().dtype, name
            np.testing.assert_allclose(b, a.numpy(), rtol=0, atol=1e-10, err_msg=name)
    assert "solve" not in results[2] and "solve" not in results[3]


def test_train_from_databases_sharded_equals_unsharded(ranks):
    future, paths, _ = ranks
    ref = R.train_from_databases(paths)
    for res in future.result()[:2]:
        assert [e["label"] for e in res["mdb"]] == [e["label"] for e in ref] == ["snap_300",
                                                                                 "snap_500"]
        for a, b in zip(res["mdb"], ref):
            assert a["db_size"] == b["db_size"]
            np.testing.assert_allclose(a["train"], b["train"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(a["valid"], b["valid"], rtol=LOSS_RTOL)
            for k, p in b["params"].items():
                np.testing.assert_allclose(a["params"][k], p.numpy(), rtol=0, atol=PARAM_ATOL)


def _same_tree(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same_tree(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif b is None:
        assert a is None
    else:
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _rows(tree, lo, hi):
    return PM._tree_map(lambda a: a[lo:hi], tree)


@pytest.mark.parametrize("tag, n", [("4", 4), ("2", 2)])
def test_round_trips(ranks, tag, n):
    tree = R.sharding_tree()
    results = ranks[0].result()
    for r, res in enumerate(results):
        got = res[tag]
        if r >= n:
            assert got == "not a member"
            continue
        k = 8 // n
        assert got["rank"] == r and got["shape"] == (n,)
        _same_tree(got["shard"], _rows(tree, r * k, (r + 1) * k))
        _same_tree(got["gather"], tree)
        _same_tree(got["repl"], {"w": np.full(3, 1.0), "first": np.array([True])})


def test_dcn_mesh_shards_as_the_batch_mesh(ranks):
    for r, res in enumerate(ranks[0].result()):
        got = res["dcn"]
        assert got["shape"] == (2, 2) and got["rank"] == r
        _same_tree(got["shard"], res["4"]["shard"])
        _same_tree(got["gather"], R.sharding_tree())


def test_uneven_batches_and_shapes_raise(ranks):
    for res in ranks[0].result():
        assert res["errors"] == ["a batch of 6 over 4", "a 0-d leaf",
                                 "the 1-D helper on the 2-D mesh", "shards of other shapes"]


@pytest.mark.parametrize("n, devices", [(7, 1), (7, 2), (7, 4), (8, 4), (1, 8), (5, 3)])
def test_pad_to_devices_matches_jax(n, devices):
    arr = np.random.default_rng(n).normal(size=(n, 3))
    got, n_got = PM.pad_to_devices(arr, devices)
    ref, n_ref = JM.pad_to_devices(arr, devices)
    assert n_got == n_ref == n
    np.testing.assert_array_equal(got, ref)


def test_scaling_efficiency_matches_jax():
    for rates in ({1: 100.0, 2: 190.0, 4: 360.0, 8: 650.0}, {2: 10.0, 4: 21.0}, {1: 3.0}):
        assert PM.scaling_efficiency(rates) == JM.scaling_efficiency(rates)


def test_a_failing_rank_stops_the_launch():
    t0 = time.time()
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 failed:.*ValueError: rank 1 fails"):
        PM.launch(R.fail_on_rank_one, 2, device="cpu", timeout=120)
    assert time.time() - t0 < 60  # rank 0, blocked in a barrier, was stopped


def test_refusals_without_ranks():
    with pytest.raises(RuntimeError, match="process group"):
        PM.batch_mesh(device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        PM.launch(R.fail_on_rank_one, 2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="n_ranks"):
        PM.launch(R.fail_on_rank_one, device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        bc.make_sharded_train_step(torch.nn.Linear(2, 2), None, mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PM.launch(R.fail_on_rank_one, 2)


def test_shutdown_without_the_forkserver_hook_raises(monkeypatch):
    from multiprocessing import forkserver

    monkeypatch.setattr(forkserver, "_forkserver", object())
    with pytest.raises(RuntimeError, match="forkserver._forkserver._stop"):
        PM.shutdown()


def test_two_processes_build_one_host_library_once(tmp_path):
    """Two processes start together on one fresh build directory: both load
    the library, built once (the second finds it fresh under the lock)."""
    code = ("import ctypes, os, sys; from bunmpc_tpu_torch import _build; "
            "p = _build.build_host('admm', sys.argv[1]); ctypes.CDLL(p); "
            "s = os.stat(p); print(s.st_ino, s.st_mtime_ns)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    assert sorted(os.listdir(tmp_path)) == [".lock", "libadmm_host.so"]


def test_bench_multichip_on_cpu_ranks(ranks):
    rc, out = ranks[2].result()
    assert rc == 0
    with open(out) as fh:
        doc = json.load(fh)
    with open(os.path.join(REPO, "artifacts", "multichip_scaling_cpu.json")) as fh:
        jax_doc = json.load(fh)
    assert set(jax_doc) <= set(doc) and "dcn" not in doc
    assert doc["platform"] == "cpu" and doc["backend"] == "gloo" and doc["n_devices"] == 2
    assert set(doc["rates"]) == set(doc["efficiency"]) == {"1", "2"}
    assert all(r > 0 for r in doc["rates"].values()) and doc["efficiency"]["1"] == 1.0
    assert doc["converged_frac"] == {"1": 1.0, "2": 1.0}
    assert doc["launches"] == {"1": [{"admm": 0, "ddp": 0}, None],
                               "2": [{"admm": 0, "ddp": 0}, {"admm": 0, "ddp": 0}]}
