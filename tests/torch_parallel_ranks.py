"""What the ranks of ``tests/test_torch_parallel.py`` run, and the seeded
inputs both sides of its checks build. The ranks (``parallel.mesh.launch``)
import this module by name, so it imports no JAX."""

import numpy as np
import torch
import torch.distributed as dist

import torch_port_helpers  # noqa: F401  (one PyTorch thread)
from bunmpc_tpu_torch import workload
from bunmpc_tpu_torch.eval import multi_database as MDB
from bunmpc_tpu_torch.learning import bc
from bunmpc_tpu_torch.learning.database import Database
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu_torch.parallel import mesh as PM
from bunmpc_tpu_torch.robots.solo12 import Solo12Config
from bunmpc_tpu_torch.solvers import biconvex, ddp

# BC: 640 cc rows of a linear teacher; a batch of 66 rounds to 64 on 4 devices
# (and on 2), as in the JAX trainer
BC_CFG = dict(batch_size=66, n_epoch=3, num_hidden_layer=2, hidden_dim=32)
BC_SEED = 4
# the multi-database trainer: two vc snapshots, 2 x 32 hidden, 3 epochs
MDB_CFG = dict(batch_size=64, n_epoch=3, num_hidden_layer=2, hidden_dim=32)
MDB_SEED = 5
# the sharded solve: bench.py's draws in float64 on the plain backends, at
# bench_multichip's fast budget
SOLVE_B = 4


def bc_arrays():
    rng = np.random.default_rng(7)
    states = rng.normal(size=(640, 43)).astype(np.float32)
    goals = rng.normal(size=(640, 12)).astype(np.float32)
    W = rng.normal(size=(55, 12)).astype(np.float32) * 0.3
    return states, goals, (np.concatenate([states, goals], -1) @ W).astype(np.float32)


def bc_database(cls):
    states, goals, actions = bc_arrays()
    db = cls(1000, goal_type="cc")
    db.append(states, actions, vc_goals=goals[:, :5], cc_goals=goals)
    return db


def write_snapshots(directory) -> list:
    """Two vc database snapshots (``.npz``) of 300 and 500 rows."""
    rng = np.random.default_rng(9)
    paths = []
    for n in (300, 500):
        db = Database(1000, goal_type="vc")
        states = rng.normal(size=(n, 43)).astype(np.float32)
        goals = rng.normal(size=(n, 5)).astype(np.float32)
        db.append(states, np.tanh(states[:, :12] + goals[:, :1]), vc_goals=goals)
        paths.append(str(directory / f"snap_{n}.npz"))
        db.save(paths[-1])
    return paths


def train_from_databases(paths, mesh=None):
    entries = MDB.train_from_databases(paths, cfg=bc.BcConfig(**MDB_CFG), limit=1000, mesh=mesh,
                                       rng_seed=MDB_SEED, device="cpu")
    return [dict(label=e.label, db_size=e.db_size, train=e.final_train_loss,
                 valid=e.final_valid_loss, params=e.bundle.module.state_dict()) for e in entries]


def solve(inputs):
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0(), device="cpu")
    return KD.solve_mpc_batch(
        spec, *(torch.as_tensor(a, dtype=torch.float64) for a in inputs),
        admm_cfg=biconvex.BiconvexConfig(rho=trot.rho, max_admm_iters=30),
        ddp_cfg=ddp.DdpConfig(n_iters=2), admm_backend="torch", ik_backend="torch")


def sharding_tree():
    """A tree with a leading batch of 8: float64, int32 and bool leaves in a
    dict, a tuple and a list, and a leaf that is not an array."""
    x = np.arange(24, dtype=np.float64).reshape(8, 3)
    return {"x": x, "i": torch.arange(8, dtype=torch.int32),
            "parts": (x[:, :2] > 7, [torch.ones(8, 2, 2)]), "none": None}


def four_ranks(bc_params, snapshots):
    """Rank work for the file's one launch (4 CPU ranks): the round trips on
    the 4-rank, the 2-rank and the (dcn=2, ici=2) meshes, the refusals, BC on
    4 ranks, and on the first two ranks the sharded solve and the
    multi-database trainer."""
    meshes = {"4": (PM.batch_mesh(device="cpu"), PM.shard_batch),
              "2": (PM.batch_mesh(2, device="cpu"), PM.shard_batch),
              "dcn": (PM.multihost_mesh(dcn=2, device="cpu"), PM.shard_batch_2d)}
    tree = sharding_tree()
    out = {}
    for tag, (mesh, shard) in meshes.items():
        if mesh.rank is None:
            try:
                shard(mesh, tree)
                out[tag] = "sharded off the mesh"
            except ValueError:
                out[tag] = "not a member"
            continue
        mine = shard(mesh, tree)
        out[tag] = dict(rank=mesh.rank, shape=mesh.shape, shard=mine,
                        gather=PM.gather_batch(mesh, mine),
                        repl=PM.replicate(mesh, {"w": np.full(3, mesh.rank + 1.0),
                                                 "first": np.array([mesh.rank == 0])}))
    m4, m2 = meshes["4"][0], meshes["2"][0]
    errors = []
    for what, call in (("a batch of 6 over 4", lambda: PM.shard_batch(m4, np.zeros((6, 2)))),
                       ("a 0-d leaf", lambda: PM.shard_batch(m4, np.zeros(()))),
                       ("the 1-D helper on the 2-D mesh",
                        lambda: PM.shard_batch(meshes["dcn"][0], tree)),
                       ("shards of other shapes",
                        lambda: PM.gather_batch(m4, np.zeros((m4.rank + 1, 2))))):
        try:
            call()
        except ValueError:
            errors.append(what)
    out["errors"] = errors

    params = {k: torch.as_tensor(v) for k, v in bc_params.items()}
    bundle, rep = bc.train_policy(bc_database(Database), bc.BcConfig(**BC_CFG), rng_seed=BC_SEED,
                                  mesh=m4, params=params)
    out["bc"] = dict(train=rep.train_losses, valid=rep.valid_losses,
                     params=bundle.module.state_dict())
    if m2.rank is not None:
        out["solve"] = PM.gather_batch(m2, solve(PM.shard_batch(m2, workload.trot_states(SOLVE_B))))
        out["mdb"] = train_from_databases(snapshots, mesh=m2)
    dist.barrier()
    return out


def fail_on_rank_one():
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()
