"""Multi-device scaling benchmark: the batched MPC solve sharded over the ranks.

Counterpart of ``scripts/bench_multichip.py``: solves/s at 1, 2, 4, 8 and all
devices, ``per_device`` problems each, their scaling efficiency (BASELINE.md
target: >= 85% at 4 hosts), and the (``dcn``, ``ici``) multi-host mesh.

One process per device (``parallel.mesh.launch``), started once for the
largest count; the count ``n`` runs on the mesh of the first ``n`` ranks
while the others wait. Each rank solves its shard of the batch with
``solve_mpc_batch`` on its own device: on the card the port's main path
(K1 and K2, ``admm_backend="cuda", ik_backend="cuda"``), with ``device=cpu``
the plain PyTorch backends (the JAX script solves with ``vmap(solve_mpc)`` on
XLA). A count's time is its slowest rank's: an untimed solve, then three
timed ones between two all-reduces over the mesh.

    python -m bunmpc_tpu_torch.scripts.bench_multichip [per_device=16] [fast=1]

Arguments are the JAX script's (``per_device``, ``fast``, ``dcn``,
``coordinator``, ``num_processes``, ``process_id``, ``out``) plus
``device=cpu``, ``backend=`` (NCCL on the card and gloo on the CPU by
default) and ``n_devices=`` (the ranks to start: every card by default; 8 on
the CPU, the JAX script's virtual device count). Several ranks on one card
need gloo (``n_devices=2 backend=gloo``). ``fast=1`` (the default) cuts the
solver to 30 ADMM iterations and 2 GN-DDP iterations, as the JAX script does.

Validating the sharded program on CPU ranks (they share the host's cores,
so their efficiency is not a hardware figure), with the simulated-host
(``dcn``) path:

    python -m bunmpc_tpu_torch.scripts.bench_multichip device=cpu n_devices=4 per_device=2 dcn=2

Multi-host: run the same command on every host, each with its ``process_id``
(its ranks are every card of the host; ``dcn`` defaults to the host count):

    python -m bunmpc_tpu_torch.scripts.bench_multichip \\
        coordinator=<host0-addr>:8476 num_processes=4 process_id=$i per_device=64 fast=0

Writes ``artifacts/torch_multichip_scaling_<platform>[_dcn].json`` (platform
``gpu`` or ``cpu``; ``_dcn`` for the single-host ``dcn`` path) under the JAX
script's keys, with the backend, the card, each count's converged fraction
and each rank's kernel launches beside them.
"""

from __future__ import annotations

import json
import os
import sys
import time


def _solver_kwargs(on_card: bool, fast: bool) -> dict:
    from ..mpc.motions.solo12_cyclic import trot
    from ..solvers import biconvex, cuda_admm, ddp

    kw = {} if on_card else dict(admm_backend="torch", ik_backend="torch")
    if fast:  # the JAX script's budget for its virtual-CPU runs
        admm = cuda_admm.CudaAdmmConfig if on_card else biconvex.BiconvexConfig
        kw.update(admm_cfg=admm(rho=trot.rho, max_admm_iters=30), ddp_cfg=ddp.DdpConfig(n_iters=2))
    return kw


def _inputs(B: int):
    """The JAX script's batch: q0, at rest, clock 0, vx 0.2 (float32 numpy)."""
    import numpy as np

    from ..robots.solo12 import Solo12Config

    return (np.tile(Solo12Config.q0(), (B, 1)).astype(np.float32),
            np.zeros((B, 18), np.float32), np.zeros(B, np.float32),
            np.tile(np.asarray([0.2, 0.0, 0.0], np.float32), (B, 1)), np.zeros(B, np.float32))


def _bench_rank(cfg: dict) -> dict:
    """One rank: every count's rate (the slowest rank's), converged fraction
    and this rank's launches; the dcn path; the one-card batch table."""
    import torch
    import torch.distributed as dist

    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import trot
    from ..parallel import mesh as PM
    from ..robots.solo12 import Solo12Config
    from ..solvers import cuda_admm, cuda_ddp

    device = PM.rank_device(cfg["device"])
    on_card = device.type == "cuda"
    backend = cfg["backend"]
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0(), device=device)
    kw = _solver_kwargs(on_card, cfg["fast"])
    per_device = cfg["per_device"]

    def sync(mesh):
        z = torch.zeros(1, device=device)
        dist.all_reduce(z, group=mesh.group)
        if on_card:
            torch.cuda.synchronize(device)

    def rate_on(mesh, shard):
        """``(solves/s, converged fraction, this rank's launches)`` of the
        whole batch on ``mesh``, or Nones off it; every rank of the group
        learns the rate from the first rank."""
        out = torch.zeros(2, dtype=torch.float64, device=device)
        launches = None
        if mesh.rank is not None:
            B = per_device * mesh.size
            mine = shard(mesh, _inputs(B))
            for k in (cuda_admm.KERNEL, *cuda_ddp.KERNELS.values()):
                k.launches = 0
            plans = KD.solve_mpc_batch(spec, *mine, **kw)
            sync(mesh)
            t0 = time.perf_counter()
            for _ in range(3):
                plans = KD.solve_mpc_batch(spec, *mine, **kw)
            sync(mesh)
            dt = torch.tensor([(time.perf_counter() - t0) / 3], dtype=torch.float64,
                              device=device)
            dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=mesh.group)
            conv = (plans.dyn_violation < 1e-3).sum().to(torch.float64).reshape(1)
            dist.all_reduce(conv, group=mesh.group)
            out = torch.cat([B / dt, conv / B])
            launches = {"admm": cuda_admm.KERNEL.launches,
                        "ddp": sum(k.launches for k in cuda_ddp.KERNELS.values())}
        dist.broadcast(out, src=0)
        return float(out[0]), float(out[1]), launches

    world = dist.get_world_size()
    counts = sorted({1, 2, 4, 8, world} & set(range(1, world + 1)))
    doc = {"rates": {}, "converged_frac": {}, "launches": {}}
    for n in counts:
        mesh = PM.batch_mesh(n, device=device, backend=backend)
        r, c, launches = rate_on(mesh, PM.shard_batch)
        doc["rates"][n], doc["converged_frac"][n], doc["launches"][n] = r, c, launches

    dcn = cfg["dcn"]
    if dcn >= 2:
        per_host = world // dcn
        hosts = (dcn,) if cfg["num_hosts"] > 1 else (1, dcn)
        doc["dcn_rates"] = {}
        for k in hosts:
            mesh = PM.multihost_mesh(dcn=k, devices=range(k * per_host), device=device,
                                     backend=backend)
            doc["dcn_rates"][k] = rate_on(mesh, PM.shard_batch_2d)[0]

    if on_card and world == 1:
        # the one-card batch table (the one-chip analog of device scaling:
        # where the card saturates, and what a second card would buy)
        doc["single_chip_batch_scaling"] = {}
        for B in (128, 256, 512):
            args = [torch.as_tensor(a, device=device) for a in _inputs(B)]
            KD.solve_mpc_batch(spec, *args)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(3):
                KD.solve_mpc_batch(spec, *args)
            torch.cuda.synchronize(device)
            doc["single_chip_batch_scaling"][str(B)] = round(B / ((time.perf_counter() - t0) / 3),
                                                             1)
    doc["rank"] = dist.get_rank()
    return doc


def main(argv=None) -> int:
    import torch

    from ..parallel import mesh as PM
    from ..utils import jsonio
    from ..utils.runtime import device_label, setup_torch
    from ._common import repo_root

    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else list(argv)))
    device = setup_torch(args.get("device"))
    on_card = device.type == "cuda"
    platform = "gpu" if on_card else device.type
    backend = args.get("backend", PM.default_backend(device))
    per_device = int(args.get("per_device", 16))
    fast = args.get("fast", "1") == "1"
    multi = "coordinator" in args
    num_hosts = int(args["num_processes"]) if multi else 1
    host_id = int(args["process_id"]) if multi else 0
    cards = torch.cuda.device_count() if on_card else 0
    n_local = int(args.get("n_devices", cards if on_card else 8))
    # dcn: the hosts. Real multi-host: their count; single host: simulated
    # hosts that split the ranks
    dcn = int(args["dcn"]) if "dcn" in args else (num_hosts if num_hosts > 1 else 0)
    n_avail = n_local * num_hosts
    if dcn >= 2 and n_avail % dcn:
        raise ValueError(f"{n_avail} devices not divisible by dcn={dcn}")

    cfg = dict(device=device.type, backend=backend, fast=fast, per_device=per_device, dcn=dcn,
               num_hosts=num_hosts)
    results = PM.launch(_bench_rank, n_local, args=(cfg,), device=device.type, backend=backend,
                        coordinator=args.get("coordinator"), num_hosts=num_hosts,
                        host_id=host_id)
    head = results[0]
    rates = head["rates"]
    for n, r in rates.items():
        print(f"{n} devices: B={per_device * n} -> {r:.1f} solves/s (converged_frac "
              f"{head['converged_frac'][n]:.4f}; launches by rank "
              f"{[res['launches'][n] for res in results if res['launches'][n] is not None]})")
    eff = PM.scaling_efficiency(rates)

    dcn_doc = None
    if dcn >= 2:
        per_host = n_avail // dcn
        d = head["dcn_rates"]
        if num_hosts > 1:
            dcn_doc = {"hosts": dcn, "per_host_devices": per_host,
                       "rate_full_mesh": round(d[dcn], 1),
                       "note": "divide by a single-host run's rate x hosts for efficiency"}
            print(f"dcn mesh {dcn}x{per_host}: {d[dcn]:.1f} solves/s")
        else:
            dcn_doc = {"hosts": dcn, "per_host_devices": per_host,
                       "rate_1_host": round(d[1], 1), "rate_full_mesh": round(d[dcn], 1),
                       "efficiency_vs_1_host": round(d[dcn] / (dcn * d[1]), 3)}
            print(f"dcn mesh {dcn}x{per_host}: {d[dcn]:.1f} solves/s "
                  f"(eff {dcn_doc['efficiency_vs_1_host']:.0%} vs 1 host)")

    doc = {
        "platform": platform,
        "n_devices": n_avail,
        "per_device": per_device,
        "fast_budget": fast,
        "rates": {str(k): round(v, 1) for k, v in rates.items()},
        "efficiency": eff,
        "backend": backend,
        "device": device_label(device) if on_card else platform,
        "converged_frac": {str(k): v for k, v in head["converged_frac"].items()},
        "launches": {str(n): [res["launches"][n] for res in results] for n in rates},
    }
    if dcn_doc is not None:
        doc["dcn"] = dcn_doc
    if not on_card:
        doc["note"] = ("CPU ranks share the host's cores: this run validates the sharded "
                       "program (the sharding and the collectives), not hardware scaling "
                       "efficiency")
    elif n_local > cards:
        doc["note"] = (f"{n_local} ranks share {cards} card(s) over {backend}: this run "
                       f"validates the sharded program, not hardware scaling efficiency")
    if "note" in doc:
        print("NOTE:", doc["note"])
    if "single_chip_batch_scaling" in head:
        for B, r in head["single_chip_batch_scaling"].items():
            print(f"B={B}: {r} solves/s (the main path, K1 and K2)")
        doc["single_chip_batch_scaling"] = head["single_chip_batch_scaling"]

    suffix = "_dcn" if (dcn >= 2 and num_hosts == 1) else ""
    out = args.get("out", os.path.join(repo_root(), "artifacts",
                                       f"torch_multichip_scaling_{platform}{suffix}.json"))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    jsonio.write_json(out, doc, indent=1)
    print(json.dumps({"rates": rates, "efficiency": eff}))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
