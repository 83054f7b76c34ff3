"""Device meshes, sharding helpers and the launcher of the ranks.

Counterpart of ``bunmpc_tpu/parallel/mesh.py``. The JAX package drives every
device of a ``jax.sharding.Mesh`` from one Python thread and lets XLA insert
the collectives. The port runs one process per device instead, a *rank*,
joined to the others in a ``torch.distributed`` process group: the port's
main path is bound by the host's dispatch (nearly every launch of a solve is
a small PyTorch kernel around K1 and K2), so one host thread dispatching for
several cards would make each card wait its turn.

* ``launch(fn, n_ranks, args)`` starts the ranks (one per device), joins
  them in the process group, runs ``fn(*args)`` in each and returns each
  rank's result, its tensors as numpy arrays. The ranks are forked from a
  server process (``multiprocessing``'s forkserver) that has imported
  PyTorch and the port once and never touches a device; ``prestart`` starts
  it ahead of time, so that its imports overlap the caller's work.
* Inside the ranks, ``batch_mesh`` and ``multihost_mesh`` build a ``Mesh``
  over them. Every rank of the group calls them, in the same order: a mesh
  over some of the ranks is a subgroup, and making one is a collective of
  the whole group.
* ``shard_batch`` and ``shard_batch_2d`` give a rank its slice of every
  leading axis, on its device; ``replicate`` broadcasts the mesh's first
  rank's values; ``gather_batch`` puts the whole batch together on every
  rank, as reading a sharded JAX array back gives it.

The backend is chosen explicitly: NCCL for CUDA devices and gloo for the CPU,
unless ``backend`` names another. gloo also carries CUDA tensors (through
the host; it broadcasts and all-reduces them, and nothing here needs more),
and it is what several ranks on one card need: NCCL refuses two ranks on
one GPU. Nothing changes one backend or one device for another without
being asked to.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXES = ("batch",)
MULTIHOST_AXES = ("dcn", "ici")
# What the rank server imports once for every rank it forks: the caller's
# main module, the port's solve and trainer, and ``torch._dynamo``, which
# the first optimiser a process builds imports (torch's and dynamo's imports
# take seconds each in a fresh process: a spawned rank paid them every time)
RANK_PRELOAD = ("__main__", "bunmpc_tpu_torch.mpc.kino_dyn", "bunmpc_tpu_torch.learning.bc",
                "torch._dynamo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of ranks as one process of it sees it: the axis names and the
    ranks along each axis (``shape``), the global ranks of the mesh in
    row-major (dcn-major) order, this process's index among them (None where
    it is not one of them), its device, the backend and the process group
    of the mesh's collectives."""

    axis_names: tuple
    shape: tuple
    ranks: tuple
    rank: int | None
    device: torch.device
    backend: str
    group: object = dataclasses.field(compare=False, repr=False)

    @property
    def size(self) -> int:
        return len(self.ranks)


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' for CPU ranks")
    return device if device.index is not None else torch.device("cuda",
                                                                torch.cuda.current_device())


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with parallel.mesh.launch (or "
                           "torchrun and torch.distributed.init_process_group)")
    return dist.get_world_size()


def _make_mesh(ranks, shape, axis_names, device, backend) -> Mesh:
    world = _world_size()
    ranks = tuple(int(r) for r in ranks)
    if list(ranks) != sorted(set(ranks)) or not ranks or ranks[0] < 0 or ranks[-1] >= world:
        raise ValueError(f"mesh ranks {ranks}: distinct, ascending ranks of the "
                         f"{world}-rank group")
    device = rank_device(device)
    backend = backend or default_backend(device)
    if ranks == tuple(range(world)) and backend == dist.get_backend():
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(ranks), backend=backend)
    me = dist.get_rank()
    return Mesh(axis_names=axis_names, shape=tuple(shape), ranks=ranks,
                rank=ranks.index(me) if me in ranks else None, device=device,
                backend=str(backend), group=group)


def batch_mesh(n_devices: int | None = None, device="cuda", backend: str | None = None) -> Mesh:
    """1-D data-parallel mesh (axis ``batch``) over the first ``n_devices``
    ranks of the process group (all of them by default), on this rank's
    ``device`` (``"cuda"``: the card the launcher gave the rank), with
    ``backend`` (NCCL on CUDA devices, gloo on the CPU by default)."""
    world = _world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"batch_mesh: {n} devices of a {world}-rank group")
    return _make_mesh(range(n), (n,), BATCH_AXES, device, backend)


def _num_hosts() -> int:
    """The hosts of the process group: its ranks over the ranks of one host
    (``LOCAL_WORLD_SIZE``, which ``launch`` and torchrun set)."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None:
        raise RuntimeError("LOCAL_WORLD_SIZE is not set (launch and torchrun set it): pass dcn=")
    return max(_world_size() // int(local), 1)


def multihost_mesh(dcn: int | None = None, devices=None, device="cuda",
                   backend: str | None = None) -> Mesh:
    """2-D (``dcn``, ``ici``) mesh for multi-host runs: the leading axis spans
    the hosts, the trailing axis the ranks of one host, dcn-major. Shardings
    over both axes (``shard_batch_2d``) keep a rank's shard where the 1-D
    mesh over the same ranks puts it.

    * Real multi-host (``launch(..., coordinator=, num_hosts=, host_id=)`` on
      every host): ``dcn`` defaults to the number of hosts.
    * Single-host validation: pass ``dcn`` to split the ranks into simulated
      hosts (``scripts/bench_multichip.py dcn=``).

    ``devices`` are the global ranks of the mesh (all of them by default),
    the port's counterpart of the JAX function's device list."""
    ranks = tuple(range(_world_size())) if devices is None else tuple(devices)
    if dcn is None:
        dcn = _num_hosts()
    if dcn < 1 or len(ranks) % dcn:
        raise ValueError(f"{len(ranks)} devices not divisible by dcn={dcn}")
    return _make_mesh(ranks, (dcn, len(ranks) // dcn), MULTIHOST_AXES, device, backend)


def _tree_map(fn, tree):
    """``fn`` on every tensor and numpy array of a tree of tuples (named ones
    too), lists and dicts; other leaves are returned as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    return tree


def _leaves(tree) -> list:
    out = []
    _tree_map(out.append, tree)
    return out


def _member(mesh: Mesh, what: str) -> None:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{what}: mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if mesh.rank is None:
        raise ValueError(f"{what}: this process (rank {dist.get_rank()}) is not a rank of the "
                         f"mesh {mesh.ranks}")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """What a collective carries for ``t`` (bool tensors as their bytes)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _shard(mesh: Mesh, tree, axes: tuple, what: str):
    _member(mesh, what)
    if mesh.axis_names != axes:
        raise ValueError(f"{what}: needs a mesh with axes {axes}, got {mesh.axis_names}")

    def take(a):
        if a.ndim == 0 or a.shape[0] % mesh.size:
            raise ValueError(f"{what}: a leading axis of shape {tuple(a.shape)} does not split "
                             f"over {mesh.size} devices (pad_to_devices)")
        k = a.shape[0] // mesh.size
        part = a[mesh.rank * k:(mesh.rank + 1) * k]
        return torch.as_tensor(part).to(mesh.device)

    return _tree_map(take, tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's part of every leading (batch) axis of a tree of tensors or
    arrays, on its device: the ``batch`` mesh's shard ``rank`` of ``size``
    equal ones (the JAX function's ``P("batch")``). A leading axis that does
    not split evenly raises ValueError, as the JAX sharding does."""
    return _shard(mesh, tree, BATCH_AXES, "shard_batch")


def shard_batch_2d(mesh: Mesh, tree):
    """This rank's part of every leading axis over a (``dcn``, ``ici``) mesh,
    partitioned over both axes dcn-major (the JAX function's
    ``P(("dcn", "ici"))``): hierarchical data parallelism."""
    return _shard(mesh, tree, MULTIHOST_AXES, "shard_batch_2d")


def replicate(mesh: Mesh, tree):
    """Every tensor or array of a tree, as the mesh's first rank holds it,
    on this rank's device (a broadcast; parameters, optimiser state)."""
    _member(mesh, "replicate")

    def bcast(a):
        t = torch.as_tensor(a).to(mesh.device, copy=True).contiguous()
        dist.broadcast(_wire(t), src=mesh.ranks[0], group=mesh.group)
        return t

    return _tree_map(bcast, tree)


def gather_batch(mesh: Mesh, tree):
    """The whole batch of a sharded tree on every rank of the mesh, on its
    device: the shards concatenated in mesh order (what reading a sharded
    JAX array back to the host gives). Each shard goes out by a broadcast
    from its rank, which NCCL and gloo (on CUDA tensors too) both carry. The
    shards of a leaf must have one shape on every rank (``shard_batch``
    makes them so); otherwise every rank raises ValueError."""
    _member(mesh, "gather_batch")
    shapes = tuple(tuple(a.shape) for a in _leaves(tree))
    key = hash(shapes) & (1 << 62) - 1  # a tuple of ints hashes alike in every process
    seen = torch.tensor([key, -key], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(seen, op=dist.ReduceOp.MAX, group=mesh.group)
    if int(seen[0]) != -int(seen[1]):
        raise ValueError(f"gather_batch: the shards' shapes differ between ranks (rank "
                         f"{mesh.rank}: {list(shapes)})")

    def gather(a):
        mine = torch.as_tensor(a).to(mesh.device).contiguous()
        parts = []
        for j, src in enumerate(mesh.ranks):
            buf = mine if j == mesh.rank else torch.empty_like(mine)
            dist.broadcast(_wire(buf), src=src, group=mesh.group)
            parts.append(buf)
        return torch.cat(parts)

    return _tree_map(gather, tree)


def pad_to_devices(arr: np.ndarray, n_devices: int):
    """Pad the leading axis to a multiple of the device count (returns the
    padded array and the original length)."""
    n = arr.shape[0]
    rem = (-n) % n_devices
    if rem:
        arr = np.concatenate([arr, np.repeat(arr[-1:], rem, axis=0)], axis=0)
    return arr, n


def scaling_efficiency(solves_per_sec: dict[int, float]) -> dict[int, float]:
    """Scaling efficiency vs the smallest device count (BASELINE.md target:
    >= 85% at 4 hosts)."""
    base_n = min(solves_per_sec)
    base = solves_per_sec[base_n] / base_n
    return {n: (v / n) / base for n, v in solves_per_sec.items()}


# ---- the launcher ----


def _to_host(tree):
    return _tree_map(lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a,
                     tree)


def _rank_main(fn, args, rank, local_rank, n_local, world, device, backend, init_method,
               timeout, results):
    """One rank: join the process group, run ``fn(*args)``, send its result
    (or the traceback) to the launcher."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(local_rank), WORLD_SIZE=str(world),
                      LOCAL_WORLD_SIZE=str(n_local))
    torch.set_num_threads(1)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        msg = (local_rank, True, _to_host(fn(*args)))
    except BaseException:  # noqa: BLE001  (reported to the launcher, which raises)
        msg = (local_rank, False, traceback.format_exc())
    results.put(msg)
    if msg[1] and dist.is_initialized():
        dist.destroy_process_group()


def _rank_context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(list(RANK_PRELOAD))
    return ctx


def prestart() -> None:
    """Start the rank server now (it imports ``RANK_PRELOAD`` in the
    background); ``launch`` starts it at its first call otherwise."""
    from multiprocessing import forkserver

    _rank_context()
    forkserver.ensure_running()


def shutdown() -> None:
    """Stop the rank server now (it ends a little after this process does
    otherwise; a caller that must leave no process behind calls this last).
    ``launch`` starts a new one if called again.

    ``multiprocessing.forkserver`` has no public way to stop its server; this
    calls CPython's own hook for that, ``_forkserver._stop`` (CPython 3.8 and
    later; checked on 3.12), and raises where this Python has none."""
    from multiprocessing import forkserver

    stop = getattr(getattr(forkserver, "_forkserver", None), "_stop", None)
    if stop is None:
        raise RuntimeError(
            f"parallel.mesh.shutdown: this Python ({sys.version.split()[0]}) has no "
            "multiprocessing.forkserver._forkserver._stop; the rank server ends when this "
            "process exits")
    stop()


def launch(fn, n_ranks: int | None = None, args=(), device="cuda", backend: str | None = None,
           coordinator: str | None = None, num_hosts: int = 1, host_id: int = 0,
           timeout: float = 1800.0) -> list:
    """Run ``fn(*args)`` in ``n_ranks`` processes on this host, one per
    device, joined in one process group; returns their results in rank
    order (tensors as numpy arrays). ``fn`` is a module-level function, its
    arguments and result picklable; each rank computes with one host thread.
    The ranks are forked from the rank server (``prestart``), which holds no
    thread and no device, so no rank inherits a CUDA context.

    On ``device="cuda"`` rank ``i`` runs on card ``i`` modulo the card count
    (``n_ranks`` defaults to the card count); NCCL needs a card per rank and
    raises otherwise, gloo may put several ranks on one card. On
    ``device="cpu"`` give ``n_ranks``; the backend is gloo. The backend
    (``backend``, else NCCL on CUDA and gloo on the CPU) and the layout are
    printed.

    One host rendezvous through a file in a fresh temporary directory.
    Several hosts: run the same call on each with ``coordinator``
    (``host:port`` of host 0, which serves the rendezvous), ``num_hosts`` and
    ``host_id``; the global rank is ``host_id * n_ranks + i``.

    A rank that raises, dies or outlives ``timeout`` seconds stops every rank
    of this host and raises RuntimeError with its traceback."""
    dev_type = torch.device(device).type
    backend = backend or default_backend(device)
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("launch: CUDA device requested but torch.cuda.is_available() is "
                               "False; pass device='cpu' for CPU ranks")
        cards = torch.cuda.device_count()
        n_ranks = cards if n_ranks is None else int(n_ranks)
        if backend == "nccl" and n_ranks > cards:
            raise ValueError(f"launch: NCCL needs a card per rank ({n_ranks} ranks, {cards} "
                             f"cards); pass backend='gloo' for several ranks on one card")
        devices = [f"cuda:{i % cards}" for i in range(n_ranks)]
    else:
        if n_ranks is None:
            raise ValueError("launch: on the CPU, n_ranks says how many ranks to start")
        if backend == "nccl":
            raise ValueError("launch: NCCL needs CUDA devices; CPU ranks use gloo")
        devices = [dev_type] * int(n_ranks)
    n_ranks = len(devices)
    if n_ranks < 1 or not 0 <= host_id < num_hosts:
        raise ValueError(f"launch: {n_ranks} ranks, host {host_id} of {num_hosts}")
    tmp = None
    if coordinator is None:
        if num_hosts != 1:
            raise ValueError("launch: several hosts rendezvous at a coordinator (host:port)")
        tmp = tempfile.mkdtemp(prefix="bunmpc_rendezvous_")
        init_method = "file://" + os.path.join(tmp, "store")
    else:
        init_method = f"tcp://{coordinator}"
    world = num_hosts * n_ranks
    print(f"[parallel] launch: {n_ranks} ranks on host {host_id} of {num_hosts}, backend "
          f"{backend}, devices {', '.join(devices)}", flush=True)

    ctx = _rank_context()
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, tuple(args), host_id * n_ranks + i, i, n_ranks, world, devices[i], backend,
        init_method, timeout, results)) for i in range(n_ranks)]
    out, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n_ranks and not errors:
            try:
                i, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                gone = [i for i, p in enumerate(procs) if p.exitcode is not None and i not in out]
                if gone:  # a message sent just before the exit is in the pipe: drain it
                    try:
                        i, ok, payload = results.get(timeout=2.0)
                    except queue.Empty:
                        errors.update({i: f"exited with code {procs[i].exitcode} and no result"
                                       for i in gone})
                        continue
                elif time.monotonic() > deadline:
                    errors.update({i: f"no result after {timeout:.0f} s" for i in range(n_ranks)
                                   if i not in out})
                    continue
                else:
                    continue
            if ok:
                out[i] = payload
            else:
                errors[i] = payload
        if errors:
            raise RuntimeError("launch: " + "\n".join(
                f"rank {host_id * n_ranks + i} failed:\n{msg}"
                for i, msg in sorted(errors.items())))
    finally:
        for p in procs:
            p.join(timeout=0.5 if errors else 30.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [out[i] for i in range(n_ranks)]
