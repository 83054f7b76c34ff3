"""The sharded solve mix: one caller whose every call solves a batch of
independent problems split over the cards, each rank its
``parallel.mesh.shard_batch`` shard through ``kino_dyn.solve_mpc_batch``
(K1 and K2 on every rank), then ``gather_batch`` brings every rank's plans
to every rank before the next call. The ranks are ``parallel.mesh.launch``'s
(one process a card, forked from the rank server, joined over NCCL).

Traffic parameters: as the solve mix (``batch`` is the whole call's batch,
split evenly over ``ranks``), and ``ranks``. The window, the traced slice
and the rows the comparison reads all run inside the ranks, in one launch;
the reference runs afterwards in this process, once the ranks have ended.
"""

from __future__ import annotations

import time

import numpy as np

from .. import compare, inputs, system
from ..system import PROGRAM, REFERENCE
from .solve import nonfinite_problems, pick, reference_solve


def _rank(cfg: dict) -> dict:
    """One rank: set-up, the window (rank 0 decides when it closes), the
    traced slice on rank 0 where asked, and rank 0's rows for the
    comparison."""
    import torch
    import torch.distributed as dist

    from mpcbench import trace as T

    PM = system.module(PROGRAM, "parallel.mesh")
    KD = system.module(PROGRAM, "mpc.kino_dyn")
    device = PM.rank_device(cfg["device"])
    on_card = device.type == "cuda"
    mesh = PM.batch_mesh(device=device)
    config, traffic = cfg["config"], cfg["traffic"]
    table = config["gait"]
    spec = system.spec(PROGRAM, config, table, device)
    admm = system.admm_config(PROGRAM, table["rho"], config["admm"])
    ddp = system.ddp_config(PROGRAM, config["ddp"])
    dtype = getattr(torch, config["dtype"])
    pool = [PM.shard_batch(mesh, tuple(torch.as_tensor(a, dtype=dtype) for a in batch))
            for batch in cfg["host"]]
    P = len(pool)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def call(i):
        return KD.solve_mpc_batch(spec, *pool[i % P], admm_cfg=admm, ddp_cfg=ddp,
                                  admm_backend="cuda", ik_backend="cuda")

    for i in range(2):  # the first call loads the kernels; every call has one shape
        PM.gather_batch(mesh, tuple(call(i)))
    sync()
    dist.barrier()
    t_setup = time.time()

    # the window: rank 0's clock closes it for every rank
    kept, lat = [None] * P, []
    bad = torch.zeros((), dtype=torch.int64, device=device)
    stop = torch.zeros(1, device=device)
    n = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        plan = call(n)
        full = PM.gather_batch(mesh, tuple(plan))
        sync()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        bad += nonfinite_problems(plan)
        if mesh.rank == 0:
            kept[n % P] = full
        n += 1
        stop.fill_(1.0 if t1 - t_start >= cfg["seconds"] else 0.0)
        dist.broadcast(stop, src=0)
        if float(stop) > 0:
            break
    sync()
    window_s = time.perf_counter() - t_start
    dist.all_reduce(bad)
    out = {"calls": n, "window_s": window_s, "lat": lat, "bad": int(bad), "t_setup": t_setup,
           "peak": int(torch.cuda.max_memory_allocated(device)) if on_card else 0}

    if cfg["trace"]:  # every rank profiles a slice of calls, each gather timed
        spans = []
        prof = None
        PM.gather_batch(mesh, tuple(call(0)))  # the allocator's blocks beside the kept plans
        sync()
        if on_card:
            prof = T.profiler()
            prof.start()
        for i in range(int(traffic["trace_calls"])):
            plan = call(i)
            sync()
            t0 = time.perf_counter()
            PM.gather_batch(mesh, tuple(plan))
            sync()
            spans.append(time.perf_counter() - t0)
        if prof is not None:
            prof.stop()
            trace = T.from_profiler(prof)
            out["busy_window_s"] = (trace.busy_s, trace.window_s)
            if mesh.rank == 0:  # the per-layer readings and the breakdown are rank 0's
                out["trace"] = trace
        out["gather_spans"] = spans

    if mesh.rank == 0:  # the compared rows of the gathered plans
        fields = list(type(plan)._fields)
        total = cfg["B"]
        idx = pick(cfg["seed"], traffic, total, [None if p is None else p[fields.index("admm_iters")]
                                                 for p in kept])
        rows = {f: np.stack([kept[i // total][fields.index(f)][i % total].double().cpu().numpy()
                             for i in idx]) for f in compare.PLAN_FIELDS + ("admm_iters",)}
        out["idx"], out["rows"] = idx, rows
    return out


class Cell:
    def __init__(self, run):
        self.run = run
        self.config, self.traffic = run.config, run.traffic
        self.R = int(self.traffic["ranks"])
        self.B = int(self.traffic["batch"])
        self.P = int(self.traffic["pool"])
        if self.B % self.R:
            raise ValueError(f"a batch of {self.B} does not split over {self.R} ranks")

    def setup(self):
        """The pool of whole batches on the host; the rank server starts
        importing PyTorch and the port. The ranks' own set-up is part of
        the launch, and counts in ``setup_s`` up to the window."""
        self.PM = system.module(PROGRAM, "parallel.mesh")
        self.PM.prestart()
        q0 = system.robot(REFERENCE, self.config).q0()
        self.host = [inputs.solve_batch(self.traffic, q0, self.run.seed, k) for k in range(self.P)]

    def window(self, seconds: float) -> dict:
        cfg = {"config": self.config, "traffic": self.traffic, "host": self.host,
               "seed": self.run.seed, "seconds": seconds, "device": self.run.device,
               "trace": bool(self.run.trace_on), "B": self.B}
        res = self.PM.launch(_rank, self.R, args=(cfg,), device=self.run.device)
        r0 = res[0]
        self.ranks = res
        lat_ms = np.asarray(r0["lat"]) * 1e3
        calls = r0["calls"]
        skew = max(r["window_s"] for r in res) - min(r["window_s"] for r in res)
        self.run.note(f"window: {calls} calls of {self.B} problems over {self.R} ranks in "
                      f"{r0['window_s']:.4f} s; call latency median {np.median(lat_ms):.4f} ms, "
                      f"p95 {np.percentile(lat_ms, 95):.4f} ms over {len(lat_ms)} calls; the "
                      f"ranks' windows differ by {skew:.4f} s")
        return {"attempted": calls * self.B, "failed": r0["bad"],
                "setup_s": max(r["t_setup"] for r in res) - self.run.t_process_wall,
                "memory_peak": max(r["peak"] for r in res),
                "metrics": {"solves_per_s": calls * self.B / r0["window_s"]}}

    def traced(self, ctx):
        r0 = self.ranks[0]
        ctx.trace = r0.get("trace")
        busy = [r["busy_window_s"] for r in self.ranks if "busy_window_s" in r]
        if busy:  # the device's busy and window seconds, averaged over the cards
            ctx.busy_s = sum(b for b, _ in busy) / len(busy)
            ctx.window_s = sum(w for _, w in busy) / len(busy)
        ctx.spans["gather"] = r0["gather_spans"]
        ctx.counters["solve_calls"] = len(r0["gather_spans"])

    def check(self) -> dict:
        r0 = self.ranks[0]
        ref = reference_solve(self.config, self.host, self.B, r0["idx"], self.run.device,
                              int(self.traffic["check_block"]))
        iters = ref["admm_iters"]
        self.run.note(f"compared {len(r0['idx'])} problems of the gathered plans; the "
                      f"reference's ADMM iterations max {int(iters.max())}, mean "
                      f"{iters.mean():.2f}; solves one ADMM iteration apart "
                      f"{int(np.sum(np.abs(r0['rows']['admm_iters'] - iters) == 1))}")
        return compare.plan_gaps(r0["rows"], ref)

    def close(self):
        self.PM.shutdown()
