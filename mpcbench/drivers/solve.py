"""The solve mix: one caller in a closed loop, each call a batch of
independent MPC problems through ``kino_dyn.solve_mpc_batch`` with the
kernels (K1, K2), waited for before the next is issued.

Traffic parameters: ``batch`` (problems a call), ``pool`` (batches drawn at
set-up and cycled through), ``lead`` (optional: problem 0 of each batch is
the robot's q0 at rest with this command), ``trace_calls`` (calls in the
traced slice), ``check_sample`` and ``check_hardest`` (problems the
comparison reads: a sample drawn from the seed, and the problems with the
most ADMM iterations), ``check_block`` (reference rows at a time).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, inputs, system, work
from .. import trace as T
from ..system import PROGRAM, REFERENCE


def nonfinite_problems(plan) -> torch.Tensor:
    """The number of problems whose plan holds a non-finite entry (a device
    scalar; nothing waits for it)."""
    ok = None
    for a in plan:
        if a.is_floating_point():
            f = torch.isfinite(a).reshape(a.shape[0], -1).all(1)
            ok = f if ok is None else ok & f
    return (~ok).sum()


def pick(seed: int, traffic: dict, B: int, iters) -> list:
    """The problems compared, as indices into the pool's batches of ``B``:
    a sample drawn from the seed over every batch that has a kept plan, and
    the problems with the most ADMM iterations (``iters``: each batch's
    iterations, or None where it has no plan)."""
    kept = [k for k, it in enumerate(iters) if it is not None]
    flat = inputs.sample(seed, len(kept) * B, int(traffic["check_sample"]))
    idx = {kept[i // B] * B + i % B for i in flat}
    every = torch.cat([iters[k].reshape(-1).double().cpu() for k in kept])
    hard = torch.argsort(every, descending=True, stable=True)[:int(traffic["check_hardest"])]
    idx |= {kept[int(i) // B] * B + int(i) % B for i in hard}
    return sorted(idx)


class Cell:
    def __init__(self, run):
        self.run = run
        self.config, self.traffic = run.config, run.traffic
        self.B = int(self.traffic["batch"])
        self.P = int(self.traffic["pool"])

    # ---- set-up: the spec, the pool of inputs on the card, one call per shape ----
    def draw(self):
        """The pool of input batches, from the seed: float64 arrays on the
        host (``host``) and on the device in the configuration's dtype
        (``pool``)."""
        q0 = system.robot(REFERENCE, self.config).q0()
        dtype = getattr(torch, self.config["dtype"])
        self.host = [inputs.solve_batch(self.traffic, q0, self.run.seed, k) for k in range(self.P)]
        self.pool = [tuple(torch.as_tensor(a, dtype=dtype, device=self.run.device) for a in batch)
                     for batch in self.host]

    def setup(self):
        cfg = self.config
        self.KD = system.module(PROGRAM, "mpc.kino_dyn")
        table = cfg["gait"]
        self.spec = system.spec(PROGRAM, cfg, table, self.run.device)
        self.admm = system.admm_config(PROGRAM, table["rho"], cfg["admm"])
        self.ddp = system.ddp_config(PROGRAM, cfg["ddp"])
        self.draw()
        for i in range(2):  # the first call loads the kernels; every call has one shape
            self.call(i)
        self.run.sync()

    def call(self, i: int):
        return self.KD.solve_mpc_batch(self.spec, *self.pool[i % self.P], admm_cfg=self.admm,
                                       ddp_cfg=self.ddp, admm_backend="cuda", ik_backend="cuda")

    # ---- the measured window ----
    def window(self, seconds: float) -> dict:
        lat, kept = [], [None] * self.P
        bad = torch.zeros((), dtype=torch.int64, device=self.run.device)
        n = 0
        self.run.sync()
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            plan = self.call(n)
            self.run.sync()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            bad += nonfinite_problems(plan)
            kept[n % self.P] = plan
            n += 1
            if t1 - t_start >= seconds:
                break
        self.run.sync()
        window_s = time.perf_counter() - t_start
        self.kept = kept
        lat_ms = np.asarray(lat) * 1e3
        self.run.note(f"window: {n} calls of {self.B} problems in {window_s:.4f} s; call latency "
                      f"median {np.median(lat_ms):.4f} ms, p95 "
                      f"{np.percentile(lat_ms, 95):.4f} ms over {len(lat_ms)} calls")
        return {
            "attempted": n * self.B,
            "failed": int(bad),
            "metrics": {"solves_per_s": n * self.B / window_s,
                        "solve_p95_ms": float(np.percentile(lat_ms, 95))},
        }

    # ---- the traced slice: per-layer readings ----
    def traced(self, ctx):
        n = int(self.traffic["trace_calls"])
        # one call first: the allocator's blocks for a call made beside the kept plans
        self.call(0)
        self.run.sync()
        iters = []
        with T.traced() as out:
            for i in range(n):
                iters.append(self.call(i).admm_iters)
                self.run.sync()
        ctx.trace = out[0]
        ctx.counters["solve_calls"] = n
        # the kernels' work: K1's iterations as the plans report them, with
        # the F-step FISTA iterations the kernel reports on the same inputs
        cuda_admm = system.module(PROGRAM, "solvers.cuda_admm")
        H, Hik = self.spec.horizon, self.spec.ik_hor
        m = self.spec.model.total_mass
        admm_it = fista_it = 0.0
        for i, it in enumerate(iters):
            prob = self.KD._prepare_problem(self.spec, *self.pool[i % self.P])
            fista = cuda_admm.fista_iterations(
                prob["plan"], m, prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"],
                prob["X_wm"], prob["F_wm"], prob["x_bounds"], self.admm, prob["F_ref"])
            admm_it += float(it.double().sum())
            fista_it += float(fista.double().sum())
        ctx.counters["k1_ops"] = work.admm_ops(admm_it, fista_it, H, self.admm.power_iters)
        ctx.counters["k1_bytes"] = n * work.admm_bytes(self.B, H)
        ctx.counters["k2_ops"] = work.ddp_ops(n * self.B, Hik, self.ddp.n_iters,
                                              len(self.ddp.alphas))
        ctx.counters["k2_bytes"] = work.ddp_bytes(n * self.B, Hik)
        ctx.counters["admm_iters_mean"] = admm_it / (n * self.B)
        ctx.counters["fista_iters_mean"] = fista_it / (n * self.B)

    # ---- the comparison with the plain reference ----
    def program_rows(self, idx):
        """The compared problems' plan fields, as float64 arrays."""
        fields = compare.PLAN_FIELDS + ("admm_iters",)
        out = {f: [] for f in fields}
        for i in idx:
            plan = self.kept[i // self.B]
            for f in fields:
                out[f].append(getattr(plan, f)[i % self.B].double().cpu().numpy())
        return {f: np.stack(v) for f, v in out.items()}

    def pick(self):
        return pick(self.run.seed, self.traffic, self.B,
                    [None if p is None else p.admm_iters for p in self.kept])

    def check(self) -> dict:
        idx = self.pick()
        prog = self.program_rows(idx)
        del self.kept, self.pool  # the program's state goes before the reference runs
        self.run.free()
        ref = reference_solve(self.config, self.host, self.B, idx, self.run.device,
                              int(self.traffic["check_block"]))
        iters = ref["admm_iters"]
        # the problem farthest from the reference in its forces, with both solves' iterations
        conv = ref["dyn_violation"] < compare.CONVERGED
        gap = np.abs(prog["F_opt"] - ref["F_opt"]).reshape(len(idx), -1).max(1)
        w = int(np.argmax(np.where(conv, gap, -1.0)))
        self.run.note(f"problem {idx[w]}: |dF| max {gap[w]:.4e}; ADMM iterations program "
                      f"{int(prog['admm_iters'][w])}, reference {int(iters[w])}; violations program "
                      f"{prog['dyn_violation'][w]:.6g}, reference {ref['dyn_violation'][w]:.6g}")
        self.run.note(
            f"compared {len(idx)} problems; the reference's ADMM iterations max {int(iters.max())}"
            f", mean {iters.mean():.2f}; converged: the reference "
            f"{np.mean(ref['dyn_violation'] < compare.CONVERGED):.4f}, the program "
            f"{np.mean(prog['dyn_violation'] < compare.CONVERGED):.4f}; solves one ADMM iteration "
            f"apart {int(np.sum(np.abs(prog['admm_iters'] - iters) == 1))}")
        return compare.plan_gaps(prog, ref)


def reference_solve(config: dict, host, B: int, idx, device, block: int, dtype=torch.float64,
                    mode=None) -> dict:
    """The plain reference on the compared problems ``idx`` (indices into
    the pool's batches ``host``, each problem's inputs rounded to the
    configuration's dtype first, as the program got them), computed in
    ``dtype`` on ``device`` in blocks of ``block`` rows: the plan fields and
    ``admm_iters`` as float64 arrays. ``mode`` (a context manager factory)
    wraps the solve: the control's precision."""
    RK = system.module(REFERENCE, "mpc.kino_dyn")
    table = config["gait"]
    spec = system.spec(REFERENCE, config, table, device)
    admm = system.admm_config(REFERENCE, table["rho"], config["admm"])
    ddp = system.ddp_config(REFERENCE, config["ddp"])
    stated = getattr(torch, config["dtype"])
    rows = [tuple(np.asarray(a)[i % B] for a in host[i // B]) for i in idx]
    fields = compare.PLAN_FIELDS + ("admm_iters",)
    out = {f: [] for f in fields}
    for s in range(0, len(rows), block):
        part = rows[s:s + block]
        args = [torch.as_tensor(np.stack([r[j] for r in part]), dtype=stated).to(
            device=device, dtype=dtype) for j in range(5)]
        if mode is None:
            plan = RK.solve_mpc_batch(spec, *args, admm_cfg=admm, ddp_cfg=ddp)
        else:
            with mode():
                plan = RK.solve_mpc_batch(spec, *args, admm_cfg=admm, ddp_cfg=ddp)
        for f in fields:
            out[f].append(getattr(plan, f).double().cpu().numpy())
    return {f: np.concatenate(v) for f, v in out.items()}
