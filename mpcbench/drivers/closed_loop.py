"""The closed-loop mix: batched MPC episodes through ``sim.rollout.rollout_mpc``
(a replan every ``plan_freq`` with K1 and K2, 1 kHz controller and physics
between, one CUDA-graph replay a substep), run back to back while the
window is open, every episode from the settled stand made once at set-up.

Traffic parameters: ``batch`` (episodes a call), ``warmup_steps`` (the
set-up's short rollout), ``trace_window`` and ``trace_windows`` (the
replanning windows of the traced episode that the profiler records),
``check_episodes`` and ``check_windows`` (episodes of the first call that
the reference follows from the start, over that many windows),
``check_steps`` (steps drawn across every episode of the window, each
followed one physics step from the program's recorded state).
"""

from __future__ import annotations

import time

import torch

from .. import compare, inputs, system
from .. import trace as T
from ..system import PROGRAM, REFERENCE

NQ_FEATURE = 26  # q[2:] starts here in the 43 state features (v, base xy wrt feet, q[2:])


def record_state(states, base):
    """(q, v) from the records: q = base xy then the features' q[2:], v the
    features' first nv entries."""
    nq_rest = states.shape[-1] - NQ_FEATURE
    nv = nq_rest + 2 - 1
    q = torch.cat([base[..., 0:2], states[..., NQ_FEATURE:]], dim=-1)
    return q, states[..., :nv]


def live_nonfinite(res) -> torch.Tensor:
    """Episodes whose records before their failure hold a non-finite entry."""
    T_ = res.states.shape[1]
    live = torch.arange(T_, device=res.states.device)[None] < res.fail_step[:, None].long()
    bad = torch.zeros_like(res.failed)
    for rec in (res.states, res.actions, res.base, res.com, res.contact_forces,
                res.contact_pos):
        nf = ~torch.isfinite(rec).reshape(rec.shape[0], T_, -1).all(-1)
        bad |= (nf & live).any(1)
    return bad.sum()


class Cell:
    def __init__(self, run):
        self.run = run
        self.config, self.traffic = run.config, run.traffic
        self.cl = self.config["closed_loop"]
        self.B = int(self.traffic["batch"])

    def build(self, pkg: str):
        """The loop's objects on one side: spec, simulator, solver settings."""
        g = self.cl["gait"]
        spec = system.spec(pkg, self.config, g, self.run.device)
        return (spec, system.sim_params(pkg, self.cl["contact"]),
                system.admm_config(pkg, g["rho"], self.cl["admm"]),
                system.ddp_config(pkg, self.config["ddp"]))

    def commands(self, k: int):
        dtype = getattr(torch, self.config["dtype"])
        return tuple(torch.as_tensor(a, dtype=dtype, device=self.run.device)
                     for a in inputs.episode_commands(self.traffic, self.run.seed, k))

    # ---- set-up: the settled stand, one short rollout ----
    def setup(self):
        g = self.cl["gait"]
        self.R = system.module(PROGRAM, "sim.rollout")
        self.KD = system.module(PROGRAM, "mpc.kino_dyn")
        physics = system.module(PROGRAM, "sim.physics")
        self.spec, self.sp, self.admm, self.ddp = self.build(PROGRAM)
        self.rcfg = self.R.RolloutConfig(
            episode_length=int(self.cl["episode_length"]), plan_freq=self.cl["plan_freq"],
            kp=g["kp"], kd=g["kd"], gait_period=g["gait_period"])
        model = self.spec.model
        dtype = getattr(torch, self.config["dtype"])
        q0 = system.robot(PROGRAM, self.config).q0()
        s0 = physics.SimState(q=torch.as_tensor(q0[None], dtype=dtype, device=self.run.device),
                              v=torch.zeros((1, model.nv), dtype=dtype, device=self.run.device))
        s = self.R.settle_state(model, tuple(self.spec.eff_frames), self.sp, s0, g["kp"], g["kd"],
                                ms=int(self.cl["settle_ms"]))
        self.start = physics.SimState(q=s.q.expand(self.B, -1).contiguous(),
                                      v=s.v.expand(self.B, -1).contiguous())
        warm = self.R.RolloutConfig(
            episode_length=int(self.traffic["warmup_steps"]), plan_freq=self.cl["plan_freq"],
            kp=g["kp"], kd=g["kd"], gait_period=g["gait_period"])
        self.R.rollout_mpc(self.spec, self.sp, warm, self.start, *self.commands(0),
                           admm_cfg=self.admm, ddp_cfg=self.ddp)

    def episode(self, k: int):
        return self.R.rollout_mpc(self.spec, self.sp, self.rcfg, self.start,
                                  *self.commands(k), admm_cfg=self.admm, ddp_cfg=self.ddp)

    # ---- the measured window ----
    def window(self, seconds: float) -> dict:
        self.results = []
        self.run.sync()
        t_start = time.perf_counter()
        while True:
            self.results.append(self.episode(len(self.results)))
            self.run.sync()
            t_end = time.perf_counter()
            if t_end - t_start >= seconds:
                break
        n = len(self.results)
        steps = n * self.B * self.rcfg.episode_length
        bad = sum(int(live_nonfinite(r)) for r in self.results)
        survival = [float(1.0 - r.failed.float().mean()) for r in self.results]
        self.run.note(f"window: {n} episodes of {self.B} x {self.rcfg.episode_length} steps in "
                      f"{t_end - t_start:.4f} s; survival by episode {survival}")
        return {"attempted": n * self.B, "failed": bad,
                "metrics": {"env_steps_per_s": steps / (t_end - t_start)}}

    # ---- the traced episode: each window's solve timed, a few windows profiled ----
    def traced(self, ctx):
        w0, nw = int(self.traffic["trace_window"]), int(self.traffic["trace_windows"])
        solve = self.KD.solve_mpc_batch
        spans = []
        prof = T.profiler()

        def timed(*a, **kw):
            w = len(spans)
            if w == w0:
                self.run.sync()
                prof.start()
            elif w == w0 + nw:
                self.run.sync()
                prof.stop()
            self.run.sync()
            t0 = time.perf_counter()
            plan = solve(*a, **kw)
            self.run.sync()
            spans.append(time.perf_counter() - t0)
            return plan

        self.KD.solve_mpc_batch = timed
        try:
            self.run.sync()
            t0 = time.perf_counter()
            self.episode(0)
            self.run.sync()
            episode_s = time.perf_counter() - t0
        finally:
            self.KD.solve_mpc_batch = solve
        ctx.trace = T.from_profiler(prof)
        ctx.spans["window_solve"] = spans
        ctx.counters["episode_s"] = episode_s
        ctx.counters["episode_steps"] = self.rcfg.episode_length
        ctx.counters["traced_windows"] = nw

    # ---- the comparison with the plain reference ----
    def check(self) -> dict:
        dev = self.run.device
        f64 = torch.float64
        seed, W = self.run.seed, int(self.traffic["check_windows"])
        spp = self.rcfg.steps_per_plan
        n_steps = W * spp
        # the first episode's head: the reference follows these episodes from the start
        res0 = self.results[0]
        eps = inputs.sample(seed, self.B, int(self.traffic["check_episodes"]))
        e_t = torch.as_tensor(eps, device=dev)
        q_head, v_head = record_state(res0.states[e_t, :n_steps].to(f64),
                                      res0.base[e_t, :n_steps].to(f64))
        start = (self.start.q[e_t].to(f64), self.start.v[e_t].to(f64))
        cmd = tuple(a[e_t].to(f64) for a in self.commands(0))
        # steps across every episode of the window, each followed one step
        gen = inputs.rng(seed, 3)
        n = int(self.traffic["check_steps"])
        T_ = self.rcfg.episode_length
        picks = []
        for k, b in zip(gen.integers(0, len(self.results), 4 * n), gen.integers(0, self.B, 4 * n)):
            fail = int(self.results[k].fail_step[b])
            hi = min(fail, T_ - 1)
            if hi > n_steps and len(picks) < n:
                picks.append((int(k), int(b), int(gen.integers(n_steps, hi))))
        rows = {"q": [], "v": [], "a": [], "q1": [], "v1": []}
        for k, b, s in picks:
            r = self.results[k]
            q, v = record_state(r.states[b, s:s + 2].to(f64), r.base[b, s:s + 2].to(f64))
            rows["q"].append(q[0])
            rows["v"].append(v[0])
            rows["q1"].append(q[1])
            rows["v1"].append(v[1])
            rows["a"].append(r.actions[b, s].to(f64))
        steps = {k: torch.stack(v) for k, v in rows.items()} if picks else None
        n_eps = len({(k, b) for k, b, _ in picks})
        del self.results  # the program's state goes before the reference runs
        self.run.free()
        out = {}
        t0 = time.perf_counter()
        ref_q, ref_v, plans = reference_head(self, start, cmd, W, f64)
        # each episode's largest gap, their upper quartile, and the number of episodes
        # past the cell's per-episode limit: an episode whose window solve stops one ADMM
        # iteration apart at the exit threshold (it happens) then follows a plan that
        # differs within the solver's tolerance, and the loop carries that apart; the
        # quartile reads the others, the count a fault of a few episodes
        per = (ref_q - q_head).abs().flatten(1).amax(1)
        per_v = (ref_v - v_head).abs().flatten(1).amax(1)
        out["loop_q"] = float(torch.quantile(per, 0.75))
        out["loop_v"] = float(torch.quantile(per_v, 0.75))
        out["loop_q_episodes"] = float((per > compare.load(self.run.cell.name)["episode_q"]).sum())
        t1 = time.perf_counter()
        self.run.note(f"the sampled episodes' largest gaps: q {float(per.max()):.4e}, v "
                      f"{float(per_v.max()):.4e}")
        # the episodes farthest from the reference, with the reference's solves of them
        for e in torch.argsort(per, descending=True)[:3].tolist():
            first = int(torch.nonzero((ref_q[e] - q_head[e]).abs().amax(-1) > 1e-4)[0, 0]) \
                if bool((ref_q[e] - q_head[e]).abs().amax() > 1e-4) else -1
            self.run.note(
                f"episode {int(eps[e])}: |dq| max {float(per[e]):.3e} (first past 1e-4 at step "
                f"{first}); the reference's ADMM iterations by window "
                f"{[int(p.admm_iters[e]) for p in plans]}, violations "
                f"{[float('%.3g' % float(p.dyn_violation[e])) for p in plans]}")
        if steps is not None:
            q1, v1 = reference_steps(self, steps, f64)
            out["step_q"] = float((q1 - steps["q1"]).abs().max())
            out["step_v"] = float((v1 - steps["v1"]).abs().max())
        self.run.note(f"compared {len(eps)} episodes over their first {W} windows "
                      f"({t1 - t0:.2f} s) and {len(picks)} single steps of {n_eps} episodes "
                      f"({time.perf_counter() - t1:.2f} s)")
        return out


def reference_head(cell, start, cmd, W: int, dtype, mode=None):
    """The reference loop over the first ``W`` windows from ``start`` with
    the commands ``cmd``, in ``dtype`` (under ``mode``, the control's
    precision): the recorded (q, v) of every step."""
    R = system.module(REFERENCE, "sim.rollout")
    ctl = system.module(REFERENCE, "sim.controllers")
    g = cell.cl["gait"]
    spec, sp, admm, ddp = cell.build(REFERENCE)
    cfg = R.RolloutConfig(episode_length=W * int(round(cell.cl["plan_freq"] / 0.001)),
                          plan_freq=cell.cl["plan_freq"], kp=g["kp"], kd=g["kd"],
                          gait_period=g["gait_period"])

    def go():
        return R.rollout_mpc(spec, sp, cfg, start[0].to(dtype), start[1].to(dtype),
                             cmd[0].to(dtype), cmd[1].to(dtype), admm, ddp,
                             ctl.IdControllerGains(kp=g["kp"], kd=g["kd"]))

    if mode is None:
        rec = go()
    else:
        with mode():
            rec = go()
    q, v = record_state(rec.states.double(), rec.base.double())
    return q, v, rec.plans


def reference_steps(cell, steps: dict, dtype):
    """One reference physics step from each recorded state with its
    recorded action (the pd_target encoding decoded to the applied
    torque): the next (q, v)."""
    physics = system.module(REFERENCE, "sim.physics")
    model = system.robot(REFERENCE, cell.config).load_model()
    g = cell.cl["gait"]
    sp = system.sim_params(REFERENCE, cell.cl["contact"])
    eff = tuple(system.robot(REFERENCE, cell.config).eff_names)
    q, v, a = (steps[k].to(dtype) for k in ("q", "v", "a"))
    tau = g["kp"] * (a - q[..., 7:]) - g["kd"] * v[..., 6:]
    new, _ = physics.step(model, eff, sp, physics.SimState(q, v), tau)
    return new.q.double(), new.v.double()
