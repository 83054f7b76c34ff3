"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the nearest precision below the one the
configuration states (float32 with its matrix products in TF32,
``mpcbench.precision``), at the cell's own size, then judged by the same
comparison and limits as a run. It has to come out not correct.

    python3 mpcbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

Prints, per seed, each compared number beside its limit and a JSON line
``{"control": ..., "seed": ..., "correct": ..., "numbers": {...}}``. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def solve_control(cell, device: str, mode):
    """Fill a solve cell's kept plans with the reference's, in the program's
    place: every batch of the pool, whole, in float32 under ``mode``."""
    import torch

    from mpcbench.drivers.solve import reference_solve

    cell.draw()
    kept = []
    for k in range(cell.P):
        idx = range(k * cell.B, (k + 1) * cell.B)
        out = reference_solve(cell.config, cell.host, cell.B, idx, device, cell.B,
                              dtype=getattr(torch, cell.config["dtype"]), mode=mode)
        kept.append(types.SimpleNamespace(**{f: torch.as_tensor(v) for f, v in out.items()}))
    cell.kept = kept


def closed_loop_control(cell, device: str, mode):
    """Fill a closed-loop cell's window with the reference's episode, in the
    program's place: its own settle and one episode of the cell's batch, in
    float32 under ``mode``, ``control_steps`` long (the traffic's: enough
    for the windows and the single steps the comparison reads; the plain
    loop in TF32 runs every solve to the ADMM's cap)."""
    import torch

    from mpcbench import system

    R = system.module("mpcbench.reference", "sim.rollout")
    ctl = system.module("mpcbench.reference", "sim.controllers")
    physics = system.module("mpcbench.reference", "sim.physics")
    g = cell.cl["gait"]
    dtype = getattr(torch, cell.config["dtype"])
    spec, sp, admm, ddp = cell.build("mpcbench.reference")
    cell.rcfg = R.RolloutConfig(episode_length=int(cell.traffic["control_steps"]),
                                plan_freq=cell.cl["plan_freq"], kp=g["kp"], kd=g["kd"],
                                gait_period=g["gait_period"])
    q0 = system.robot("mpcbench.reference", cell.config).q0()
    with mode():
        q, v = R.settle_state(spec.model, tuple(spec.eff_frames), sp,
                              torch.as_tensor(q0[None], dtype=dtype, device=device),
                              torch.zeros((1, spec.model.nv), dtype=dtype, device=device),
                              g["kp"], g["kd"], ms=int(cell.cl["settle_ms"]))
        cell.start = physics.SimState(q=q.expand(cell.B, -1).contiguous(),
                                      v=v.expand(cell.B, -1).contiguous())
        rec = R.rollout_mpc(spec, sp, cell.rcfg, cell.start.q, cell.start.v, *cell.commands(0),
                            admm, ddp, ctl.IdControllerGains(kp=g["kp"], kd=g["kd"]))
    cell.results = [rec]


CONTROLS = {"solve": solve_control, "closed_loop": closed_loop_control}


def run_control(workload: str, seed: int, device: str = "cuda") -> dict:
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from mpcbench import compare, precision
    from mpcbench.run import Cell, Context, load_json

    cell = Cell(load_json(ROOT, "BENCHMARK.json"), workload)
    args = types.SimpleNamespace(seed=seed, seconds=0.0)
    ctx = Context(cell, args, device)
    kind = cell.traffic["driver"]
    # the sharded solve's comparison reads the gathered plans as one batch: its control is
    # the whole batch's, as the solve mix compares it
    kind = "solve" if kind == "sharded_solve" else kind
    driver = importlib.import_module(f"mpcbench.drivers.{kind}").Cell(ctx)
    CONTROLS[kind](driver, device, precision.tf32_products)
    numbers = driver.check()
    correct, checks = compare.judge(numbers, compare.load_limits(workload))
    for name, c in checks.items():
        ctx.note(f"control check {name}: {c['value']!r} (limit {c['limit']!r})")
    return {"control": "tf32", "workload": workload, "seed": seed, "correct": bool(correct),
            "numbers": {k: float(v) for k, v in numbers.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    for seed in args.seed:
        print(json.dumps(run_control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
