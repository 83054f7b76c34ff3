"""The lower readings of a solve cell's limits: the program's compared
problems over many seeds in one process, set up once, then the plain
reference's numbers for them.

    python3 mpcbench/readings.py record --workload <cell> --seed <first> --count <n> \\
        --seconds <s> --out <file.npz>
    python3 mpcbench/readings.py judge --file <file.npz> [--device cpu] [--jobs 4]

``record`` needs the card. For each seed it draws the cell's pool, drives
the timed path for ``--seconds`` at the cell's own load, as a run's window
does, and keeps the rows that a run's comparison reads (the compared
problems' plans at 1 kHz: tens of MB a seed). ``judge`` runs the reference
(float64) on each seed's problems and prints, as JSON lines, every number
the comparison gives, then the largest of each over the seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def solve_cell(workload: str, seed: int, device: str):
    """A solve cell's driver, as a run builds it, for ``seed``."""
    from mpcbench.drivers import solve
    from mpcbench.run import Cell, Context, load_json

    cell = Cell(load_json(ROOT, "BENCHMARK.json"), workload)
    args = types.SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    return solve.Cell(Context(cell, args, device))


def record(workload: str, seeds, seconds: float, out: str, device: str = "cuda"):
    """The compared rows of each seed in ``seeds`` (see the module), saved to ``out``."""
    from mpcbench import run

    run.cache_dirs()
    driver = solve_cell(workload, seeds[0], device)
    driver.setup()
    rows = {}
    for seed in seeds:
        driver.run.seed = seed
        driver.draw()
        driver.window(seconds)
        idx = driver.pick()
        for f, v in driver.program_rows(idx).items():
            rows[f"{seed}/{f}"] = v
        rows[f"{seed}/idx"] = np.asarray(idx)
        del driver.kept
    np.savez(out, workload=workload, seeds=np.asarray(seeds, np.int64), **rows)


def judge_seed(job):
    """The comparison's numbers for one seed's recorded rows."""
    import torch

    from mpcbench import compare
    from mpcbench.drivers.solve import reference_solve

    workload, seed, prog, idx, device = job
    torch.set_num_threads(1)
    driver = solve_cell(workload, seed, device)
    driver.draw()
    ref = reference_solve(driver.config, driver.host, driver.B, list(idx), device,
                          int(driver.traffic["check_block"]))
    return seed, compare.plan_gaps(prog, ref)


def judge(path: str, device: str = "cpu", jobs: int = 1):
    data = np.load(path)
    workload = str(data["workload"])
    fields = sorted({k.split("/", 1)[1] for k in data.files if "/" in k} - {"idx"})
    work = [(workload, int(s), {f: data[f"{s}/{f}"] for f in fields}, data[f"{s}/idx"], device)
            for s in data["seeds"]]
    if jobs > 1:
        import multiprocessing as mp

        with mp.get_context("spawn").Pool(jobs) as pool:
            results = pool.map(judge_seed, work)
    else:
        results = [judge_seed(w) for w in work]
    for seed, numbers in results:
        print(json.dumps({"workload": workload, "seed": seed, "numbers": numbers}), flush=True)
    largest = {k: max(n[k] for _, n in results) for k in results[0][1]}
    print(json.dumps({"workload": workload, "seeds": len(results), "largest": largest}))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="what", required=True)
    r = sub.add_parser("record")
    r.add_argument("--workload", required=True)
    r.add_argument("--seed", type=int, required=True)
    r.add_argument("--count", type=int, required=True)
    r.add_argument("--seconds", type=float, required=True)
    r.add_argument("--out", required=True)
    j = sub.add_parser("judge")
    j.add_argument("--file", required=True)
    j.add_argument("--device", default="cpu")
    j.add_argument("--jobs", type=int, default=1)
    a = p.parse_args(argv)
    if a.what == "record":
        import torch

        if not torch.cuda.is_available():
            print("[mpcbench] record needs a CUDA device", file=sys.stderr)
            return 2
        record(a.workload, [a.seed + i for i in range(a.count)], a.seconds, a.out)
    else:
        judge(a.file, a.device, a.jobs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
