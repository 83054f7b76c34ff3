"""Helpers of the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with tiny cells added as files and entries alone (the
way a later change adds a cell), and runs of it in a fresh process on the
CPU, where the program's kernels run their plain versions."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

# tiny cells: (name, config, traffic, traffic file to start from, changes,
# the cell whose limits it is held to)
SOLVE = ("solo12_trot.tiny_solve", "solo12_trot", "tiny_solve", "solve_b2048",
         dict(batch=4, pool=2, check_sample=3, check_hardest=1, check_block=8),
         "solo12_trot.solve_b2048")
GO2 = ("go2_trot.tiny_solve", "go2_trot", "tiny_solve", "solve_b512",
       dict(batch=3, pool=2, check_sample=2, check_hardest=1, check_block=8),
       "go2_trot.solve_b512")
LOOP = ("solo12_tiny.tiny_loop", "solo12_tiny", "tiny_loop", "closed_loop_b512",
        dict(batch=3, warmup_steps=50, check_episodes=2, check_windows=1, check_steps=4,
             control_steps=100),
        "solo12_trot.closed_loop_b512")

# the sharded solve has no cell of its own yet: its tiny cell is held to the one-card
# cell's limits (each rank solves what that cell solves) and reports the solve rate alone
SHARDED = ("solo12_trot.tiny_sharded", "solo12_trot", "tiny_sharded", "solve_4x2048",
           dict(batch=8, pool=2, check_sample=3, check_hardest=1, check_block=8),
           "solo12_trot.solve_b2048", ("solves_per_s",))


def make_checkout(dest: str, cells=(SOLVE, GO2, LOOP, SHARDED)) -> str:
    """``BENCHMARK.json`` and ``mpcbench/`` copied to ``dest``, the program
    linked beside them, and ``cells`` added: a traffic file, a limits file
    and a workload entry each (and for the loop a configuration of 100-step
    episodes from a 20 ms settle)."""
    shutil.copytree(BENCH, os.path.join(dest, "mpcbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "bunmpc_tpu_torch"), os.path.join(dest, "bunmpc_tpu_torch"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    mp = os.path.join(dest, "mpcbench")
    with open(os.path.join(mp, "configs", "solo12_trot.json")) as fh:
        cfg = json.load(fh)
    cfg["closed_loop"].update(episode_length=100, settle_ms=20)
    with open(os.path.join(mp, "configs", "solo12_tiny.json"), "w") as fh:
        json.dump(cfg, fh)
    bench["configs"].append({"name": "solo12_tiny", "source": "https://example.org/tiny",
                             "file": "mpcbench/configs/solo12_tiny.json", "reduced": [],
                             "why": "a test's short episodes"})
    for name, config, traffic, base, changes, limits, *metrics in cells:
        with open(os.path.join(mp, "traffic", f"{base}.json")) as fh:
            tr = json.load(fh)
        tr.update(changes)
        with open(os.path.join(mp, "traffic", f"{traffic}.json"), "w") as fh:
            json.dump(tr, fh)
        shutil.copy(os.path.join(mp, "limits", f"{limits}.json"),
                    os.path.join(mp, "limits", f"{name}.json"))
        bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test's tiny cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:  # the metrics of the cell it shrinks
            if limits in m.get("workloads", []) and (not metrics or m["name"] in metrics[0]):
                m["workloads"].append(name)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return dest


PRELUDE = """
import sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import faults
faults.apply({fault!r})
from mpcbench import run
sys.exit(run.main({argv!r}, device="cpu"))
"""


def run_cell(checkout: str, workload: str, seed: int = 2147483659, seconds: float = 1.0,
             fault: str | None = None, timeout: float = 600):
    """One run of ``workload`` in ``checkout`` on the CPU, with ``fault``
    (a name in ``faults.FAULTS``) planted in the program first: ``(exit
    code, the last line of standard output as a dict or None, standard
    error)``."""
    argv = ["--workload", workload, "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"]
    code = PRELUDE.format(root=checkout, tests=HERE, fault=fault, argv=argv)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True, text=True,
                       timeout=timeout, env=env)
    lines = p.stdout.strip().splitlines()
    last = None
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
    return p.returncode, last, p.stderr
