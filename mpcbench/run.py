"""Run one cell of the benchmark once and print its result line.

    python3 mpcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` (at the root of
the checkout): a configuration (``configs/<config>.json``) under a traffic
mix (``traffic/<traffic>.json``, whose ``driver`` names the generator in
``drivers/``). The run loads and warms up (``setup_s``), measures for
``--seconds``, compares what the timed path produced with the plain
reference (``reference/``, limits in ``limits/<cell>.json``) and prints one
JSON line: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by ``metrics/<metric>.py``
from a traced slice. It needs the card: without one, or with fewer cards
than the cell asks for, it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up counts from here: imports, build, warm-up
T_PROCESS_WALL = time.time()  # the same instant on the clock other processes read

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bunmpc_tpu")


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths. The
    port builds its kernels into ``build/bunmpc_tpu_torch/`` of the checkout
    (``bunmpc_tpu_torch/_build.py``); these cover what PyTorch itself might
    build."""
    base = os.path.join(ROOT, "build", "mpcbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_file(path: str, name: str):
    """A module from a file of its own (a driver or a metric reader)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """What BENCHMARK.json says of one cell, with its files read."""

    def __init__(self, bench: dict, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(ROOT, configs[self.entry["config"]]["file"])
        self.traffic = load_json(HERE, "traffic", f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if "workloads" not in m or workload in m["workloads"]]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]


class Context:
    """What a run hands its driver and the metric readers: the cell's
    files, the seed, notes for standard error, and after the traced slice
    its ``trace`` (``mpcbench.trace.Trace``), ``spans`` (name -> list of
    seconds) and ``counters`` (name -> number)."""

    def __init__(self, cell: Cell, args, device: str):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.device = args.seed, args.seconds, device
        self.trace_on = bool(getattr(args, "trace", 0))
        self.t_process_wall = T_PROCESS_WALL
        self.trace, self.spans, self.counters = None, {}, {}

    def sync(self):
        """Wait for the card (nothing to wait for on the CPU)."""
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def free(self):
        import torch

        if self.device != "cpu":
            torch.cuda.empty_cache()

    def note(self, msg: str):
        print(f"[mpcbench] {msg}", file=sys.stderr, flush=True)


def clean(v):
    """A number for the result line: non-finite values as null."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, device: str = "cuda") -> int:
    """One run. ``device="cpu"`` is for the benchmark's own tests: it skips
    the look for a card and runs the program's plain versions."""
    args = parse(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cell = Cell(bench, args.workload)
    cache_dirs()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    chips = int(cell.entry["chips"])
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"[mpcbench] the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 2
    from mpcbench import compare

    ctx = Context(cell, args, device)
    driver = importlib.import_module(f"mpcbench.drivers.{cell.traffic['driver']}").Cell(ctx)
    try:
        driver.setup()
        ctx.sync()
        setup_s = time.perf_counter() - T_PROCESS
        ctx.note(f"set-up {setup_s:.4f} s")
        result = driver.window(args.seconds)
        # a driver whose work runs in other processes reports their set-up and peak
        setup_s = result.get("setup_s", setup_s)
        memory_peak = result.get("memory_peak", torch.cuda.max_memory_allocated()
                                 if device == "cuda" else 0)
        if args.trace:
            driver.traced(ctx)
        numbers = driver.check()
    finally:
        if hasattr(driver, "close"):
            driver.close()
    correct, checks = compare.judge(numbers, compare.load_limits(cell.name))

    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(memory_peak)}
    line = {"correct": bool(correct), "attempted": int(result["attempted"]),
            "failed": int(result["failed"])}
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            reader = load_file(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                               "mpcbench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        # a run over several cards averages them (the driver sets these); one card: its trace
        dev["busy_s"] = getattr(ctx, "busy_s", ctx.trace.busy_s)
        dev["window_s"] = getattr(ctx, "window_s", ctx.trace.window_s)
        line["metrics"] = metrics
        line["device"] = dev
        line["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                             "idle_gaps": ctx.trace.idle_gaps()}
        for k, v in sorted(ctx.counters.items()):
            ctx.note(f"counter {k} = {v!r}")
    else:
        values = dict(result["metrics"], setup_s=setup_s)
        line["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                           for m in cell.end_to_end}
        line["device"] = dev
    found = forbidden_modules()
    if found:
        print(f"[mpcbench] the run loaded {found}: the port must run without JAX; no result",
              file=sys.stderr)
        return 3
    for name in sorted(set(numbers) - set(checks)):
        ctx.note(f"reading {name}: {numbers[name]!r} (no limit: not compared)")
    for name, c in checks.items():
        print(f"[mpcbench] check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"[mpcbench] correct: {bool(correct)}", file=sys.stderr, flush=True)
    line["checks"] = {k: {"value": clean(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
