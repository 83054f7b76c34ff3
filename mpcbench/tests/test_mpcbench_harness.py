"""The harness on the CPU: BENCHMARK.json against the benchmark's
contract, a cell added as files and entries alone found by name, the result
line's schema, the trace arithmetic on a synthetic trace, and the frozen
work counts against ``chip_smoke.py``'s."""

import hashlib
import importlib.util
import json
import math
import os
import re
import sys
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import tiny  # noqa: E402

from mpcbench import trace as T  # noqa: E402
from mpcbench import work  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(line_ok(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("mpcbench/") and os.path.isfile(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    cells = []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        assert os.path.isfile(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(BENCH, "limits", f"{w['name']}.json"))
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert {w["config"] for w in b["workloads"]} == set(names)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    metric_names = []
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        e2e[m["name"]] = m
        metric_names.append(m["name"])
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_ok(m["layer"]) and m["moves"] in e2e
        assert os.path.isfile(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        for c in m.get("workloads", cells):
            assert c in cells and c in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        metric_names.append(m["name"])
    assert len(set(metric_names)) == len(metric_names)
    for c in cells:  # every cell: setup_s, another end-to-end metric, a per-layer metric
        assert sum(c in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
        assert any(c in m.get("workloads", cells) for m in b["per_layer"])
    layers = {}
    for m in b["per_layer"]:  # one layer, one name, letter for letter
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    assert len(json.dumps(b)) <= 64 * 1024


def test_run_seconds_fit_a_full_check():
    s = bench()["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def digest(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("checkout")))


def test_a_cell_added_as_files_alone_runs_by_name(checkout):
    # nothing the benchmark already has changes: only files and entries are added
    for d, _, files in os.walk(BENCH):
        if "tests" in d or "__pycache__" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), ROOT)
            assert digest(os.path.join(checkout, rel)) == digest(os.path.join(ROOT, rel)), rel
    rc, last, err = tiny.run_cell(checkout, tiny.SOLVE[0])
    assert rc == 0, err[-3000:]
    assert last is not None and last["correct"] is True, err[-3000:]


def test_the_result_line(checkout):
    rc, last, err = tiny.run_cell(checkout, tiny.GO2[0])
    assert rc == 0, err[-3000:]
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert isinstance(last["correct"], bool) and last["attempted"] == 3 * (last["attempted"] // 3)
    assert last["failed"] == 0
    assert set(last["metrics"]) == {"solves_per_s", "solve_p95_ms", "setup_s"}
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(last["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in last["checks"].values():
        assert set(c) == {"value", "limit"}
    # the compared numbers are also the last lines of standard error, each beside its limit
    tail = err.strip().splitlines()[-len(last["checks"]) - 1:]
    assert tail[-1] == f"[mpcbench] correct: {last['correct']}"
    assert all("(limit " in t for t in tail[:-1])


def test_no_card_no_result():
    import subprocess

    p = subprocess.run([sys.executable, "mpcbench/run.py", "--workload", "solo12_trot.solve_b2048",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert p.returncode != 0 and p.stdout.strip() == ""


def synthetic():
    dev = [T.Interval(10, 20, "admm_kernel(bk::AdmmParams<float>, int)"),
           T.Interval(15, 30, "void ddp_kernel<12>(int, int)"),
           T.Interval(50, 60, "void at::native::elementwise_kernel<128, 2>(int)"),
           T.Interval(70, 75, "Memcpy HtoD (Pageable -> Device)")]
    host = [T.Interval(0, 100, "outer"), T.Interval(30, 50, "aten::add"),
            T.Interval(60, 68, "aten::mul"), T.Interval(80, 100, "cudaStreamSynchronize")]
    return T.Trace(dev, host)


def test_trace_arithmetic():
    t = synthetic()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(35e-6)  # [10, 30] + [50, 60] + [70, 75]
    assert t.idle_pct() == pytest.approx(65.0)
    assert T.gaps(t.device, t.t0, t.t1) == [(0, 10), (30, 50), (60, 70), (75, 100)]
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"outer": 10e-6, "aten::add": 20e-6, "aten::mul": 10e-6,
                                  "cudaStreamSynchronize": 25e-6})
    assert [k.name for k in t.kernels("ddp_kernel")] == ["void ddp_kernel<12>(int, int)"]
    assert [k.name for k in t.kernels("admm_kernel")] == ["admm_kernel(bk::AdmmParams<float>, int)"]
    assert t.device_ops()[0][1] == pytest.approx(15e-6)


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_metric_readers_on_a_synthetic_trace():
    ctx = types.SimpleNamespace(trace=synthetic(), spans={"window_solve": [0.1, 0.3]},
                                counters={"solve_calls": 2, "k1_ops": 67e12 * 5e-6,
                                          "k1_bytes": 1.0, "k2_ops": 1.0,
                                          "k2_bytes": 3.35e12 * 3e-6, "episode_s": 1.4,
                                          "episode_steps": 1000, "traced_windows": 2})
    assert reader("launches_per_solve.solve").read(ctx) == 1.5
    assert reader("k1_ms.solve").read(ctx) == pytest.approx(0.010)
    assert reader("k2_ms.solve").read(ctx) == pytest.approx(0.015)
    assert reader("k1_roofline").read(ctx) == pytest.approx(50.0)  # 5 us of 10 us, by operations
    assert reader("k2_roofline").read(ctx) == pytest.approx(20.0)  # 3 us of 15 us, by bytes
    assert reader("device_idle_pct.solve").read(ctx) == pytest.approx(65.0)
    assert reader("device_idle_pct.closed_loop").read(ctx) == pytest.approx(65.0)
    assert reader("gather_ms.solve").read(types.SimpleNamespace(
        trace=None, spans={"gather": [0.002, 0.004]}, counters={})) == pytest.approx(3.0)
    assert reader("window_solve_ms.closed_loop").read(ctx) == pytest.approx(200.0)
    assert reader("substep_ms.closed_loop").read(ctx) == pytest.approx(1.0)
    empty = types.SimpleNamespace(trace=None, spans={}, counters={})
    for f in os.listdir(os.path.join(BENCH, "metrics")):
        assert reader(f[:-3]).read(empty) is None, f  # nothing to read: nothing returned


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("H,Hik", [(20, 10)])
def test_work_counts_are_chip_smokes(H, Hik):
    cs = chip_smoke()
    import torch

    cfg = types.SimpleNamespace(power_iters=8, n_iters=6, alphas=(1.0, 0.7, 0.3, 0.1, 0.03))
    iters, fista = torch.tensor([30.0, 41.0, 100.0]), torch.tensor([300.0, 410.0, 3000.0])
    assert work.admm_ops(float(iters.sum()), float(fista.sum()), H) == cs.admm_ops(iters, fista, H,
                                                                                  cfg)
    for B in (512, 2048):
        assert work.ddp_ops(B, Hik) == cs.ddp_ops(B, Hik, cfg)
        assert work.ddp_bytes(B, Hik) == cs.ddp_bytes(B, Hik)
        nX, nF = (H + 1) * 9, H * 12
        assert work.admm_bytes(B, H) == 4.0 * B * (H * 4 + nF + H + 9 + 5 * nX + 3 * nF + nX + nF + 2)
    assert work.ddp_ops(512, 10, nj=8) == cs.ddp_ops(512, 10, cfg, nj=8)
    assert work.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert cs.bound_ms(3.35e12, 1.0)[0] == pytest.approx(1e3)
    assert math.isclose(work.F32_FLOPS, cs.H100_F32_FLOPS) and math.isclose(work.HBM_BYTES_PER_S,
                                                                            cs.H100_HBM_BYTES)
