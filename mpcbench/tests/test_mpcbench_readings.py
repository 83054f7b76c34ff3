"""``mpcbench/readings.py`` on the CPU: the program's compared rows
recorded over two seeds of a tiny solve cell in one process, then judged
by the reference, give the numbers a run of each seed compares."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import tiny  # noqa: E402

CODE = """
import sys
sys.path.insert(0, {root!r})
from mpcbench import readings
readings.record({cell!r}, [{seed}, {seed} + 1], 0.5, {out!r}, device="cpu")
readings.judge({out!r})
"""


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("checkout")), cells=(tiny.GO2,))


def test_recorded_readings_are_a_runs_numbers(checkout, tmp_path):
    seed = 2147483663
    out = str(tmp_path / "rows.npz")
    p = subprocess.run([sys.executable, "-c", CODE.format(root=checkout, cell=tiny.GO2[0],
                                                          seed=seed, out=out)],
                       cwd=checkout, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.strip().splitlines() if x.startswith("{")]
    per_seed = {d["seed"]: d["numbers"] for d in lines if "seed" in d}
    assert sorted(per_seed) == [seed, seed + 1]
    assert lines[-1]["largest"]["F_opt"] == max(n["F_opt"] for n in per_seed.values())
    rc, last, err = tiny.run_cell(checkout, tiny.GO2[0], seed=seed)
    assert rc == 0, err[-3000:]
    for name, c in last["checks"].items():
        assert per_seed[seed][name] == pytest.approx(c["value"], rel=1e-9, abs=1e-12), name
