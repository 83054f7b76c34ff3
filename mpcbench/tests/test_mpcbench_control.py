"""The control of each cell's comparison (``mpcbench/control.py``: the
plain reference in the program's place, its matrix products in TF32) comes
out not correct under the cell's limits, at a size a test run can hold (the
tiny cells of ``tiny.py``, on the CPU)."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import tiny  # noqa: E402


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("checkout")))


CODE = """
import json, sys
sys.path.insert(0, {root!r})
from mpcbench import control
print(json.dumps(control.run_control({cell!r}, {seed}, device="cpu")))
"""


@pytest.mark.parametrize("cell", [tiny.SOLVE, tiny.GO2, tiny.LOOP, tiny.SHARDED],
                         ids=lambda c: c[0])
def test_the_control_is_not_correct(checkout, cell):
    p = subprocess.run([sys.executable, "-c", CODE.format(root=checkout, cell=cell[0],
                                                          seed=2147483661)],
                       cwd=checkout, capture_output=True, text=True, timeout=900,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is False, out
