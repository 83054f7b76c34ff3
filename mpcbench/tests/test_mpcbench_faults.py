"""A run with its timed path broken underneath comes out not correct, and
a sound run correct: each tiny cell of ``tiny.py`` driven through the whole
of a run on the CPU (the look for a card skipped; the program's kernels run
their plain versions), held to its full-size cell's limits, once sound and
once with each fault of ``faults.py`` that the cell can have planted in the
program."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import tiny  # noqa: E402

CASES = [
    (tiny.SOLVE, None, True),
    (tiny.SOLVE, "answers_shifted", False),
    (tiny.SOLVE, "state_unchanged", False),
    (tiny.SOLVE, "half_batch", False),
    (tiny.GO2, None, True),
    (tiny.GO2, "state_unchanged", False),
    (tiny.LOOP, None, True),
    (tiny.LOOP, "answers_shifted", False),
    (tiny.LOOP, "state_unchanged", False),
    (tiny.LOOP, "half_batch", False),
    (tiny.LOOP, "physics_unchanged", False),
    (tiny.LOOP, "physics_half_batch", False),
    (tiny.SHARDED, None, True),
    (tiny.SHARDED, "exchange_left_out", False),
    (tiny.SHARDED, "ranks_half_batch", False),
]


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("checkout")))


@pytest.mark.parametrize("cell,fault,correct", CASES,
                         ids=[f"{c[0]}-{f or 'sound'}" for c, f, _ in CASES])
def test_a_broken_timed_path_is_not_correct(checkout, cell, fault, correct):
    rc, last, err = tiny.run_cell(checkout, cell[0], fault=fault)
    assert rc == 0, err[-3000:]
    assert last["correct"] is correct, err[-3000:]
