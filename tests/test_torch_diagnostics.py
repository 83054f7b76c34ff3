"""The port's solver diagnostics (``bunmpc_tpu_torch/scripts/diagnose_admm.py``
and ``solve_times_sweep.py``) against the JAX scripts' computations, through
the fixture of ``tests/torch_scripts_reference.py`` (the JAX scripts run in
float64 there).

* ``diagnose_admm`` at B=4 in float64 on the JAX script's seeded draws: the
  ADMM's outer iterations per problem equal and its violation history
  within 1e-9, both with and without the preconditioner; the F and X
  subproblems' FISTA iterations at the converged iterate (``FistaResult.
  iters``) equal and their Lipschitz estimates within 1e-9 relative; the
  printed report equal to the last printed digit.
* ``solve_times_sweep`` at B=4 in float64 for two horizons on the plain
  path: ``mean_admm_iters`` equal and ``mean_viol`` within 1e-9.
* Both mains on the CPU at a small batch, their output under the JAX
  script's keys.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
import torch_scripts_reference as REF
from bunmpc_tpu_torch.scripts import diagnose_admm, solve_times_sweep

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def fixture():
    with open(REF.FIXTURE_JSON) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def arrays():
    return dict(np.load(REF.FIXTURE_NPZ))


def test_diagnose_admm_matches_jax(fixture, arrays):
    B = REF.DIAGNOSE_ADMM_B
    d = diagnose_admm.diagnose(B, torch.float64, CPU)
    for tag in (False, True):
        r = d[f"precondition={tag}"]
        np.testing.assert_array_equal(r["admm_iters"], arrays[f"diagnose_admm/{tag}/admm_iters"])
        np.testing.assert_allclose(r["viol_hist"], arrays[f"diagnose_admm/{tag}/viol_hist"],
                                   atol=1e-9, rtol=0)
        np.testing.assert_allclose(r["viol_norm"], arrays[f"diagnose_admm/{tag}/viol_norm"],
                                   atol=1e-9, rtol=0)
    for sub, key in (("f_sub", "f"), ("x_sub", "x")):
        np.testing.assert_array_equal(d[sub]["iters"], arrays[f"diagnose_admm/{key}_iters"])
        np.testing.assert_allclose(d[sub]["L"], arrays[f"diagnose_admm/{key}_L"], rtol=1e-9)
    assert d["f_sub"]["iters"].max() <= d["fista_max_iters"]
    assert d["x_sub"]["iters"].max() <= d["fista_max_iters"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        lines = diagnose_admm.report(d, B)
    REF.same_report(lines, fixture["diagnose_admm"]["stdout"])


def test_diagnose_admm_main_runs(capsys):
    assert diagnose_admm.main(["batch=2", "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "[precondition=True] B=2 outer iters" in out and "X-subproblem (cold x0)" in out


def test_solve_times_match_jax(fixture):
    res, event_ms = solve_times_sweep.sweep("trot", REF.SOLVE_TIMES_B, CPU, horizons=(1.0, 1.5),
                                            dtype=torch.float64)
    assert list(res) == [10, 15] and set(event_ms.values()) == {None}
    for H, r in res.items():
        want = fixture["solve_times_sweep"][str(H)]
        assert r["mean_admm_iters"] == want["mean_admm_iters"]
        np.testing.assert_allclose(r["mean_viol"], want["mean_viol"], atol=1e-9, rtol=0)
        assert r["sec_per_batch"] > 0 and r["solves_per_sec"] > 0


def test_solve_times_main_writes_jax_keys(tmp_path):
    out = tmp_path / "st.json"
    assert solve_times_sweep.main(["batch=1", f"out={out}", "device=cpu"]) == 0
    with open(out) as fh:
        doc = json.loads(fh.read(), parse_constant=lambda c: pytest.fail(c))
    assert list(doc) == ["10", "15", "20", "25"]
    for r in doc.values():
        assert set(r) == {"sec_per_batch", "solves_per_sec", "mean_admm_iters", "mean_viol"}
