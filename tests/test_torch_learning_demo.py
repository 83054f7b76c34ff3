"""Gates on the port's committed learning-loop runs on the card.

``python -m bunmpc_tpu_torch.scripts.run_learning_demo
artifacts/torch_learning_demo_safedagger.jsonl 3 8 2000`` and
``python -m bunmpc_tpu_torch.scripts.run_locodemo
artifacts/torch_learning_demo_locosafedagger.jsonl 3 8`` ran on an H100;
these are the JAX package's gates on its own runs (tests/test_learning_demo.py:
the scale, BC loss falling within every iteration, the posterior
concentrating and the dual-rollout decision rule), word for word, and the
meta line names the card and its power limit. Survival and improvement over
the warmup policy are one draw of a chaotic loop: PERF.md reports them
beside the JAX run's, ungated.
"""

import json
import os

import pytest

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "artifacts")
ARTIFACT = os.path.join(ARTIFACTS, "torch_learning_demo_safedagger.jsonl")
LOCO_ARTIFACT = os.path.join(ARTIFACTS, "torch_learning_demo_locosafedagger.jsonl")


def read(path):
    with open(path) as fh:
        return [json.loads(ln, parse_constant=lambda c: pytest.fail(f"non-strict JSON {c}"))
                for ln in fh if ln.strip()]


@pytest.fixture(scope="module")
def demo():
    if not os.path.exists(ARTIFACT):
        pytest.skip("learning demo artifact not yet committed")
    lines = read(ARTIFACT)
    meta = lines[0]["meta"]
    stages = lines[1:]
    return meta, stages


def names_the_card(meta):
    name, limit = meta["device"].rsplit(", ", 1)
    assert name.startswith("NVIDIA") and limit.endswith(" W"), meta["device"]
    assert float(limit[:-2]) > 0


def test_demo_scale(demo):
    """The run is at the verdict's required scale, not toy scale."""
    meta, stages = demo
    assert meta["n_iterations"] >= 3
    assert meta["rollouts_per_iteration"] >= 32
    assert meta["episode_length"] >= 2000
    # warmup stage + n_iterations iteration stages
    iters = [s for s in stages if isinstance(s.get("iteration"), int)]
    assert len(iters) >= 3
    names_the_card(meta)


def test_bc_loss_falls(demo):
    """BC training actually learns in every iteration: the loss falls WITHIN
    each aggregate-train cycle."""
    _, stages = demo
    iters = [s for s in stages if isinstance(s.get("iteration"), int)]
    with_first = [s for s in iters if "train_loss_first" in s]
    assert with_first, "no per-iteration loss curves recorded"
    for s in with_first:
        assert s["train_loss"] < s["train_loss_first"], s


def test_demo_records_the_evals(demo):
    """The warmup and every iteration carry the 12-point grid's eval, and the
    last line names the best iteration by (survival, mean survival)."""
    _, stages = demo
    evals = [s for s in stages if "eval" in s]
    assert [s["iteration"] for s in evals][0] == "warmup" and len(evals) >= 4
    for s in evals:
        assert len(s["eval"]["per_vx"]) == 12
    iters = [s for s in stages if isinstance(s.get("iteration"), int)]
    best = max(iters, key=lambda s: (s["eval"]["survival_rate"],
                                     s["eval"].get("mean_survival_ms", 0)))
    assert stages[-1]["best_iteration"] == best["iteration"]


@pytest.fixture(scope="module")
def locodemo():
    if not os.path.exists(LOCO_ARTIFACT):
        pytest.skip("locosafedagger demo artifact not yet committed")
    lines = read(LOCO_ARTIFACT)
    meta = lines[0]["meta"]
    stages = [e for e in lines[1:] if "iteration" in e]
    summary = lines[-1]
    return meta, stages, summary


def test_locodemo_scale(locodemo):
    """Realistic scale, not toy: >=3 iterations of >=2000 ms dual rollouts
    (reference locosafedagger_modified.py:449-617)."""
    meta, stages, _ = locodemo
    assert meta["n_iterations"] >= 3
    assert meta["episode_length"] >= 2000
    iters = [s for s in stages if isinstance(s.get("iteration"), int)]
    assert len(iters) >= 3
    names_the_card(meta)


def test_locodemo_posterior_concentrates(locodemo):
    """The Bayesian goal posterior concentrates: entropy strictly below the
    uniform prior's log N at every iteration and at the end."""
    meta, stages, summary = locodemo
    prior_h = meta["prior_entropy"]
    iters = [s for s in stages if isinstance(s.get("iteration"), int)]
    for s in iters:
        assert s["posterior_entropy"] < prior_h, s
    assert summary["final_posterior_entropy"] < prior_h


def test_locodemo_decision_rule_and_error_response(locodemo):
    """Every iteration records the dual-rollout decision (aggregate whichever
    of MPC/policy tracked better, :586-605) and the error-scaled likelihood
    is active: each iteration's goal carries a finite tracking error and the
    aggregated side matches min(e_mpc, e_policy)."""
    meta, stages, _ = locodemo
    assert meta["error_scaled_likelihood"] is True
    iters = [s for s in stages if isinstance(s.get("iteration"), int)]
    for s in iters:
        assert s["aggregated"] in ("mpc", "policy")
        want = "mpc" if s["e_mpc"] < s["e_policy"] else "policy"
        assert s["aggregated"] == want, s
        assert s["tracking_error"] == pytest.approx(min(s["e_mpc"], s["e_policy"]))
