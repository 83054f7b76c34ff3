"""Port-only runs of the DAgger drivers (``bunmpc_tpu_torch/learning/dagger.py``:
``Dagger``, ``SafeDagger``, ``LocoSafeDagger``) through ``run()`` on the
plain backends on the CPU: 100-step episodes (50 in the warmup), 2 rollouts
an iteration, 1 BC epoch, 2 iterations, a cut-down solver (tests/test_drivers.py's
style).

* Every run logs the JAX driver's keys and grows its database by what it
  logs.
* SafeDagger: every gated call obeys the gate (a dangerous recorded state is
  an MPC step), and the second iteration's gated rollout runs the weights
  retrained after the first, not the warmup's (the JAX package's
  stale-policy regression, tests/test_drivers.py).
* Dagger: the usage is constant within each window.
* LocoSafeDagger: the posterior stays normalised and concentrates; the
  aggregated rollout is the one with the smaller weighted tracking error.
"""

import math

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu_torch import workload
from bunmpc_tpu_torch.learning import dagger
from bunmpc_tpu_torch.learning.bc import BcConfig
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.sim import rollout as TR
from bunmpc_tpu_torch.solvers import biconvex, ddp

T = 100
CFG = dict(episode_length=T, n_iterations=2, rollouts_per_iteration=2, rollouts_warmup=1,
           episode_length_warmup=50, warmup_bc_epochs=1, ending_mpc_rollout_ms=50,
           num_steps_to_block=20, settle_ms=100,
           vx_range=(0.0, 0.3), vy_range=(0.0, 0.0), w_range=(0.0, 0.0), sigma_base_ori=0.3,
           sigma_vel=0.1)
ITER_KEYS = {"iteration", "datapoints_added", "datapoints_ending_mpc", "database_size",
             "train_loss_first", "train_loss", "valid_loss", "mpc_usage", "failed_frac",
             "bench_failed_frac"}
LOCO_KEYS = {"iteration", "goal", "aggregated", "e_mpc", "e_policy", "tracking_error",
             "posterior_entropy", "datapoints_added", "database_size", "train_loss_first",
             "train_loss", "valid_loss"}


@pytest.fixture(scope="module")
def spec():
    return KD.make_cyclic_spec(TC.load_model(), trot_sim, TC.q0(), device="cpu")


def run(spec, cls, spied, **kw):
    """``cls(...).run()`` with ``rollout.<spied>`` recording each call's
    policy and records, and an eval hook recording the policy after the
    warmup and after each iteration."""
    cfg = dagger.DaggerConfig(**CFG, bc=BcConfig(n_epoch=1, batch_size=64, num_hidden_layer=2,
                                                 hidden_dim=32))
    drv = cls(spec, cfg, sim_params=workload.closed_loop_sim_params(), seed=0,
              admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=10),
              ddp_cfg=ddp.DdpConfig(n_iters=1, alphas=(1.0,)), admm_backend="torch",
              ik_backend="torch", **kw)
    calls, policies = [], []
    original = getattr(TR, spied)

    def spy(*a, **k):
        res = original(*a, **k)
        calls.append((a[6], res))
        return res

    setattr(TR, spied, spy)
    try:
        logs = drv.run(TC.q0(), np.zeros(18),
                       eval_hook=lambda d: policies.append(d.policy) or {"evaluated": True})
    finally:
        setattr(TR, spied, original)
    assert len(logs) == 1 + cfg.n_iterations and logs[0] == {"iteration": "warmup",
                                                             "evaluated": True}
    assert len(policies) == 1 + cfg.n_iterations
    return drv, logs, calls, policies


def policy_rows(res):
    """States, goals and actions of the steps the policy acted on, before
    any failure."""
    live = torch.arange(res.states.shape[1])[None] < res.fail_step[:, None]
    sel = live & (res.mpc_usage == 0)
    return res.states[sel], res.vc_goals[sel], res.actions[sel]


def test_safedagger_runs_the_retrained_policy(spec):
    drv, logs, calls, policies = run(spec, dagger.SafeDagger, "rollout_safedagger")
    sizes = [e["database_size"] for e in logs[1:]]
    for e in logs[1:]:
        assert set(e) == ITER_KEYS | {"evaluated"}
        assert math.isfinite(e["train_loss"]) and 0.0 <= e["mpc_usage"] <= 1.0
    assert sizes[1] - sizes[0] == logs[2]["datapoints_added"] > 0
    assert len(drv.database) == sizes[-1]
    assert [c[0] for c in calls] == policies[:2]  # the policy current at each call
    assert policies[1] is not policies[0]
    for policy, res in calls:
        q = torch.cat([torch.zeros(res.states.shape[:2] + (2,)), res.states[..., 26:]], -1)
        assert (res.mpc_usage[TR.state_is_dangerous(q)] == 1).all()
    s, g, a = policy_rows(calls[1][1])
    assert len(s) > 0
    with torch.no_grad():
        d_now = float((policies[1](s, g) - a).abs().max())
        d_warm = float((policies[0](s, g) - a).abs().max())
    assert d_now < 1e-5 and d_warm > 1e-3, (d_now, d_warm)


def test_dagger_runs(spec):
    drv, logs, calls, _ = run(spec, dagger.Dagger, "rollout_dagger")
    assert len(calls) == 2
    for e in logs[1:]:
        assert set(e) == ITER_KEYS | {"evaluated"}
    usage = torch.cat([c[1].mpc_usage for c in calls]).reshape(-1, T // 50, 50)
    assert (usage == usage[..., :1]).all()
    assert 0.0 < float(usage.mean()) < 1.0
    assert len(drv.database) == logs[-1]["database_size"] > 0


def test_locosafedagger_runs(spec):
    drv, logs, calls, policies = run(spec, dagger.LocoSafeDagger, "rollout_policy", grid_n=5)
    assert len(calls) == 2 and [c[0] for c in calls] == policies[:2]
    for e in logs[1:]:
        assert set(e) == LOCO_KEYS | {"evaluated"}
        assert e["aggregated"] == ("mpc" if e["e_mpc"] < e["e_policy"] else "policy")
        assert e["tracking_error"] == min(e["e_mpc"], e["e_policy"])
    assert abs(drv.posterior.sum() - 1.0) < 1e-12
    assert logs[2]["posterior_entropy"] < logs[1]["posterior_entropy"] < math.log(5**3)
    assert len(drv.database) == logs[-1]["database_size"] > 0
