"""LocoSafeDagger at real scale: the "Bayesian Updates" of BUNMPC's name.

Counterpart of ``scripts/run_locodemo.py`` (reference
locosafedagger_modified.py:357-425, the likelihood and update, and
:560-605, the dual-rollout decision rule): each iteration samples a goal
from the posterior over a 24-cell vx grid (singleton vy and w axes), rolls
out both the MPC expert and the current policy, aggregates whichever
tracked better, updates the posterior with the error-scaled likelihood and
retrains. The setup is ``run_learning_demo``'s (Solo12 ``trot_sim``,
contact kn 1e4 / dn 500 / kt 500, settled starts, vx in [0, 0.33]); the
final policy is evaluated on the same 12-point vx grid.

    python -m bunmpc_tpu_torch.scripts.run_locodemo [out_path] [n_iterations] [B]

The MPC rollouts run K1 and K2 once a window on the card; ``device=cpu``
runs their plain versions. Checkpoints go to ``.ckpt_torch_<stem>`` at the
repository's root (re-running resumes). Writes strict JSON lines to
``out_path`` (default ``artifacts/torch_learning_demo_locosafedagger.jsonl``):
the meta line, one line per stage and the summary (the posterior's final
entropy and vx marginal, the final eval).
"""

import os
import sys
import time

import numpy as np

CONTACT = dict(kn=1e4, dn=500.0, kt=500.0)


def make_cfg(n_iter: int, B: int):
    from ..learning.bc import BcConfig
    from ..learning.dagger import DaggerConfig

    return DaggerConfig(
        episode_length=2000,
        n_iterations=n_iter,
        rollouts_per_iteration=B,
        vx_range=(0.0, 0.33),  # the reference's task envelope
        vy_range=(0.0, 0.0),
        w_range=(0.0, 0.0),
        rollouts_warmup=10,
        episode_length_warmup=1500,
        warmup_perturbations_per_replanning=1,
        warmup_bc_epochs=60,
        bc=BcConfig(n_epoch=20),
        sigma_base_pos=0.05,
        sigma_base_ori=0.35,
        sigma_joint_pos=0.1,
        sigma_vel=0.1,
    )


def goal_grid():
    """The 24-cell vx grid with singleton vy and w axes."""
    from ..learning import bayes

    return bayes.GoalGrid(vx=np.linspace(0.0, 0.33, 24), vy=np.zeros(1), w=np.zeros(1))


def build_meta(cfg, n_iter, B, post, **extra):
    from ..mpc.motions.solo12_cyclic import trot_sim

    return {
        "mode": "locosafedagger",
        "robot": "solo12",
        "gait": "trot_sim",
        "kp": trot_sim.kp,
        "kd": trot_sim.kd,
        "contact": CONTACT,
        "n_iterations": n_iter,
        "rollouts_per_iteration": B,
        "episode_length": cfg.episode_length,
        "grid_cells": int(post.size),
        "prior_entropy": float(np.log(post.size)),
        "error_scaled_likelihood": True,
        "vx_range": list(cfg.vx_range),
        "sigmas": {
            "base_pos": cfg.sigma_base_pos,
            "base_ori": cfg.sigma_base_ori,
            "joint_pos": cfg.sigma_joint_pos,
            "vel": cfg.sigma_vel,
        },
        **extra,
    }


def summary(grid, post, final_eval, loop_seconds) -> dict:
    """The summary line: the posterior's final entropy, its argmax and vx
    marginal, the final eval."""
    nz = post[post > 0]
    marg = post.sum(axis=(1, 2))
    return {
        "final_posterior_entropy": float(-(nz * np.log(nz)).sum()),
        "posterior_argmax_vx": float(grid.vx[int(np.argmax(marg))]),
        "posterior_vx_marginal": [float(x) for x in marg],
        "final_eval": final_eval,
        "loop_seconds": round(loop_seconds, 1),
    }


def main(argv=None) -> int:
    from ..eval.velocity_grid import eval_policy_grid
    from ..learning.dagger import LocoSafeDagger
    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import trot_sim
    from ..robots.solo12 import Solo12Config
    from ..sim import physics, rollout
    from ..utils import jsonio
    from ..utils.runtime import device_label, setup_torch
    from . import _common

    pos, device = _common.split_args(argv)
    device = setup_torch(device)
    out = _common.arg(pos, 0, str, os.path.join(_common.repo_root(), "artifacts",
                                                 "torch_learning_demo_locosafedagger.jsonl"))
    n_iter = _common.arg(pos, 1, int, 10)
    B = _common.arg(pos, 2, int, 8)

    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0(),
                               device=device)
    sim_params = physics.SimParams(contact=physics.ContactParams(**CONTACT))
    cfg = make_cfg(n_iter, B)
    grid = goal_grid()
    driver = LocoSafeDagger(spec, cfg, sim_params=sim_params, seed=0, grid=grid,
                            error_scaled_likelihood=True)
    t0 = time.time()
    logs = driver.run(Solo12Config.q0(), Solo12Config.v0(),
                      checkpoint_dir=_common.checkpoint_dir(out), resume=True)
    wall_loop = time.time() - t0

    # the final policy on the 12-point grid of the SafeDAgger demo
    ecfg = rollout.RolloutConfig(episode_length=2000, action_type=cfg.action_type,
                                 kp=trot_sim.kp, kd=trot_sim.kd, gait_period=trot_sim.gait_period)
    state0 = driver._settle(Solo12Config.q0(), Solo12Config.v0())
    res = eval_policy_grid(spec, sim_params, ecfg, state0, driver.policy,
                           np.linspace(0.0, 0.33, 12), w_values=(0.0,))
    post = np.asarray(driver.posterior)
    meta = build_meta(cfg, n_iter, B, post, device=device_label(device),
                      wall_seconds=round(time.time() - t0, 1))
    summ = summary(grid, post, res.summary(), wall_loop)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    jsonio.write_jsonl(out, [{"meta": meta}] + logs + [summ])
    print(f"wrote {out} ({len(logs)} stages, {time.time() - t0:.0f}s)")
    for e in logs:
        if isinstance(e.get("iteration"), int):
            print(f"  it={e['iteration']} goal_vx={e['goal'][0]:.3f} agg={e['aggregated']} "
                  f"e_mpc={e['e_mpc']:.4f} e_pol={e['e_policy']:.4f} "
                  f"H(post)={e['posterior_entropy']:.3f} train_loss={e['train_loss']:.4f}")
    print(f"  final entropy {summ['final_posterior_entropy']:.3f} (prior "
          f"{meta['prior_entropy']:.3f}), argmax vx {summ['posterior_argmax_vx']:.3f}, "
          f"eval survival {summ['final_eval'].get('survival_rate')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
