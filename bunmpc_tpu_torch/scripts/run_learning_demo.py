"""The end-to-end SafeDAgger learning loop at real scale.

Counterpart of ``scripts/run_learning_demo.py`` (reference
safedagger_modified.py:464-916, its eval sweep :491-516): Solo12's walking
``trot_sim`` table (kp 12, kd 0.5) on contact kn 1e4 / dn 500 / kt 500,
episodes from the PD-settled standing state, the reference's loop shape
(a perturbed-start warmup along the nominal trajectory, gated rollouts from
perturbed on-trajectory starts with 2000 blocked steps, an ending MPC-only
rollout per episode) over the reference's task envelope vx in [0, 0.33],
vy = w = 0. After the warmup and after every iteration the current policy
is evaluated on a fixed 12-point vx grid of 2000 ms episodes
(``eval/velocity_grid.eval_policy_grid``).

    python -m bunmpc_tpu_torch.scripts.run_learning_demo [out_path] [n_iterations]
        [commands_per_iter] [episode_ms] [skip_failed_episodes(0|1)]

The MPC rollouts run K1 and K2 once a window on the card; ``device=cpu``
runs their plain versions. The SafeDagger state is checkpointed after the
warmup and every iteration (``.ckpt_torch_<stem>`` at the repository's
root; re-running the command resumes). Writes strict JSON lines to
``out_path`` (default ``artifacts/torch_learning_demo_safedagger.jsonl``):
the meta line (with the card's name and power limit), one line per stage
and the best iteration's summary.
"""

import os
import sys
import time

import numpy as np

CONTACT = dict(kn=1e4, dn=500.0, kt=500.0)


def make_cfg(n_iter, n_cmd, ep_ms, skip_failed):
    """The demo's ``DaggerConfig`` (the JAX script's)."""
    from ..learning.bc import BcConfig
    from ..learning.dagger import DaggerConfig

    return DaggerConfig(
        episode_length=ep_ms,
        n_iterations=n_iter,
        rollouts_per_iteration=n_cmd,
        vx_range=(0.0, 0.33),  # the reference's task envelope
        vy_range=(0.0, 0.0),
        w_range=(0.0, 0.0),
        rollouts_warmup=10,
        episode_length_warmup=1500,
        warmup_perturbations_per_replanning=1,
        num_replannings=1,
        num_perturbations=4,
        num_steps_to_block=2000,
        ending_mpc_rollout_ms=1000,
        warmup_bc_epochs=60,
        bc=BcConfig(n_epoch=20),
        # half the reference's nominal trot sigmas (the reference's sampler
        # perturbs far less than it is configured to)
        sigma_base_pos=0.05,
        sigma_base_ori=0.35,
        sigma_joint_pos=0.1,
        sigma_vel=0.1,
        skip_failed_episodes=skip_failed,
        # prefix-keeping warmup even where the gated iterations skip failures
        skip_failed_warmup=False,
    )


def build_meta(cfg, n_iter, n_cmd, ep_ms, **extra):
    """The artifact's meta line: the run's whole provenance."""
    from ..mpc.motions.solo12_cyclic import trot_sim

    return {
        "mode": "safedagger",
        "robot": "solo12",
        "gait": "trot_sim",
        "kp": trot_sim.kp,
        "kd": trot_sim.kd,
        "contact": CONTACT,
        "n_iterations": n_iter,
        "commands_per_iteration": n_cmd,
        "rollouts_per_iteration": n_cmd * cfg.num_replannings * cfg.num_perturbations,
        "episode_length": ep_ms,
        "episode_length_warmup": cfg.episode_length_warmup,
        "rollouts_warmup": cfg.rollouts_warmup,
        "num_steps_to_block": cfg.num_steps_to_block,
        "ending_mpc_rollout_ms": cfg.ending_mpc_rollout_ms,
        "skip_failed_episodes": cfg.skip_failed_episodes,
        "sigmas": {
            "base_pos": cfg.sigma_base_pos,
            "base_ori": cfg.sigma_base_ori,
            "joint_pos": cfg.sigma_joint_pos,
            "vel": cfg.sigma_vel,
        },
        "vx_range": list(cfg.vx_range),
        "warmup_bc_epochs": cfg.warmup_bc_epochs,
        "bc_epochs": cfg.bc.n_epoch,
        **extra,
    }


def tracking_score(res) -> float:
    """The eval's scalar tracking score of a ``GridEvalResult``: the mean of
    the per-command vx + vy MSE, a failed command charged twice the worst
    surviving command's (dying early cannot look accurate); inf while
    nothing survives."""
    mse = res.vx_mse + res.vy_mse
    penalty = 2.0 * float(mse[res.survived].max()) if res.survived.any() else float("inf")
    return float(np.where(res.survived, mse, penalty).mean())


def eval_entry(res, seconds: float) -> dict:
    """The eval hook's log entry of a ``GridEvalResult``."""
    return {
        "eval": {
            **res.summary(),
            "tracking_score": tracking_score(res),
            "per_vx": [
                {
                    "vx_des": float(res.v_des[i, 0]),
                    "vx_mse": float(res.vx_mse[i]),
                    "survived": bool(res.survived[i]),
                    "survival_ms": int(res.fail_step[i]),
                    "mean_speed": float(res.mean_speed[i]),
                }
                for i in range(len(res.w_des))
            ],
            "eval_seconds": round(seconds, 1),
        }
    }


def best_line(logs) -> dict:
    """The summary line: the best iteration by (survival, mean survival)."""
    iters = [e for e in logs if isinstance(e.get("iteration"), int)]
    best = max(iters, key=lambda s: (s["eval"]["survival_rate"],
                                     s["eval"].get("mean_survival_ms", 0)))
    return {
        "best_iteration": best["iteration"],
        "survival_rate": best["eval"]["survival_rate"],
        "mean_survival_ms": best["eval"]["mean_survival_ms"],
        "tracking_score": best["eval"]["tracking_score"],
    }


def main(argv=None) -> int:
    from ..eval.velocity_grid import eval_policy_grid
    from ..learning.dagger import SafeDagger
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
                                                 "torch_learning_demo_safedagger.jsonl"))
    n_iter = _common.arg(pos, 1, int, 6)
    n_cmd = _common.arg(pos, 2, int, 8)
    ep_ms = _common.arg(pos, 3, int, 3000)
    skip_failed = _common.arg(pos, 4, lambda s: bool(int(s)), False)

    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0(),
                               device=device)
    sim_params = physics.SimParams(contact=physics.ContactParams(**CONTACT))
    cfg = make_cfg(n_iter, n_cmd, ep_ms, skip_failed)
    driver = SafeDagger(spec, cfg, sim_params=sim_params, seed=0)

    # the fixed eval grid shared across stages (the reference's sweep shape)
    vx_grid = np.linspace(0.0, 0.33, 12)
    ecfg = rollout.RolloutConfig(episode_length=2000, action_type=cfg.action_type,
                                 kp=trot_sim.kp, kd=trot_sim.kd, gait_period=trot_sim.gait_period)
    state0 = driver._settle(Solo12Config.q0(), Solo12Config.v0())

    def eval_hook(drv):
        t0 = time.time()
        res = eval_policy_grid(spec, sim_params, ecfg, state0, drv.policy, vx_grid,
                               w_values=(0.0,))
        return eval_entry(res, time.time() - t0)

    t0 = time.time()
    logs = driver.run(Solo12Config.q0(), Solo12Config.v0(), eval_hook=eval_hook,
                      checkpoint_dir=_common.checkpoint_dir(out), resume=True)
    wall = time.time() - t0
    meta = build_meta(cfg, n_iter, n_cmd, ep_ms, device=device_label(device),
                      wall_seconds=round(wall, 1))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    jsonio.write_jsonl(out, [{"meta": meta}] + logs + [best_line(logs)])
    print(f"wrote {out} ({len(logs)} stages, {wall:.0f}s)")
    for entry in logs:
        ev = entry.get("eval", {})
        print(f"  it={entry.get('iteration')} "
              f"train_loss={entry.get('train_loss', float('nan')):.4f} "
              f"failed_frac={entry.get('failed_frac')} survival={ev.get('survival_rate')} "
              f"mean_survival_ms={ev.get('mean_survival_ms')} score={ev.get('tracking_score')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
