"""A LocoSafeDagger run at real scale over the three command axes.

Counterpart of ``scripts/run_locosafedagger_demo.py`` (reference
locosafedagger_modified.py:357-425, 560-605): the Bayesian posterior over a
30^3 goal grid (vx in [0, 0.33], vy in [-0.05, 0.05], w in [-0.1, 0.1])
concentrating, goal sampling following it, and the dual-rollout decision
rule (the MPC expert and the current policy both roll out; the better
tracker is aggregated), on ``run_learning_demo``'s setup with 8 warmup
rollouts.

    python -m bunmpc_tpu_torch.scripts.run_locosafedagger_demo [out_path]
        [n_iterations] [rollouts_per_iter] [episode_ms]

The MPC rollouts run K1 and K2 once a window on the card; ``device=cpu``
runs their plain versions. Writes strict JSON lines to ``out_path``
(default ``artifacts/torch_locosafedagger_demo.jsonl``): the meta line and
one line per stage.
"""

import os
import sys
import time

import numpy as np

CONTACT = dict(kn=1e4, dn=500.0, kt=500.0)


def make_cfg(n_iter: int, n_roll: int, ep_ms: int):
    from ..learning.bc import BcConfig
    from ..learning.dagger import DaggerConfig

    return DaggerConfig(
        episode_length=ep_ms,
        n_iterations=n_iter,
        rollouts_per_iteration=n_roll,
        vx_range=(0.0, 0.33),
        vy_range=(-0.05, 0.05),
        w_range=(-0.1, 0.1),
        rollouts_warmup=8,
        episode_length_warmup=1500,
        warmup_bc_epochs=60,
        bc=BcConfig(n_epoch=20),
    )


def build_meta(cfg, n_iter, n_roll, ep_ms, prior_entropy, **extra):
    from ..mpc.motions.solo12_cyclic import trot_sim

    return {
        "mode": "locosafedagger",
        "robot": "solo12",
        "gait": "trot_sim",
        "kp": trot_sim.kp,
        "kd": trot_sim.kd,
        "contact": CONTACT,
        "n_iterations": n_iter,
        "rollouts_per_iteration": n_roll,
        "episode_length": ep_ms,
        "grid_n": 30,
        "prior_entropy": prior_entropy,
        "sigmas": {
            "base_pos": cfg.sigma_base_pos,
            "base_ori": cfg.sigma_base_ori,
            "joint_pos": cfg.sigma_joint_pos,
            "vel": cfg.sigma_vel,
        },
        **extra,
    }


def main(argv=None) -> int:
    from ..learning.dagger import LocoSafeDagger
    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import trot_sim
    from ..robots.solo12 import Solo12Config
    from ..sim import physics
    from ..utils import jsonio
    from ..utils.runtime import device_label, setup_torch
    from . import _common

    pos, device = _common.split_args(argv)
    device = setup_torch(device)
    out = _common.arg(pos, 0, str, os.path.join(_common.repo_root(), "artifacts",
                                                 "torch_locosafedagger_demo.jsonl"))
    n_iter = _common.arg(pos, 1, int, 6)
    n_roll = _common.arg(pos, 2, int, 8)
    ep_ms = _common.arg(pos, 3, int, 2000)

    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0(),
                               device=device)
    sim_params = physics.SimParams(contact=physics.ContactParams(**CONTACT))
    cfg = make_cfg(n_iter, n_roll, ep_ms)
    driver = LocoSafeDagger(spec, cfg, sim_params=sim_params, seed=0, grid_n=30)
    prior_entropy = float(np.log(np.prod(driver.grid.shape)))
    t0 = time.time()
    logs = driver.run(Solo12Config.q0(), Solo12Config.v0())
    wall = time.time() - t0
    meta = build_meta(cfg, n_iter, n_roll, ep_ms, prior_entropy, device=device_label(device),
                      wall_seconds=round(wall, 1))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    jsonio.write_jsonl(out, [{"meta": meta}] + logs)
    print(f"wrote {out} ({len(logs)} stages, {wall:.0f}s)")
    for e in logs:
        if isinstance(e.get("iteration"), int):
            print(f"  it={e['iteration']} goal={e['goal']} agg={e['aggregated']} "
                  f"e_mpc={e['e_mpc']:.4g} e_policy={e['e_policy']:.4g} "
                  f"H(post)={e['posterior_entropy']:.3f} (prior {prior_entropy:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
