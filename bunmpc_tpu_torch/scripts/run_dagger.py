"""Iterative-learning drivers (CLI): DAgger / SafeDAgger / LocoSafeDagger.

Counterpart of ``scripts/run_dagger.py`` (reference dagger_modified.py,
safedagger_modified.py, locosafedagger_modified.py):

    python -m bunmpc_tpu_torch.scripts.run_dagger mode=safedagger [key=value ...]

Overrides go into ``bunmpc_tpu_torch/configs/<mode>.yaml``; ``device=cpu``
runs the plain versions on the CPU (the card otherwise). The driver's state
is saved after the warmup and after every iteration to ``checkpoint_dir``
(default ``save_path/checkpoint``), and ``resume=true`` continues from it.
Writes ``save_path/metrics.jsonl`` (one line per log entry) and the final
policy to ``save_path/policy`` in the JAX package's checkpoint format.
"""

import os
import sys


def parse_flag(value) -> bool:
    """A boolean override: ``true``/``false`` in any case, ``1``/``0``,
    ``yes``/``no``. (``key=false`` reaches the config as the string
    ``"false"``, which ``bool`` would read as true.)"""
    text = str(value).strip().lower()
    if text in ("1", "true", "yes", "on"):
        return True
    if text in ("0", "false", "no", "off", "", "none"):
        return False
    raise ValueError(f"not a boolean: {value!r}")


def main(argv=None) -> int:
    from ..learning.bc import BcConfig
    from ..learning.dagger import Dagger, DaggerConfig, LocoSafeDagger, SafeDagger
    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import trot
    from ..robots.solo12 import Solo12Config
    from ..utils.checkpoint import save_policy
    from ..utils.config import load_config
    from ..utils.logging import MetricsLogger
    from ..utils.runtime import setup_torch

    args = sys.argv[1:] if argv is None else list(argv)
    mode = next((a.split("=", 1)[1] for a in args if a.startswith("mode=")), "safedagger")
    cfg = load_config(mode, [a for a in args if not a.startswith("mode=")])
    device = setup_torch(cfg.get("device"))

    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0(), device=device)
    d_cfg = DaggerConfig(
        episode_length=cfg.get("episode_length", 2000),
        n_iterations=cfg.get("n_iterations", 5),
        rollouts_per_iteration=cfg.get("rollouts_per_iteration", 8),
        mpc_usage_percentage=cfg.get("mpc_usage_percentage", 0.5),
        num_steps_to_block=cfg.get("num_steps_to_block", 150),
        vx_range=tuple(cfg.get("vx_range", (-0.3, 0.5))),
        vy_range=tuple(cfg.get("vy_range", (-0.2, 0.2))),
        w_range=tuple(cfg.get("w_range", (-0.3, 0.3))),
        goal_type=cfg.get("goal_type", "vc"),
        action_type=cfg.get("action_type", "pd_target"),
        warmup_bc_epochs=cfg.get("warmup_bc_epochs", 150),
        bc=BcConfig(n_epoch=cfg.get("bc_epochs", 50)),
    )
    driver_cls = {"dagger": Dagger, "safedagger": SafeDagger, "locosafedagger": LocoSafeDagger}[
        mode
    ]
    kwargs = {"grid_n": cfg.get("grid_n", 30)} if mode == "locosafedagger" else {}
    driver = driver_cls(spec, d_cfg, **kwargs)

    out = cfg.get("save_path", f"./models/{mode}")
    os.makedirs(out, exist_ok=True)
    logger = MetricsLogger(out)
    ckpt_dir = cfg.get("checkpoint_dir", os.path.join(out, "checkpoint"))
    resume = parse_flag(cfg.get("resume", False))
    logs = driver.run(
        Solo12Config.q0(), Solo12Config.v0(), checkpoint_dir=ckpt_dir, resume=resume
    )
    for log in logs:
        logger.log(log)
    logger.close()
    save_policy(driver.policy, os.path.join(out, "policy"))
    print(f"{mode} finished: {logs[-1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
