"""Data-collection experiment driver (CLI).

Counterpart of ``scripts/run_data_collection.py`` (reference
examples/iterative_algorithm/data_collection.py:282-288):

    python -m bunmpc_tpu_torch.scripts.run_data_collection [key=value ...]

Overrides use dotted paths into ``bunmpc_tpu_torch/configs/data_collection.yaml``;
``device=cpu`` runs the plain versions on the CPU (the card otherwise). Writes
``data_save_path/database_<rows>.npz`` after each iteration and
``data_save_path/metrics.jsonl``.
"""

import os
import sys


def main(argv=None) -> int:
    from ..learning.data_collection import DataCollection, DataCollectionConfig
    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import GAITS
    from ..robots.solo12 import Solo12Config
    from ..utils.config import load_config
    from ..utils.logging import MetricsLogger
    from ..utils.runtime import setup_torch

    cfg = load_config("data_collection", sys.argv[1:] if argv is None else list(argv))
    device = setup_torch(cfg.get("device"))
    gait = GAITS[cfg.get("gaits", ["trot"])[0]]
    model = Solo12Config.load_model()
    spec = KD.make_cyclic_spec(model, gait, Solo12Config.q0(), device=device)

    dc_cfg = DataCollectionConfig(
        episode_length=cfg.get("episode_length", 3000),
        n_iteration=cfg.get("n_iteration", 5),
        num_perturbations_per_replanning=cfg.get("num_perturbations_per_replanning", 2),
        goal_horizon=cfg.get("goal_horizon", 1),
        vx_range=tuple(cfg.get("vx_range", (0.0, 0.3))),
        vy_range=tuple(cfg.get("vy_range", (0.0, 0.0))),
        w_range=tuple(cfg.get("w_range", (0.0, 0.0))),
        action_type=cfg.get("action_type", "pd_target"),
        database_size=cfg.get("database_size", 1_000_000),
    )
    out = cfg.get("data_save_path", "./data")
    os.makedirs(out, exist_ok=True)
    logger = MetricsLogger(out)
    dc = DataCollection(spec, dc_cfg)
    logs = dc.run(Solo12Config.q0(), Solo12Config.v0(), save_path=out)
    for i, log in enumerate(logs):
        logger.log({"iteration": i, **{k: str(v) for k, v in log.items()}})
    logger.close()
    print(f"collected {len(dc.database)} datapoints -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
