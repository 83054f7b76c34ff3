"""Behavioral-cloning training driver (CLI).

Counterpart of ``scripts/run_bc.py`` (reference
behavioral_cloning_train.py):

    python -m bunmpc_tpu_torch.scripts.run_bc database=path/to/database.npz [key=value ...]

Overrides go into ``bunmpc_tpu_torch/configs/bc.yaml``; ``device=cpu`` trains
on the CPU (the card otherwise). The database is the port's ``.npz`` snapshot
or the JAX package's ``.hdf5`` (which needs h5py). Writes the policy to
``save_path`` (default ``./models/bc_policy``) in the JAX package's checkpoint
format and the per-epoch losses to ``metrics.jsonl`` beside it.
"""

import os
import sys


def main(argv=None) -> int:
    from ..learning.bc import BcConfig, train_policy
    from ..learning.database import Database
    from ..utils.checkpoint import save_policy
    from ..utils.config import load_config
    from ..utils.logging import MetricsLogger
    from ..utils.runtime import setup_torch

    args = sys.argv[1:] if argv is None else list(argv)
    cfg = load_config("bc", [a for a in args if not a.startswith("database=")])
    db_path = next((a.split("=", 1)[1] for a in args if a.startswith("database=")), None)
    if db_path is None:
        raise SystemExit("usage: run_bc database=path.npz [overrides]")
    device = setup_torch(cfg.get("device"))

    db = Database(cfg.get("database_size", 2_000_000), goal_type=cfg.get("goal_type", "cc"))
    db.load_saved_database(db_path)
    print(f"loaded database: {len(db)} samples")

    bc_cfg = BcConfig(
        batch_size=cfg.get("batch_size", 256),
        learning_rate=cfg.get("learning_rate", 2e-3),
        n_epoch=cfg.get("n_epoch", 150),
        num_hidden_layer=cfg.get("num_hidden_layer", 3),
        hidden_dim=cfg.get("hidden_dim", 512),
        loss=cfg.get("loss", "l1"),
    )
    out = cfg.get("save_path", "./models/bc_policy")
    logger = MetricsLogger(os.path.dirname(out) or ".")
    bundle, report = train_policy(db, bc_cfg, log_fn=logger.log, device=device)
    logger.close()
    save_policy(bundle, out)
    print(
        f"trained: final train {report.train_losses[-1]:.4f} "
        f"valid {report.valid_losses[-1]:.4f} -> {out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
