"""Hyperparameter grid sweep over BC training (CLI).

Counterpart of ``scripts/run_sweep.py`` (reference sweep_policy.py:32-439 and
cfgs/sweep_config_wandb.yaml:10-20: a grid over the learning rate, batch
size, depth and width). Trains one policy per grid point, one after another
on the device, and reports the best validation loss:

    python -m bunmpc_tpu_torch.scripts.run_sweep database=path.npz [out=sweep_results.json]

``epochs=N`` (default 30), ``goal_type=cc|vc``, ``device=cpu`` (the card
otherwise). Writes ``out`` as JSON: every grid point's losses and the best.
"""

import itertools
import json
import sys

# reference sweep space (cfgs/sweep_config_wandb.yaml:10-20)
SPACE = {
    "learning_rate": [1e-3, 2e-3, 5e-3],
    "batch_size": [128, 256],
    "num_hidden_layer": [3, 4],
    "hidden_dim": [256, 512],
}


def main(argv=None) -> int:
    from ..learning.bc import BcConfig, train_policy
    from ..learning.database import Database
    from ..utils.runtime import setup_torch

    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else list(argv)))
    db_path = args.get("database")
    if db_path is None:
        raise SystemExit("usage: run_sweep database=path.npz [out=...] [epochs=N]")
    epochs = int(args.get("epochs", 30))
    device = setup_torch(args.get("device"))

    db = Database(2_000_000, goal_type=args.get("goal_type", "cc"))
    db.load_saved_database(db_path)
    print(f"database: {len(db)} samples")

    results = []
    keys = list(SPACE)
    for combo in itertools.product(*SPACE.values()):
        params = dict(zip(keys, combo))
        cfg = BcConfig(n_epoch=epochs, **params)
        _, report = train_policy(db, cfg, rng_seed=0, device=device)
        rec = {**params, "valid_loss": report.valid_losses[-1],
               "train_loss": report.train_losses[-1]}
        results.append(rec)
        print(rec)

    best = min(results, key=lambda r: r["valid_loss"])
    out = args.get("out", "sweep_results.json")
    with open(out, "w") as fh:
        json.dump({"results": results, "best": best}, fh, indent=2)
    print(f"best: {best} -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
