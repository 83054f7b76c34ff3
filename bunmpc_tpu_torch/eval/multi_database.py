"""Multi-database policy benchmark (C27).

Counterpart of ``bunmpc_tpu/eval/multi_database.py`` (reference
multi-database BC benchmark drivers
behavioral_cloning_train_multi_database.py and
behavioral_cloning_vc_evaluation_multi_database.py): train one policy per
saved database snapshot (e.g. per dataset size or per collection strategy),
evaluate every policy over the same velocity-command grid, and export a
side-by-side comparison table. The reference loops one PyBullet episode at a
time per network and logs to wandb; here each network's full command grid is
a single batched policy rollout and the comparison is a CSV/dict artifact.
"""

from __future__ import annotations

import dataclasses
import os

from ..learning import bc
from ..learning.database import Database
from .velocity_grid import GridEvalResult, eval_policy_grid


@dataclasses.dataclass
class PolicyEntry:
    label: str
    bundle: object  # PolicyBundle
    db_size: int
    final_train_loss: float
    final_valid_loss: float


@dataclasses.dataclass
class ComparisonResult:
    entries: list  # [PolicyEntry]
    grids: dict  # label -> GridEvalResult

    def summary(self):
        out = {}
        for e in self.entries:
            s = self.grids[e.label].summary()
            s.update(
                db_size=e.db_size,
                final_train_loss=e.final_train_loss,
                final_valid_loss=e.final_valid_loss,
            )
            out[e.label] = s
        return out

    def to_csv(self, path: str):
        """One row per (policy, command) — the side-by-side error table the
        reference builds in wandb / xlsx (plot/error_data/*.xlsx)."""
        import csv

        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(
                ["policy", "db_size", "vx_des", "vy_des", "w_des", "vx_mse", "vy_mse", "survived"]
            )
            for e in self.entries:
                g = self.grids[e.label]
                for i in range(len(g.w_des)):
                    w.writerow(
                        [
                            e.label,
                            e.db_size,
                            g.v_des[i, 0],
                            g.v_des[i, 1],
                            g.w_des[i],
                            g.vx_mse[i],
                            g.vy_mse[i],
                            int(g.survived[i]),
                        ]
                    )


def train_from_databases(
    db_paths,
    goal_type: str = "vc",
    cfg: bc.BcConfig = bc.BcConfig(),
    limit: int = 2_000_000,
    mesh=None,
    rng_seed: int = 0,
    device="cuda",
) -> list[PolicyEntry]:
    """Train one policy per saved database snapshot (reference
    behavioral_cloning_train_multi_database.py: one network per hdf5 file,
    labeled by database size) on ``device``. Reading a snapshot needs h5py
    (``Database.load_saved_database`` raises ``RuntimeError`` without it);
    ``mesh`` raises as ``bc.train_policy`` does (one card trains)."""
    entries = []
    for path in db_paths:
        db = Database(limit=limit, goal_type=goal_type)
        db.load_saved_database(path)
        bundle, report = bc.train_policy(db, cfg=cfg, rng_seed=rng_seed, mesh=mesh, device=device)
        label = os.path.splitext(os.path.basename(path))[0]
        entries.append(
            PolicyEntry(
                label=label,
                bundle=bundle,
                db_size=len(db),
                final_train_loss=report.train_losses[-1],
                final_valid_loss=report.valid_losses[-1],
            )
        )
    return entries


def compare_policies(
    spec,
    sim_params,
    cfg,
    state0,
    entries,
    vx_values,
    w_values=(0.0,),
    vy: float = 0.0,
    skip_frac: float = 0.2,
) -> ComparisonResult:
    """Evaluate every trained policy over the same (vx, w) grid (reference
    behavioral_cloning_vc_evaluation_multi_database.py run(): per-network
    velocity sweep)."""
    grids: dict[str, GridEvalResult] = {}
    for e in entries:
        grids[e.label] = eval_policy_grid(
            spec, sim_params, cfg, state0, e.bundle, vx_values, w_values, vy, skip_frac
        )
    return ComparisonResult(entries=list(entries), grids=grids)
