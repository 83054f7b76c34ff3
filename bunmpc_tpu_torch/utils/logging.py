"""Experiment metrics logging.

Counterpart of ``bunmpc_tpu/utils/logging.py``. The reference logs to wandb
(behavioral_cloning_train.py:32,157); the default sink here is JSONL on disk
with the same ``log(dict)`` call shape, and wandb is used as well where it
can be imported (it is imported in ``__init__`` only, so no entry point needs
it).
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, run_dir: str, project: str = "bunmpc_tpu", use_wandb: bool = True):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, dir=run_dir)
            except Exception:
                self._wandb = None

    def log(self, metrics: dict, step: int | None = None):
        rec = {"_time": time.time(), **metrics}
        if step is not None:
            rec["_step"] = step
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
