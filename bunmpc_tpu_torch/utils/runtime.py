"""Process-level PyTorch setup shared by the CLI drivers.

Counterpart of ``bunmpc_tpu/utils/runtime.py`` (``setup_jax``: the platform
and the compile cache): here the device, full-f32 arithmetic and the seeds.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_torch(device=None, seed: int | None = None) -> torch.device:
    """The device the drivers run on: the card unless ``device`` names
    another (``"cpu"`` runs the plain versions), raising where a CUDA device
    is asked for and there is none. TF32 stays off, as at the package's
    import. With ``seed``, seeds Python's, numpy's and PyTorch's global
    generators (the drivers' own generators take their seeds explicitly)."""
    from ..mpc.kino_dyn import resolve_device

    device = resolve_device("cuda" if device is None else device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)
    return device
