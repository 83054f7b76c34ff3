"""Carry state between the JAX package and the port as numpy arrays, so both
compute with the same constants and their results compare field by field.

Nothing here imports JAX: the JAX side hands over plain numpy arrays
(``dataclasses.asdict`` of its ``RobotModel``, ``np.asarray`` of its arrays).
"""

from __future__ import annotations

import numpy as np
import torch

from .robots.model import Frame, RobotModel


def model_from_arrays(d: dict) -> RobotModel:
    """The port's ``RobotModel`` from the JAX ``RobotModel``'s fields:
    ``dataclasses.asdict(model)``, whose ``frames`` maps each name to a dict
    (or an object) with ``body``, ``rot`` and ``pos``."""

    def field(f, name):
        return f[name] if isinstance(f, dict) else getattr(f, name)

    frames = {
        str(name): Frame(
            body=int(field(f, "body")),
            rot=np.asarray(field(f, "rot"), np.float64),
            pos=np.asarray(field(f, "pos"), np.float64),
        )
        for name, f in d["frames"].items()
    }
    arrays = {
        k: np.asarray(d[k])
        for k in ("parent", "joint_rot", "joint_pos", "axis", "mass", "com", "inertia",
                  "joint_lower", "joint_upper", "velocity_limit", "effort_limit")
    }
    return RobotModel(
        name=str(d["name"]),
        n_joints=int(d["n_joints"]),
        joint_names=tuple(str(n) for n in d["joint_names"]),
        frames=frames,
        **arrays,
    )


def plan_to_numpy(plan) -> dict:
    """An ``MpcPlan`` (the port's, or any named tuple of arrays) as a dict of
    numpy arrays keyed by field name."""
    out = {}
    for name in plan._fields:
        a = getattr(plan, name)
        out[name] = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return out


def warm_start_from_arrays(X, F, device, dtype=torch.float32):
    """The ADMM's carried state ``(X_wm (B, H+1, 9), F_wm (B, H, n_eff, 3))``
    as contiguous tensors on ``device``."""
    X = torch.as_tensor(np.asarray(X), dtype=dtype, device=device).contiguous()
    F = torch.as_tensor(np.asarray(F), dtype=dtype, device=device).contiguous()
    if X.ndim != 3 or X.shape[-1] != 9 or F.ndim != 4 or F.shape[-1] != 3:
        raise ValueError(f"warm start shapes {tuple(X.shape)}, {tuple(F.shape)}: expected "
                         "(B, H+1, 9) and (B, H, n_eff, 3)")
    if X.shape[0] != F.shape[0] or X.shape[1] != F.shape[1] + 1:
        raise ValueError(f"warm start shapes {tuple(X.shape)}, {tuple(F.shape)} disagree")
    return X, F
