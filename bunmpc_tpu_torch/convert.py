"""Carry state between the JAX package and the port as numpy arrays, so both
compute with the same constants and their results compare field by field:
the robot model, MPC plans and warm starts, and the closed loop's simulator
parameters, states, controller gains and rollout settings.

Nothing here imports JAX: the JAX side hands over plain numpy arrays
(``dataclasses.asdict`` of its ``RobotModel``, ``np.asarray`` of its arrays).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .robots.model import Frame, RobotModel
from .sim import controllers, physics, rollout


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


def _fields(cls, obj, **override) -> dict:
    """The fields of dataclass ``cls`` read off ``obj`` by name."""
    out = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    out.update(override)
    return out


def contact_params_from(c) -> physics.ContactParams:
    """The port's ``ContactParams`` from the JAX package's (floats)."""
    return physics.ContactParams(**{k: float(v) for k, v in _fields(physics.ContactParams,
                                                                    c).items()})


def sim_params_from(p) -> physics.SimParams:
    """The port's ``SimParams`` from the JAX package's (scalar fields)."""
    d = _fields(physics.SimParams, p, contact=contact_params_from(p.contact))
    return physics.SimParams(**{k: v if k == "contact" else float(v) for k, v in d.items()})


def sim_state_from(s, dtype=torch.float64, device="cpu") -> physics.SimState:
    """The port's ``SimState`` from the JAX package's (arrays)."""
    return physics.SimState(*(torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                              for a in (s.q, s.v)))


def gains_from(g) -> controllers.IdControllerGains:
    """The port's ``IdControllerGains`` from the JAX package's (scalar gains)."""
    return controllers.IdControllerGains(kp=float(g.kp), kd=float(g.kd))


def rollout_config_from(c) -> rollout.RolloutConfig:
    """The port's ``RolloutConfig`` from the JAX package's."""
    return rollout.RolloutConfig(**_fields(rollout.RolloutConfig, c))
