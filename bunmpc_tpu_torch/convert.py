"""Carry state between the JAX package and the port as numpy arrays, so both
compute with the same constants and their results compare field by field:
the robot model, MPC plans and warm starts, the closed loop's simulator
parameters, states, controller gains and rollout settings, and policy
parameters with their normalization payload.

Nothing here imports JAX: the JAX side hands over plain numpy arrays
(``dataclasses.asdict`` of its ``RobotModel``, ``np.asarray`` of its arrays).
The Go2 needs nothing more: its robot ships as the port's own copy of the
asset (``robots/go2.py``) and it has no learned parameters; per-episode
gains and simulator parameters are (B,) tensors the caller builds (the
converters here take the JAX package's scalar ones).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .learning.networks import GoalConditionedPolicyNet, PolicyBundle
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


def policy_params_from_flax(params: dict, batch_stats: dict | None = None) -> dict:
    """The port's ``GoalConditionedPolicyNet`` state dict from the flax
    net's ``params`` tree (``Dense_i/{kernel, bias}``, ``BatchNorm_i/{scale,
    bias}``) and, for a BatchNorm net, its ``batch_stats`` (``BatchNorm_i/
    {mean, var}``), as numpy arrays. Each kernel (in, out) becomes a weight
    (out, in)."""
    out = {}
    n_dense = sum(1 for k in params if k.startswith("Dense_"))
    for i in range(n_dense):
        d = params[f"Dense_{i}"]
        out[f"dense.{i}.weight"] = torch.tensor(np.asarray(d["kernel"]).T)
        out[f"dense.{i}.bias"] = torch.tensor(np.asarray(d["bias"]))
    n_norm = sum(1 for k in params if k.startswith("BatchNorm_"))
    for i in range(n_norm):
        bn, st = params[f"BatchNorm_{i}"], batch_stats[f"BatchNorm_{i}"]
        out[f"norm.{i}.weight"] = torch.tensor(np.asarray(bn["scale"]))
        out[f"norm.{i}.bias"] = torch.tensor(np.asarray(bn["bias"]))
        out[f"norm.{i}.running_mean"] = torch.tensor(np.asarray(st["mean"]))
        out[f"norm.{i}.running_var"] = torch.tensor(np.asarray(st["var"]))
        out[f"norm.{i}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out


def policy_from_flax(params: dict, batch_stats: dict | None = None, device="cpu",
                     dtype=torch.float64) -> GoalConditionedPolicyNet:
    """A ``GoalConditionedPolicyNet`` in eval mode holding the flax net's
    parameters; its widths and BatchNorm come from the tree."""
    sd = policy_params_from_flax(params, batch_stats)
    n_dense = sum(1 for k in params if k.startswith("Dense_"))
    w0, w_last = sd["dense.0.weight"], sd[f"dense.{n_dense - 1}.weight"]
    module = GoalConditionedPolicyNet(
        input_size=w0.shape[1], output_size=w_last.shape[0], num_hidden_layer=n_dense - 1,
        hidden_dim=w0.shape[0], batch_norm="BatchNorm_0" in params).to(device, dtype)
    module.load_state_dict(sd)
    return module.eval()


def policy_bundle_from_flax(params: dict, state_mean, state_std, goal_mean, goal_std,
                            batch_stats: dict | None = None, device="cpu",
                            dtype=torch.float64) -> PolicyBundle:
    """The port's ``PolicyBundle`` from the JAX ``PolicyBundle``'s fields
    (flax ``params`` and the normalization arrays or scalars)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return PolicyBundle(module=policy_from_flax(params, batch_stats, device, dtype),
                        state_mean=t(state_mean), state_std=t(state_std),
                        goal_mean=t(goal_mean), goal_std=t(goal_std))
