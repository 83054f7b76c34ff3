"""Checkpoints of policies and of training state.

Counterpart of ``bunmpc_tpu/utils/checkpoint.py`` (the reference saves the
whole torch module with its normalization payload,
behavioral_cloning_train.py:169-189). A policy is saved in the JAX
package's format, so each package loads the other's: ``meta.json`` (the
network's hyperparameters) and ``payload.npz`` with the normalization stats
in float32 and one array per flax parameter under ``param::<flax path>``
(``param::['Dense_0']/['kernel']``, a kernel stored (in, out)). Loading goes
through ``convert.policy_bundle_from_flax``.

The JAX package checkpoints training state with orbax; the port writes the
module's and the optimizer's state dicts, the step and an ``extra`` dict
with ``torch.save`` instead (a named deviation: the two packages do not read
each other's training state).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import convert
from ..learning.networks import PolicyBundle


def _key(*path) -> str:
    return "param::" + "/".join(f"['{p}']" for p in path)


def save_policy(bundle: PolicyBundle, path: str):
    """Write ``bundle`` to the directory ``path`` in the JAX package's format.
    A BatchNorm net raises: the format holds no batch statistics."""
    module = bundle.module
    if len(module.norm):
        raise ValueError("save_policy: the checkpoint format holds no BatchNorm statistics")
    os.makedirs(path, exist_ok=True)
    meta = {
        "output_size": module.dense[-1].out_features,
        "num_hidden_layer": len(module.dense) - 1,
        "hidden_dim": module.dense[0].out_features,
        "batch_norm": False,
    }
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)

    def host(t):
        return t.detach().cpu().numpy()

    flat = {}
    for i, layer in enumerate(module.dense):
        flat[_key(f"Dense_{i}", "bias")] = host(layer.bias)
        flat[_key(f"Dense_{i}", "kernel")] = host(layer.weight).T
    stats = {name: host(torch.as_tensor(getattr(bundle, name))).astype(np.float32)
             for name in ("state_mean", "state_std", "goal_mean", "goal_std")}
    np.savez_compressed(os.path.join(path, "payload.npz"), **stats, **flat)


def load_policy(path: str, device="cuda", dtype=torch.float32) -> PolicyBundle:
    """The policy saved at ``path`` (by either package) on ``device``."""
    from ..mpc.kino_dyn import resolve_device

    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("batch_norm"):
        raise ValueError("load_policy: the checkpoint format holds no BatchNorm statistics")
    with np.load(os.path.join(path, "payload.npz"), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    params = {}
    for key, a in arrays.items():
        if key.startswith("param::"):
            node = params
            parts = [p.strip("[]'\"") for p in key[len("param::"):].split("/")]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = a
    stats = [arrays[k].astype(np.float32) for k in ("state_mean", "state_std", "goal_mean",
                                                     "goal_std")]
    return convert.policy_bundle_from_flax(params, *stats, device=resolve_device(device),
                                           dtype=dtype)


def save_train_state(path: str, params: dict, opt_state: dict, step: int,
                     extra: dict | None = None):
    """Mid-training checkpoint: a module's ``state_dict()``, an optimizer's
    ``state_dict()``, the step and ``extra`` (plain Python values)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"params": params, "opt_state": opt_state, "step": int(step),
                "extra": extra or {}}, path)


def load_train_state(path: str, device="cuda") -> dict:
    """``{"params", "opt_state", "step", "extra"}`` as saved, tensors on
    ``device``."""
    from ..mpc.kino_dyn import resolve_device

    return torch.load(path, map_location=resolve_device(device), weights_only=True)
