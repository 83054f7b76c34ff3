"""Robustness envelopes: maximum survivable push search.

Counterpart of ``bunmpc_tpu/eval/max_force.py`` (reference
max_force_search.py:32-344 binary-searches the largest external push the
controller survives; analysis/solo12_robustness_analysis.py applies random
pushes until failure). The binary search stays host-side (few steps), but
each probe evaluates a whole *batch* of push directions at once: one
``rollout_mpc`` call, which solves the batch once per replanning window (K1
and K2 once each with the "cuda" backends).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout
from .velocity_grid import batch_start, host


def survival_fraction(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    magnitude: float,
    directions,  # (B, 3) unit vectors
    push_start: int,
    push_duration: int,
    admm_cfg=None,
    ddp_cfg=None,
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
) -> float:
    """Fraction of push directions the MPC survives at the given magnitude:
    episode b is pushed by ``magnitude * directions[b]`` newtons over steps
    ``push_start .. push_start + push_duration``; the (B, T, 3) push is built
    on the rollout's device. The rollout keeps ``rollout_mpc``'s default
    warm start (carried for "tiled" specs, as ``eval_mpc_grid``)."""
    B = len(directions)
    T = cfg.episode_length
    start = batch_start(spec, state0, B)
    like = start.q
    d = torch.as_tensor(host(directions), dtype=like.dtype, device=like.device)
    push = torch.zeros((B, T, 3), dtype=like.dtype, device=like.device)
    push[:, push_start : push_start + push_duration, :] = magnitude * d[:, None, :]
    vd = torch.as_tensor(host(v_des), dtype=like.dtype, device=like.device).expand(B, 3)
    wd = torch.full((B,), float(w_des), dtype=like.dtype, device=like.device)
    res = rollout.rollout_mpc(spec, sim_params, cfg, start, vd, wd, push_force=push,
                              admm_cfg=admm_cfg, ddp_cfg=ddp_cfg, admm_backend=admm_backend,
                              ik_backend=ik_backend)
    return float(1.0 - np.mean(host(res.failed)))


def max_force_search(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    v_des,
    w_des,
    f_low: float = 0.0,
    f_high: float = 30.0,
    n_bisect: int = 5,
    directions: np.ndarray | None = None,
    push_start: int | None = None,
    push_duration: int = 100,
    survival_threshold: float = 0.5,
    admm_cfg=None,
    ddp_cfg=None,
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
):
    """Binary search for the largest magnitude with survival above threshold
    (reference max_force_search.py search loop). Returns (f_max, history)."""
    if directions is None:
        ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
        directions = np.stack([np.cos(ang), np.sin(ang), np.zeros(8)], -1).astype(np.float32)
    if push_start is None:
        push_start = cfg.episode_length // 3
    history = []
    for _ in range(n_bisect):
        mid = 0.5 * (f_low + f_high)
        frac = survival_fraction(
            spec, sim_params, cfg, state0, v_des, w_des, mid, directions,
            push_start, push_duration, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
            admm_backend=admm_backend, ik_backend=ik_backend,
        )
        history.append((mid, frac))
        if frac >= survival_threshold:
            f_low = mid
        else:
            f_high = mid
    return f_low, history
