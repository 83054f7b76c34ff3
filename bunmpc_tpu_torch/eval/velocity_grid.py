"""Velocity-tracking evaluation over command grids.

Counterpart of ``bunmpc_tpu/eval/velocity_grid.py`` (reference
behavioral_cloning_vc_evaluation_iterative.py, test_sweep_policy.py,
sweep eval loops in safedagger_modified.py:491-516): roll out over a grid of
commanded (vx, vy, w) and report per-command velocity-tracking MSE and
survival. The reference evaluates commands sequentially, one PyBullet episode
each; here the whole grid is one batched rollout: ``rollout_mpc`` solves the
grid once per replanning window (K1 and K2 once each with the "cuda"
backends), ``rollout_policy`` runs the policy on the grid in every substep.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mpc.kino_dyn import CyclicMpcSpec, resolve_device
from ..sim import physics, rollout


@dataclasses.dataclass
class GridEvalResult:
    v_des: np.ndarray  # (N, 3)
    w_des: np.ndarray  # (N,)
    vx_mse: np.ndarray  # (N,)
    vy_mse: np.ndarray  # (N,)
    survived: np.ndarray  # (N,) bool
    mean_speed: np.ndarray  # (N,)
    fail_step: np.ndarray = None  # (N,) survival time in steps (T if survived)

    def summary(self):
        ok = self.survived
        out = {
            "survival_rate": float(np.mean(ok)),
            "vx_mse_mean": float(np.mean(self.vx_mse[ok])) if ok.any() else float("nan"),
            "vy_mse_mean": float(np.mean(self.vy_mse[ok])) if ok.any() else float("nan"),
        }
        if self.fail_step is not None:
            # graded progress signal even when nothing survives the full
            # episode (binary survival saturates at 0 early in learning)
            out["mean_survival_ms"] = float(np.mean(self.fail_step))
        return out

    def to_csv(self, path: str):
        """Tabular export — the portable stand-in for the reference's xlsx
        error tables (reference plot/error_data/*.xlsx)."""
        import csv

        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["vx_des", "vy_des", "w_des", "vx_mse", "vy_mse", "survived", "mean_speed"])
            for i in range(len(self.w_des)):
                w.writerow(
                    [
                        self.v_des[i, 0],
                        self.v_des[i, 1],
                        self.w_des[i],
                        self.vx_mse[i],
                        self.vy_mse[i],
                        int(self.survived[i]),
                        self.mean_speed[i],
                    ]
                )


def host(a) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def batch_start(spec: CyclicMpcSpec, state0, B: int) -> physics.SimState:
    """One start state (q (nq,), v (nv,); or a batch of one) as B copies: a
    tensor keeps its device and dtype, anything else goes to ``spec.device``
    in float32."""
    q, v = state0
    device = resolve_device(q.device if torch.is_tensor(q) else spec.device)
    dtype = q.dtype if torch.is_tensor(q) else torch.float32
    q, v = (torch.as_tensor(a, dtype=dtype, device=device) for a in (q, v))
    if q.numel() != q.shape[-1] or v.numel() != v.shape[-1]:
        raise ValueError(f"state0: one state, got q {tuple(q.shape)}, v {tuple(v.shape)}")
    return physics.SimState(q=q.reshape(1, -1).expand(B, -1).contiguous(),
                            v=v.reshape(1, -1).expand(B, -1).contiguous())


def grid_commands(vx_values, w_values, vy: float, like: torch.Tensor):
    """The (vx, w) grid, vx-major, as ``(v_des (N, 3), w_des (N,))`` in
    ``like``'s dtype and device."""
    grid = [(vx, w) for vx in vx_values for w in w_values]
    v_des = torch.tensor([[vx, vy, 0.0] for vx, _ in grid], dtype=like.dtype, device=like.device)
    w_des = torch.tensor([w for _, w in grid], dtype=like.dtype, device=like.device)
    return v_des, w_des


def _evaluate(res, v_des, w_des, skip_steps: int):
    v_act = host(res.states[..., 0:2])  # local-frame base velocity
    v_des, w_des = host(v_des), host(w_des)
    vx_mse = np.mean((v_act[:, skip_steps:, 0] - v_des[:, None, 0]) ** 2, axis=1)
    vy_mse = np.mean((v_act[:, skip_steps:, 1] - v_des[:, None, 1]) ** 2, axis=1)
    T = res.states.shape[1]
    failed = host(res.failed)
    fail_step = np.where(failed, host(res.fail_step), T)
    return GridEvalResult(
        v_des=v_des,
        w_des=w_des,
        vx_mse=vx_mse,
        vy_mse=vy_mse,
        survived=~failed,
        mean_speed=v_act[:, skip_steps:, 0].mean(axis=1),
        fail_step=fail_step,
    )


def eval_mpc_grid(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    vx_values,
    w_values=(0.0,),
    vy: float = 0.0,
    skip_frac: float = 0.2,
    admm_cfg=None,
    ddp_cfg=None,
    admm_backend: str = "cuda",
    ik_backend: str = "cuda",
) -> GridEvalResult:
    """MPC tracking over a (vx, w) grid — the expert baseline the policy is
    compared to (reference error_mpc, test_bayesian_optimization.py:477-515).
    One ``rollout_mpc`` call runs the grid with its default warm start: it
    carries (X, F, P) for "tiled" specs, as the JAX package's does."""
    start = batch_start(spec, state0, len(vx_values) * len(w_values))
    v_des, w_des = grid_commands(vx_values, w_values, vy, start.q)
    res = rollout.rollout_mpc(spec, sim_params, cfg, start, v_des, w_des, admm_cfg=admm_cfg,
                              ddp_cfg=ddp_cfg, admm_backend=admm_backend, ik_backend=ik_backend)
    return _evaluate(res, v_des, w_des, int(skip_frac * cfg.episode_length))


def eval_policy_grid(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    policy_fn,
    vx_values,
    w_values=(0.0,),
    vy: float = 0.0,
    skip_frac: float = 0.2,
) -> GridEvalResult:
    """Policy tracking over the same grid (reference error_policy,
    test_bayesian_optimization.py:517-560)."""
    start = batch_start(spec, state0, len(vx_values) * len(w_values))
    v_des, w_des = grid_commands(vx_values, w_values, vy, start.q)
    res = rollout.rollout_policy(spec, sim_params, cfg, start, v_des, w_des, policy_fn)
    return _evaluate(res, v_des, w_des, int(skip_frac * cfg.episode_length))
