"""Effects-of-cc-replanning evaluation: vc vs cc-static vs cc-replanned.

Counterpart of ``bunmpc_tpu/eval/cc_replanning.py`` (reference ablation
drivers behavioral_cloning_evaluation_effects_of_cc_replanning.py:339-357,
behavioral_cloning_evaluation_with_cc_replan.py,
test_policy_with_cc_replan.py): for each command, roll out

* ``vc``          — the velocity-conditioned policy on vc goals,
* ``cc_static``   — the contact-conditioned policy on goals PREcomputed from
  the desired contact schedule against the straight-line estimated CoM
  (reference rollout_policy with a desired_goal array, utils.py:187-219),
* ``cc_replanned`` — the contact-conditioned policy with goals recomputed
  online against the measured CoM every step (reference
  rollout_policy_with_cc_replanning, simulation.py:834).

The reference runs one PyBullet episode per (variant, command) sequentially;
here each variant's whole command batch is one batched policy rollout (the
desired schedules are host-side numpy, padded to a common event count so the
batch stays fixed-shape). No MPC runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kin import algorithms as K
from ..learning import goals as GU
from ..learning.contact_planner import ContactPlanner
from ..mpc.kino_dyn import CyclicMpcSpec
from ..sim import physics, rollout
from .velocity_grid import batch_start, host


@dataclasses.dataclass
class CcReplanResult:
    v_des: np.ndarray  # (N, 3)
    w_des: np.ndarray  # (N,)
    # per-variant (N,) arrays
    vx_mse: dict
    vy_mse: dict
    survived: dict

    def summary(self):
        out = {}
        for name in self.vx_mse:
            ok = self.survived[name]
            out[name] = {
                "survival_rate": float(np.mean(ok)),
                "vx_mse_mean": float(np.mean(self.vx_mse[name][ok])) if ok.any() else float("nan"),
                "vy_mse_mean": float(np.mean(self.vy_mse[name][ok])) if ok.any() else float("nan"),
            }
        return out

    def to_csv(self, path: str):
        import csv

        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["variant", "vx_des", "vy_des", "w_des", "vx_mse", "vy_mse", "survived"])
            for name in self.vx_mse:
                for i in range(len(self.w_des)):
                    w.writerow(
                        [
                            name,
                            self.v_des[i, 0],
                            self.v_des[i, 1],
                            self.w_des[i],
                            self.vx_mse[name][i],
                            self.vy_mse[name][i],
                            int(self.survived[name][i]),
                        ]
                    )


def desired_schedules(
    spec: CyclicMpcSpec, q0, v0, v_des_batch, w_des_batch, episode_length: int,
    start_time: float = 0.0,
):
    """Per-command desired contact schedules, padded to a common event count
    by repeating each foot's last touchdown, which ``cc_goal_fn``'s search
    treats as a plateau. One batched ``ContactPlanner`` call plans every
    command from the one start ``q0`` (the JAX package calls it once per
    command and pads each episode by repeating its last event row, whose
    feet past their own touchdowns hold zero rows: ROADMAP "Faults found").
    Returns (N, n_eff, n_events, 4) numpy [step, x, y, z]."""
    v_des = host(v_des_batch)
    N = len(v_des)
    q0 = np.tile(host(q0).reshape(1, -1), (N, 1))
    v0 = np.tile(host(v0).reshape(1, -1), (N, 1))
    sched, _ = ContactPlanner(spec).get_contact_schedule(
        torch.as_tensor(q0, dtype=torch.float64), v0, v_des, host(w_des_batch), episode_length,
        start_time)
    return sched


def static_cc_goals(
    spec: CyclicMpcSpec, schedules, q0, v_des_batch, episode_length: int,
    goal_horizon: int = 1,
):
    """Precomputed (no-replanning) cc goals per command: the desired schedule
    evaluated against the straight-line estimated CoM (utils.py:187-219 +
    construct_cc_goal utils.py:36-84). Returns (N, T, 3*n_eff*goal_horizon),
    short horizons padded by repeating the last goal row."""
    ne = spec.n_eff
    com0 = K.com(spec.model, torch.as_tensor(host(q0), dtype=torch.float64)).numpy()
    outs = []
    for sched, vd in zip(host(schedules), host(v_des_batch)):
        com_est = GU.estimated_com_trajectory(com0, vd, episode_length)
        g = GU.construct_cc_goal(
            episode_length, ne, sched, com_est, goal_horizon=goal_horizon
        )
        if g.shape[0] == 0:
            g = np.zeros((1, 3 * ne * goal_horizon))
        if g.shape[0] < episode_length:
            g = np.concatenate(
                [g, np.repeat(g[-1:], episode_length - g.shape[0], axis=0)]
            )
        outs.append(g[:episode_length])
    return np.stack(outs)


def static_goal_fn(goals: torch.Tensor):
    """``goal(step, q)`` reading row ``step`` of the precomputed (N, T, g)
    goals through the device step counter (a policy substep is one CUDA
    graph replay on the card, so the row must not be a Python index)."""

    def goal(step, q):
        return goals.index_select(1, step.view(1))[:, 0]

    return goal


def compare_cc_replanning(
    spec: CyclicMpcSpec,
    sim_params: physics.SimParams,
    cfg: rollout.RolloutConfig,
    state0: physics.SimState,
    vc_policy_fn,
    cc_policy_fn,
    v_des_batch,  # (N, 3)
    w_des_batch,  # (N,)
    goal_horizon: int = 1,
    skip_frac: float = 0.2,
) -> CcReplanResult:
    """Run all three variants over the command batch and report tracking MSE
    + survival per variant (the reference's per-command wandb tables). The
    rollouts run on ``state0``'s device and dtype (``spec.device`` in
    float32 for arrays)."""
    N = len(host(w_des_batch))
    start = batch_start(spec, state0, N)
    like = start.q
    v_des = torch.as_tensor(host(v_des_batch), dtype=like.dtype, device=like.device)
    w_des = torch.as_tensor(host(w_des_batch), dtype=like.dtype, device=like.device)
    q0, v0 = start.q[0], start.v[0]

    scheds = desired_schedules(spec, q0, v0, v_des_batch, w_des_batch, cfg.episode_length)
    goals_static = torch.as_tensor(
        static_cc_goals(spec, scheds, q0, v_des_batch, cfg.episode_length,
                        goal_horizon=goal_horizon),
        dtype=like.dtype, device=like.device,
    )

    results = {
        "vc": rollout.rollout_policy(spec, sim_params, cfg, start, v_des, w_des, vc_policy_fn),
        "cc_static": rollout.rollout_policy(spec, sim_params, cfg, start, v_des, w_des,
                                            cc_policy_fn, goal_fn=static_goal_fn(goals_static)),
        "cc_replanned": rollout.rollout_policy_cc(spec, sim_params, cfg, start, v_des, w_des,
                                                  cc_policy_fn, scheds,
                                                  goal_horizon=goal_horizon),
    }

    skip = int(skip_frac * cfg.episode_length)
    vd = host(v_des)
    vx_mse, vy_mse, survived = {}, {}, {}
    for name, res in results.items():
        v_act = host(res.states[..., 0:2])
        vx_mse[name] = np.mean((v_act[:, skip:, 0] - vd[:, None, 0]) ** 2, axis=1)
        vy_mse[name] = np.mean((v_act[:, skip:, 1] - vd[:, None, 1]) ** 2, axis=1)
        survived[name] = ~host(res.failed)
    return CcReplanResult(
        v_des=vd, w_des=host(w_des),
        vx_mse=vx_mse, vy_mse=vy_mse, survived=survived,
    )
