"""The closed loop, plain: a frozen copy of the port's ``sim/rollout.py``
MPC loop (``rollout_mpc``) without its options (no sensor bias, push,
terrain, per-episode gains, swing blend or force gate) and without CUDA
graphs: each window one batched solve (``mpc.kino_dyn.solve_mpc_batch``,
the plain solvers) with the previous window's (X, F, P) carried behind the
health gate, then ``steps_per_plan`` 1 ms substeps (the inverse-dynamics
controller, the physics step, the failure predicate, the records).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..kin import algorithms as K
from ..mpc import gait as G
from ..mpc import kino_dyn as KD
from ..utils.quat import quat_to_rot, rot_to_rpy
from . import controllers, physics


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    episode_length: int  # total 1 ms steps
    plan_freq: float = 0.05  # s between replans (20 Hz)
    sim_dt: float = 0.001
    kp: float = 3.0  # PD gains of the pd_target action encoding
    kd: float = 0.05
    gait_id: float = 1.0  # vc-goal gait indicator
    fail_angle_deg: float = 30.0
    gait_period: float = 0.5

    @property
    def steps_per_plan(self) -> int:
        return int(round(self.plan_freq / self.sim_dt))

    @property
    def n_windows(self) -> int:
        return self.episode_length // self.steps_per_plan


class Records(NamedTuple):
    states: torch.Tensor  # (B, T, 43) state features
    actions: torch.Tensor  # (B, T, nj) pd_target actions
    base: torch.Tensor  # (B, T, 3)
    failed: torch.Tensor  # (B,)
    fail_step: torch.Tensor  # (B,)
    final_q: torch.Tensor
    final_v: torch.Tensor
    plans: list  # each window's MpcPlan


def state_features(model, eff_frames, q, v, fk=None):
    """n_state=43 featurization: v, the base's xy relative to each foot,
    q[2:]."""
    R, p = K.fk(model, q) if fk is None else fk
    feet = torch.stack([K._frame_pos(model, R, p, n, q) for n in eff_frames], dim=-2)
    base_wrt_foot = (q[..., None, 0:2] - feet[..., 0:2]).flatten(-2)
    return torch.cat([v, base_wrt_foot, q[..., 2:]], dim=-1)


def failed_state(cfg: RolloutConfig, q, time_elapsed):
    """Height/attitude failure envelope, after a grace period of one gait
    cycle."""
    rpy = rot_to_rpy(quat_to_rot(q[..., 3:7]))
    ang = math.radians(cfg.fail_angle_deg)
    bad = ((q[..., 2] < 0.1) | (q[..., 2] > 2.0) | (torch.abs(rpy[..., 0]) > ang)
           | (torch.abs(rpy[..., 1]) > ang))
    return bad & (time_elapsed > (cfg.gait_period / cfg.sim_dt))


def settle_state(model, eff_frames, sim_params, q, v, kp, kd, ms=500, gain_scale=6.0):
    """PD-hold the initial pose for ``ms`` steps: ``(q, v)`` settled."""
    q0j = q[..., 7:]
    for _ in range(ms):
        tau = -gain_scale * kp * (q[..., 7:] - q0j) - gain_scale * kd * v[..., 6:]
        s, _ = physics.step(model, eff_frames, sim_params, physics.SimState(q, v), tau)
        q, v = s.q, s.v
    return q, v


def carried_warm_start(spec, qm0, vm0, prev, n_shift: int):
    """The previous window's (X, F, dual P) shifted one window and moved into
    the new plan frame where it is finite and sane; elsewhere the tiled
    centroidal state, zero forces and dual."""
    model = spec.model
    B, H = qm0.shape[0], spec.horizon
    q_reset = torch.cat([torch.zeros_like(qm0[:, 0:2]), qm0[:, 2:]], dim=-1)
    com, h_lin, h_ang = K.centroidal_momentum(model, q_reset, vm0)
    defX = torch.cat([com, h_lin / model.total_mass, h_ang], dim=-1)[:, None].expand(B, H + 1, 9)
    if prev is None:
        zF = torch.zeros((B, H, spec.n_eff, 3), dtype=qm0.dtype, device=qm0.device)
        return defX.contiguous(), zF, torch.zeros_like(defX)
    prevX, prevF, prevP, prev_xy = prev

    def shift(a):
        return torch.cat([a[:, n_shift:], a[:, -1:].expand((B, n_shift) + a.shape[2:])], dim=1)

    dxy = prev_xy - qm0[:, 0:2]
    shX = shift(prevX)
    shX = torch.cat([shX[..., 0:2] + dxy[:, None, :], shX[..., 2:]], dim=-1)
    shF, shP = shift(prevF), shift(prevP)
    f_sane = 10.0 * model.total_mass * 9.81
    healthy = (torch.isfinite(shX).flatten(1).all(1) & torch.isfinite(shF).flatten(1).all(1)
               & (shF.abs().flatten(1).amax(1) < f_sane))
    h3, h4 = healthy[:, None, None], healthy[:, None, None, None]
    return (torch.where(h3, shX, defX).contiguous(),
            torch.where(h4, shF, torch.zeros_like(shF)),
            torch.where(h3, shP, torch.zeros_like(shP)))


def rollout_mpc(spec, sim_params, cfg: RolloutConfig, q, v, v_des, w_des, admm_cfg, ddp_cfg,
                gains: controllers.IdControllerGains, carry: bool = True) -> Records:
    """MPC expert rollouts of a batch of episodes from (q, v) at time 0, in
    the dtype and on the device of ``q``."""
    model, eff = spec.model, spec.eff_frames
    B, T, spp = q.shape[0], cfg.n_windows * cfg.steps_per_plan, cfg.steps_per_plan
    n_shift = max(1, int(round(cfg.plan_freq / spec.params.gait_dt)))
    failed = torch.zeros(B, dtype=torch.bool, device=q.device)
    fail_step = torch.full((B,), cfg.episode_length, dtype=torch.int64, device=q.device)
    states, actions, base, plans = [], [], [], []
    prev = None
    k = 0
    for w in range(cfg.n_windows):
        t = KD.window_clock(0.0, w, cfg.plan_freq, q).expand(B)
        warm = carried_warm_start(spec, q, v, prev, n_shift) if carry else None
        plan = KD.solve_mpc_batch(spec, q, v, t, v_des, w_des, admm_cfg=admm_cfg,
                                  ddp_cfg=ddp_cfg, warm_start=warm)
        plans.append(plan)
        if carry:
            prev = (plan.X_opt, plan.F_opt, plan.P_opt, q[:, 0:2].clone())
        mpc_bad = (torch.isnan(plan.f_int).flatten(1).any(1)
                   | torch.isnan(plan.xs_int).flatten(1).any(1))
        for i in range(spp):
            kin = K.body_velocities(model, q, v)
            fk = (kin[2], kin[3])
            xs = plan.xs_int[:, i]
            q_des, v_des_traj = xs[:, :model.nq], xs[:, model.nq:]
            tau_ff, tau_fb = controllers.id_joint_torques(
                model, eff, gains, q, v, q_des, v_des_traj, plan.us_int[:, i], plan.f_int[:, i])
            lim = physics.per_robot(sim_params.torque_limit)
            tau = torch.clamp(tau_ff + tau_fb, -lim, lim)
            new, _ = physics.step(model, eff, sim_params, physics.SimState(q, v), tau, kin=kin)
            kk = torch.full((), k, dtype=torch.int64, device=q.device)
            now_failed = failed | failed_state(cfg, q, kk) | mpc_bad
            states.append(state_features(model, eff, q, v, fk=fk))
            actions.append((tau + cfg.kd * v[..., 6:]) / cfg.kp + q[..., 7:])
            base.append(q[:, 0:3])
            fail_step = torch.where(now_failed & ~failed, kk, fail_step)
            q = torch.where(now_failed[:, None], q, new.q)
            v = torch.where(now_failed[:, None], v, new.v)
            failed = now_failed
            k += 1
    return Records(states=torch.stack(states, 1), actions=torch.stack(actions, 1),
                   base=torch.stack(base, 1), failed=failed, fail_step=fail_step, final_q=q,
                   final_v=v, plans=plans)
