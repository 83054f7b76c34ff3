"""Cyclic gait phase machine + vectorized Raibert contact planner.

Counterpart of ``bunmpc_tpu/mpc/gait.py`` (reference
src/gait_planner/gait_planner.cpp:31-121 and
examples/mpc/abstract_cyclic_gen.py:159-414). Phases for every (knot, foot)
pair come from a broadcast modulo; the one sequential dependency — a foot in
contact keeps the location planned at its touchdown — is a loop over the
horizon with all feet and batch elements in parallel.

Reference quirks preserved: the first-knot dt shrink rounded to 2 decimals,
the hip projection by knot index, the 1e-4 stance tolerance and the swing
via-point flag over the first half of swing. Beyond the reference (as in the
JAX package): touchdown-location noise and touchdown and swing heights read
off a terrain heightfield.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kin import algorithms as K
from ..utils.quat import quat_to_rot, yaw_quat
from .centroidal import ContactPlan

_G = 9.81


@dataclasses.dataclass(frozen=True)
class GaitParams:
    """Static cyclic-gait timing."""

    gait_period: float
    stance_percent: tuple  # per foot
    phase_offset: tuple  # per foot
    gait_dt: float
    step_height: float


@dataclasses.dataclass(frozen=True)
class RaibertPlannerParams:
    """Static planner constants derived from the robot at q0."""

    hip_offsets: np.ndarray  # (n_eff, 3) hip positions relative to CoM at q0
    foot_size: float


def _mod(x, y: float):
    """Floor modulo built on fmod, as ``jnp.mod`` computes it."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _vec(vals, like):
    """A tuple of ``GaitParams`` as a tensor of ``like``'s dtype and device,
    converted once (``K.const``): a substep captured in a CUDA graph (the
    closed loop's ``swing_blend``) may copy nothing from the host."""
    return K.const(vals, like)


def phi(params: GaitParams, t):
    """Phase time of each foot: mod(t + offset*period, period) (..., n_eff)."""
    off = _vec(params.phase_offset, t)
    return _mod(t[..., None] + off * params.gait_period, params.gait_period)


def in_stance(params: GaitParams, t):
    """1 where the foot is in stance at time t (..., n_eff), with the
    reference's 1e-4 boundary tolerance."""
    st = _vec(params.stance_percent, t) * params.gait_period
    return (phi(params, t) <= st + 1e-4).to(t.dtype)


def percent_in_phase(params: GaitParams, t):
    """Fraction of the current (stance or swing) phase elapsed (..., n_eff)."""
    st = _vec(params.stance_percent, t) * params.gait_period
    ph = phi(params, t)
    return torch.where(ph <= st + 1e-4, ph / st, (ph - st) / (params.gait_period - st))


def contact_phase_plan(params: GaitParams, t, horizon: int, dt: float):
    """Stance flags over a horizon of fixed knots, (..., horizon, n_eff)
    (gait_planner.cpp:96-102)."""
    ts = t[..., None] + torch.arange(horizon, dtype=t.dtype, device=t.device) * dt
    return in_stance(params, ts)


def first_knot_dt(params: GaitParams, t):
    """dt of the first knot (abstract_cyclic_gen.py:385-390)."""
    dt0 = params.gait_dt - torch.round(_mod(t, params.gait_dt), decimals=2)
    return torch.where(dt0 == 0.0, torch.full_like(dt0, params.gait_dt), dt0)


def create_cnt_plan(
    gait: GaitParams,
    planner: RaibertPlannerParams,
    horizon: int,
    q,  # (..., nq)
    t,  # (...,)
    v_des,  # (..., 3) desired CoM velocity (already in the heading frame)
    w_des,  # (...,)
    com,  # (..., 3) current CoM (world)
    ee_pos,  # (..., n_eff, 3) current foot positions (world)
    noise_xy=None,  # optional (..., H, n_eff, 2) touchdown-location noise
    terrain=None,  # optional sim.physics.Terrain (uneven-ground planning)
    terrain_offset=None,  # (..., 2) world xy of the plan origin (q is origin-reset)
):
    """Dense contact plan ``(ContactPlan, swing_mask)``.

    ``noise_xy`` moves each planned touchdown by ``noise_xy`` times its
    distance from the plan's origin (contact-location fault injection,
    abstract_cyclic_gen.py:376-384). With ``terrain``, touchdown and
    early-swing heights are the heightfield's at the planned xy plus the
    foot size (the reference plans flat ground); the plan is origin-reset,
    so ``terrain_offset`` maps plan xy back to world xy."""
    dtype = q.dtype
    R = quat_to_rot(yaw_quat(q[..., 3:7]))
    vtrack = v_des[..., 0:2]
    z_h = com[..., 2]

    hip_off = torch.as_tensor(planner.hip_offsets, dtype=dtype, device=q.device)
    hip_world = (R[..., None, :, :] @ hip_off[..., None])[..., 0]  # (..., ne, 3)
    raibert = (
        0.5 * vtrack[..., None, :] * gait.gait_period * _vec(gait.stance_percent, q)[:, None]
    )  # (..., ne, 2)
    ang = 0.5 * torch.sqrt(z_h / _G)[..., None] * vtrack
    # np.cross([ax, ay, 0], [0, 0, w]) = [ay*w, -ax*w, 0]
    ang_step = torch.stack([ang[..., 1] * w_des, -ang[..., 0] * w_des], dim=-1)

    knot_idx = torch.arange(horizon, dtype=dtype, device=q.device)
    knot_t = t[..., None] + knot_idx * gait.gait_dt  # (..., H)
    cnt = in_stance(gait, knot_t)  # (..., H, ne)
    per_ph = percent_in_phase(gait, knot_t)

    drift = knot_idx[:, None] * gait.gait_dt * vtrack[..., None, :]  # (..., H, 2)
    hip_xy = com[..., None, None, 0:2] + hip_world[..., None, :, 0:2] + drift[..., :, None, :]
    touchdown_xy = hip_xy + raibert[..., None, :, :] + ang_step[..., None, None, :]
    if noise_xy is not None:  # scaled by the norm of the planned location
        nrm = torch.linalg.vector_norm(touchdown_xy, dim=-1, keepdim=True)
        touchdown_xy = touchdown_xy + nrm * noise_xy
    swing_early_xy = hip_xy + ang_step[..., None, None, :]

    if terrain is None:
        z_td = torch.full(touchdown_xy.shape[:-1], planner.foot_size, dtype=dtype,
                          device=q.device)
        z_sw_early = z_td
    else:
        off = 0.0 if terrain_offset is None else terrain_offset[..., None, None, :]
        z_td = terrain.height_at(touchdown_xy + off) + planner.foot_size
        z_sw_early = terrain.height_at(swing_early_xy + off) + planner.foot_size
    touchdown = torch.cat([touchdown_xy, z_td[..., None]], dim=-1)  # (..., H, ne, 3)
    swing_loc = torch.where(
        (per_ph < 0.5)[..., None],
        torch.cat([swing_early_xy, z_sw_early[..., None]], dim=-1),
        touchdown,
    )

    # via-point mask over the first half of swing; never on knot 0
    swing_mask = (cnt == 0) & (per_ph - 0.5 < 0.02)
    swing_mask[..., 0, :] = False

    # knot 0 keeps the measured foot positions; a foot in contact keeps the
    # location planned at its touchdown
    rs = [ee_pos]
    prev_cnt, prev_r = cnt[..., 0, :], ee_pos
    for i in range(1, horizon):
        c_i = cnt[..., i, :]
        landed = (c_i == 1) & (prev_cnt == 0)
        r_i = torch.where(
            (c_i == 1)[..., None],
            torch.where(landed[..., None], touchdown[..., i, :, :], prev_r),
            swing_loc[..., i, :, :],
        )
        rs.append(r_i)
        prev_cnt, prev_r = c_i, r_i
    r = torch.stack(rs, dim=-3)

    dts = torch.full_like(knot_t, gait.gait_dt)
    dts[..., 0] = first_knot_dt(gait, t)
    return ContactPlan(cnt=cnt, r=r, dt=dts), swing_mask
