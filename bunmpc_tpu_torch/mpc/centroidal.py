"""Batched centroidal-dynamics constraint operators for the biconvex MPC.

Counterpart of ``bunmpc_tpu/mpc/centroidal.py`` (reference
src/dynamics/centroidal.cpp:57-127). ``A_x`` and ``A_f`` are never
materialized: both are structured stencils (block-bidiagonal in the knot
index with 3-vector cross-product blocks), so each matvec is a handful of
batched elementwise ops.

State layout  X: (..., H+1, 9)  = [com(3), vcom(3), amom(3)] per knot
Force layout  F: (..., H, n_eff, 3)
Contact plan: cnt (..., H, n_eff) in {0,1};  r (..., H, n_eff, 3);  dt (..., H)
"""

from __future__ import annotations

import dataclasses

import torch

_G = 9.81


@dataclasses.dataclass(frozen=True)
class ContactPlan:
    """Dense contact plan (reference ``set_contact_arrays`` layout)."""

    cnt: torch.Tensor  # (..., H, n_eff) contact flags
    r: torch.Tensor  # (..., H, n_eff, 3) contact locations (world)
    dt: torch.Tensor  # (..., H) knot durations


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _pad_row(rows):
    """Append the zero terminal row block: (..., H, 9) -> (..., H+1, 9)."""
    return torch.cat([rows, torch.zeros_like(rows[..., :1, :])], dim=-2)


# --- F-subproblem operators:  A_x(X) F  and  b_x(X) ---


def ax_apply(plan: ContactPlan, m: float, X, F):
    """A_x(X) @ F -> (..., H+1, 9): rows t < H are
    [0, dt/m sum c f, dt sum c (r - com_t) x f]; the terminal block is zero."""
    cF = plan.cnt[..., None] * F
    dt = plan.dt[..., None]
    lin = dt * torch.sum(cF, dim=-2) / m
    arm = plan.r - X[..., :-1, None, 0:3]
    ang = dt * torch.sum(_cross(arm, cF), dim=-2)
    return _pad_row(torch.cat([torch.zeros_like(lin), lin, ang], dim=-1))


def ax_applyT(plan: ContactPlan, m: float, X, Y):
    """A_x(X)^T @ Y -> force space (..., H, n_eff, 3)."""
    y_lin = Y[..., :-1, 3:6]
    y_ang = Y[..., :-1, 6:9]
    dt = plan.dt[..., None, None]
    arm = plan.r - X[..., :-1, None, 0:3]
    out = dt * (y_lin[..., None, :] / m + _cross(y_ang[..., None, :].expand_as(arm), arm))
    return plan.cnt[..., None] * out


def bx_vec(plan: ContactPlan, X):
    """b_x(X): Delta-state targets of the force subproblem."""
    dX = X[..., 1:, :] - X[..., :-1, :]
    z = torch.zeros_like(plan.dt)
    grav = torch.stack([z, z, _G * plan.dt, z, z, z], dim=-1)
    rows = torch.cat([torch.zeros_like(dX[..., 0:3]), dX[..., 3:9] + grav], dim=-1)
    return _pad_row(rows)


# --- X-subproblem operators:  A_f(F) X  and  b_f(F) ---


def af_apply(plan: ContactPlan, m: float, F, X):
    """A_f(F) @ X -> (..., H+1, 9): Euler-step rows t < H plus the row that
    pins X_0."""
    Xt, Xt1 = X[..., :-1, :], X[..., 1:, :]
    dt = plan.dt[..., None]
    cF_tot = torch.sum(plan.cnt[..., None] * F, dim=-2)
    com_rows = Xt[..., 0:3] - Xt1[..., 0:3] + dt * Xt1[..., 3:6]
    vel_rows = Xt[..., 3:6] - Xt1[..., 3:6]
    ang_rows = Xt[..., 6:9] - Xt1[..., 6:9] + dt * _cross(cF_tot, Xt[..., 0:3])
    rows = torch.cat([com_rows, vel_rows, ang_rows], dim=-1)
    return torch.cat([rows, X[..., 0:1, :]], dim=-2)


def af_applyT(plan: ContactPlan, m: float, F, Y):
    """A_f(F)^T @ Y -> state space (..., H+1, 9)."""
    yt = Y[..., :-1, :]
    dt = plan.dt[..., None]
    cF_tot = torch.sum(plan.cnt[..., None] * F, dim=-2)
    contrib_t = torch.cat(
        [yt[..., 0:3] + dt * _cross(yt[..., 6:9], cF_tot), yt[..., 3:6], yt[..., 6:9]],
        dim=-1,
    )
    contrib_t1 = torch.cat(
        [-yt[..., 0:3], dt * yt[..., 0:3] - yt[..., 3:6], -yt[..., 6:9]], dim=-1
    )
    zero = torch.zeros_like(Y[..., :1, :])
    return (
        torch.cat([contrib_t, zero], dim=-2)
        + torch.cat([zero, contrib_t1], dim=-2)
        + torch.cat([Y[..., -1:, :], torch.zeros_like(yt)], dim=-2)
    )


def bf_vec(plan: ContactPlan, m: float, F, x_init):
    """b_f(F): force-driven increments + initial state."""
    cF = plan.cnt[..., None] * F
    dt = plan.dt[..., None]
    lin = -dt * torch.sum(cF, dim=-2) / m
    z = torch.zeros_like(plan.dt)
    lin = lin + torch.stack([z, z, _G * plan.dt], dim=-1)
    ang = dt * torch.sum(_cross(cF, plan.r), dim=-2)
    rows = torch.cat([torch.zeros_like(lin), lin, ang], dim=-1)
    return torch.cat([rows, x_init[..., None, :]], dim=-2)


# --- constraint-operator diagonals (Jacobi preconditioners) ---


def af_diag(plan: ContactPlan, F):
    """diag(A_f(F)^T A_f(F)) -> (..., H+1, 9), closed form from the stencil.

    Per knot k and component group:
      com_i: 1_{k<H} (1 + dt_k^2 (|cF_k|^2 - cF_{k,i}^2)) + 1_{k>=1} + 1_{k=0}
      vel_i: 1_{k<H} + 1_{k>=1} (1 + dt_{k-1}^2) + 1_{k=0}
      ang_i: 1_{k<H} + 1_{k>=1} + 1_{k=0}
    (the k=0 extra 1 is the row that pins the whole of X_0)."""
    cF_tot = torch.sum(plan.cnt[..., None] * F, dim=-2)  # (..., H, 3)
    cf2 = torch.sum(cF_tot * cF_tot, dim=-1, keepdim=True)  # (..., H, 1)
    dt2 = (plan.dt * plan.dt)[..., None]  # (..., H, 1)
    one = torch.ones_like(cF_tot)  # (..., H, 3)
    zero = torch.zeros_like(one[..., :1, :])
    k_lt_H = torch.cat([one, zero], dim=-2)
    k_ge_1 = torch.cat([zero, one], dim=-2)
    k_eq_0 = torch.cat([one[..., :1, :], torch.zeros_like(one)], dim=-2)
    cross_sq = torch.cat([dt2 * (cf2 - cF_tot * cF_tot), zero], dim=-2)
    d_com = k_lt_H * (1.0 + cross_sq) + k_ge_1 + k_eq_0
    dt2_prev = torch.cat([zero[..., :1], dt2], dim=-2)
    d_vel = k_lt_H + k_ge_1 * (1.0 + dt2_prev) + k_eq_0
    d_ang = k_lt_H + k_ge_1 + k_eq_0
    return torch.cat([d_com, d_vel, d_ang], dim=-1)


def ax_diag_iso(plan: ContactPlan, m: float, X):
    """Per-contact isotropic diag(A_x(X)^T A_x(X)) -> (..., H, n_eff, 1): the
    exact diagonal cnt dt^2 (1/m^2 + |arm|^2 - arm_i^2) averaged over i, so
    that the metric is a multiple of the identity on each force 3-vector and
    the friction-cone projection stays exact in the scaled space."""
    arm = plan.r - X[..., :-1, None, 0:3]
    arm2 = torch.sum(arm * arm, dim=-1, keepdim=True)
    dt2 = (plan.dt * plan.dt)[..., None, None]
    return plan.cnt[..., None] * dt2 * (1.0 / (m * m) + 2.0 * arm2 / 3.0)


# --- dense materialisation (for golden tests against the numpy/C++ twins) ---


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def ax_dense(plan: ContactPlan, m: float, X):
    """A_x of one problem (no batch axis) as a float64 numpy array in the
    reference's layout (row-major knot blocks of 9, force column
    3 ne t + 3 n + axis); the JAX package's ``ax_dense``. Test-only."""
    import numpy as np

    cnt, r, dt, Xn = (np.asarray(_host(a), np.float64) for a in (plan.cnt, plan.r, plan.dt, X))
    H, ne = cnt.shape[-2], cnt.shape[-1]
    A = np.zeros((9 * (H + 1), 3 * ne * H))
    for t in range(H):
        for n in range(ne):
            c = cnt[t, n]
            col = 3 * ne * t + 3 * n
            for k in range(3):
                A[9 * t + 3 + k, col + k] = c * dt[t] / m
            arm = Xn[t, 0:3] - r[t, n]
            A[9 * t + 6, col + 1] = c * arm[2] * dt[t]
            A[9 * t + 6, col + 2] = -c * arm[1] * dt[t]
            A[9 * t + 7, col + 0] = -c * arm[2] * dt[t]
            A[9 * t + 7, col + 2] = c * arm[0] * dt[t]
            A[9 * t + 8, col + 0] = c * arm[1] * dt[t]
            A[9 * t + 8, col + 1] = -c * arm[0] * dt[t]
    return A


def af_dense(plan: ContactPlan, m: float, F):
    """A_f of one problem as a float64 numpy array in the reference's layout;
    the JAX package's ``af_dense``. Test-only."""
    import numpy as np

    cnt, dt, Fn = (np.asarray(_host(a), np.float64) for a in (plan.cnt, plan.dt, F))
    H = cnt.shape[-2]
    A = np.zeros((9 * (H + 1), 9 * (H + 1)))
    for t in range(H):
        for l in range(9):
            A[9 * t + l, 9 * t + l] = 1.0
            A[9 * t + l, 9 * (t + 1) + l] = -1.0
        for k in range(3):
            A[9 * t + k, 9 * (t + 1) + 3 + k] = dt[t]
        ftot = (cnt[t][:, None] * Fn[t]).sum(0)
        A[9 * t + 6, 9 * t + 1] += -ftot[2] * dt[t]
        A[9 * t + 6, 9 * t + 2] += ftot[1] * dt[t]
        A[9 * t + 7, 9 * t + 0] += ftot[2] * dt[t]
        A[9 * t + 7, 9 * t + 2] += -ftot[0] * dt[t]
        A[9 * t + 8, 9 * t + 0] += -ftot[1] * dt[t]
        A[9 * t + 8, 9 * t + 1] += ftot[0] * dt[t]
    for l in range(9):
        A[9 * H + l, l] = 1.0
    return A
