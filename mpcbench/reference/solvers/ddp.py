"""Batched Gauss-Newton DDP on the free-flyer configuration manifold — with
``mpc/ik.py``, K2's plain version.

Counterpart of ``bunmpc_tpu/solvers/ddp.py`` (crocoddyl's SolverDDP as the
reference IK uses it, src/ik/inverse_kinematics.cpp:54-71). The dynamics is a
double integrator on (q, v) with control u = v-dot, integrated with
semi-implicit Euler:

    v+ = v + u dt ,   q+ = integrate(q, v+ dt)

Costs are weighted-quadratic residuals (Gauss-Newton curvature, running
costs scaled by dt). The residual and dynamics Jacobians in the tangent space
of the manifold come from per-sample functions (``mpc/ik.build_jacobian_fns``)
vmapped over problems and knots. The Riccati sweep is a loop over the
horizon; the line search tries every alpha of a fixed grid and
keeps the best one if it lowers the cost.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.func import vmap

from ..kin import algorithms as K
from ..robots.model import RobotModel


@dataclasses.dataclass(frozen=True)
class DdpConfig:
    n_iters: int = 6
    alphas: tuple = (1.0, 0.7, 0.3, 0.1, 0.03)
    reg: float = 1e-9  # Quu Levenberg regularization (crocoddyl regInit)
    # recompute the Gauss-Newton Jacobians only every k-th iteration
    derivs_every: int = 1


class DdpResult(NamedTuple):
    xs: torch.Tensor  # (..., H+1, nq+nv)
    us: torch.Tensor  # (..., H, nv)
    cost: torch.Tensor  # (...,)


def _step(model: RobotModel, x, u, dt):
    """Semi-implicit Euler on (q, v); x = [q(nq), v(nv)]; dt broadcasts."""
    nq = model.nq
    q, v = x[..., :nq], x[..., nq:]
    v_next = v + u * dt
    q_next = K.integrate(model, q, v_next * dt)
    return torch.cat([q_next, v_next], dim=-1)


def _state_diff(model: RobotModel, x1, x2):
    """Tangent difference x2 (-) x1 (2*nv,)."""
    nq = model.nq
    dq = K.difference(model, x1[..., :nq], x2[..., :nq])
    return torch.cat([dq, x2[..., nq:] - x1[..., nq:]], dim=-1)


def _flat_vmap(fn, n_batch: int):
    """vmap ``fn`` over the first ``n_batch`` leading dims of every argument."""
    def call(*args):
        lead = args[0].shape[:n_batch]
        flat = [a.reshape((-1,) + a.shape[n_batch:]) for a in args]
        out = vmap(fn)(*flat)
        return out.reshape(lead + out.shape[1:])

    return call


def solve(
    model: RobotModel,
    x0,  # (B, nq+nv)
    us0,  # (B, H, nv)
    dts,  # (B, H)
    stage_fn: Callable,  # (x, *stage_args) -> r; broadcasts over leading dims
    stage_args: tuple,  # tensors (B, H, ...) of per-knot task data
    w_stage,  # (B, H, nr)
    ctrl_weight,  # (B, H, nv)
    term_fn: Callable,  # (x, *term_args) -> r
    term_args: tuple,  # tensors (B, ...)
    w_term,  # (B, nrt)
    stage_jac_fn: Callable,  # (x, u, dt, *stage_args) -> (Jr, Fx, Fu), one sample
    term_jac_fn: Callable,  # (x, *term_args) -> Jt, one sample
    cfg: DdpConfig = DdpConfig(),
) -> DdpResult:
    """Minimize sum_k dt_k [0.5 r_k' W_k r_k + 0.5 u' Wu u] + 0.5 r_N' W_N r_N.

    The Jacobian functions (``mpc/ik.build_jacobian_fns``) are vmapped over
    problems and knots."""
    nv = model.nv
    ndx = 2 * nv
    H = us0.shape[-2]
    dtype = x0.dtype

    def total_cost(xs, us):
        """xs (..., H+1, nx), us (..., H, nv) -> (...,)."""
        r = stage_fn(xs[..., :H, :], *stage_args)
        stage = dts * 0.5 * (
            torch.sum(w_stage * r * r, dim=-1) + torch.sum(ctrl_weight * us * us, dim=-1)
        )
        rt = term_fn(xs[..., H, :], *term_args)
        return torch.sum(stage, dim=-1) + 0.5 * torch.sum(w_term * rt * rt, dim=-1)

    def rollout(us):
        xs = [x0]
        for k in range(H):
            xs.append(_step(model, xs[-1], us[..., k, :], dts[..., k, None]))
        return torch.stack(xs, dim=-2)

    def all_jacobians(xs, us):
        flat_stage = _flat_vmap(
            lambda *a: torch.cat([m.reshape(-1) for m in stage_jac_fn(*a)]), 2)
        packed = flat_stage(xs[..., :H, :], us, dts[..., None], *stage_args)
        nr = w_stage.shape[-1]
        sizes = [nr * ndx, ndx * ndx, ndx * nv]
        Jr, Fx, Fu = torch.split(packed, sizes, dim=-1)
        lead = packed.shape[:-1]
        Jr = Jr.reshape(lead + (nr, ndx))
        Fx = Fx.reshape(lead + (ndx, ndx))
        Fu = Fu.reshape(lead + (ndx, nv))
        Jt = _flat_vmap(term_jac_fn, 1)(xs[..., H, :], *term_args)
        return Jr, Fx, Fu, Jt

    def backward(xs, us, jac):
        Jr, Fx_all, Fu_all, Jt = jac
        r_all = stage_fn(xs[..., :H, :], *stage_args)
        rt = term_fn(xs[..., H, :], *term_args)
        JtT = Jt.transpose(-1, -2)
        Vx = (JtT @ (w_term * rt)[..., None])[..., 0]
        Vxx = (JtT * w_term[..., None, :]) @ Jt
        eye_u = torch.eye(nv, dtype=dtype, device=x0.device)
        kffs, Kfbs = [None] * H, [None] * H
        for k in range(H - 1, -1, -1):
            Jk, wk, rk = Jr[..., k, :, :], w_stage[..., k, :], r_all[..., k, :]
            dt = dts[..., k, None]
            JkT = Jk.transpose(-1, -2)
            Lx = dt * (JkT @ (wk * rk)[..., None])[..., 0]
            Lxx = dt[..., None] * ((JkT * wk[..., None, :]) @ Jk)
            wu = ctrl_weight[..., k, :]
            Lu = dt * wu * us[..., k, :]
            Luu = torch.diag_embed(dt * wu)
            Fx, Fu = Fx_all[..., k, :, :], Fu_all[..., k, :, :]
            FxT, FuT = Fx.transpose(-1, -2), Fu.transpose(-1, -2)
            Qx = Lx + (FxT @ Vx[..., None])[..., 0]
            Qu = Lu + (FuT @ Vx[..., None])[..., 0]
            Qxx = Lxx + FxT @ Vxx @ Fx
            Qux = FuT @ Vxx @ Fx
            Quu = Luu + FuT @ Vxx @ Fu + cfg.reg * eye_u
            chol, info = torch.linalg.cholesky_ex(Quu)
            chol = torch.where((info != 0)[..., None, None], float("nan"), chol)
            kff = -torch.cholesky_solve(Qu[..., None], chol)[..., 0]
            Kfb = -torch.cholesky_solve(Qux, chol)
            KfbT = Kfb.transpose(-1, -2)
            Vx = Qx + (KfbT @ Qu[..., None])[..., 0]
            Vxx = Qxx + KfbT @ Qux
            Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
            kffs[k], Kfbs[k] = kff, Kfb
        return torch.stack(kffs, dim=-2), torch.stack(Kfbs, dim=-3)

    def forward(xs, us, kffs, Kfbs, alphas):
        """Rollouts for every alpha at once: leading alpha axis (A, B, ...)."""
        a = alphas.reshape((-1,) + (1,) * (us.ndim - 1))
        x = x0.expand((a.shape[0],) + x0.shape)
        xs_new, us_new = [x], []
        for k in range(H):
            dx = _state_diff(model, xs[..., k, :], x)
            u = us[..., k, :] + a * kffs[..., k, :] + (Kfbs[..., k, :, :] @ dx[..., None])[..., 0]
            x = _step(model, x, u, dts[..., k, None])
            xs_new.append(x)
            us_new.append(u)
        return torch.stack(xs_new, dim=-2), torch.stack(us_new, dim=-2)

    alphas = torch.as_tensor(cfg.alphas, dtype=dtype, device=x0.device)
    us = us0
    xs = rollout(us)
    cost = total_cost(xs, us)
    jac = None
    for i in range(cfg.n_iters):
        if i % max(cfg.derivs_every, 1) == 0:
            jac = all_jacobians(xs, us)
        kffs, Kfbs = backward(xs, us, jac)
        xs_c, us_c = forward(xs, us, kffs, Kfbs, alphas)
        cost_c = total_cost(xs_c, us_c)  # (A, B)
        best = torch.argmin(cost_c, dim=0)  # first minimum wins a tie
        pick = best[None, ..., None, None].expand((1,) + xs_c.shape[1:])
        xs_b = torch.gather(xs_c, 0, pick)[0]
        pick_u = best[None, ..., None, None].expand((1,) + us_c.shape[1:])
        us_b = torch.gather(us_c, 0, pick_u)[0]
        cost_b = torch.gather(cost_c, 0, best[None])[0]
        improved = cost_b < cost
        xs = torch.where(improved[..., None, None], xs_b, xs)
        us = torch.where(improved[..., None, None], us_b, us)
        cost = torch.minimum(cost, cost_b)
    return DdpResult(xs=xs, us=us, cost=cost)
