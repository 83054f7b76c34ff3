"""Kinematic-IK cost assembly for the DDP sweep — with ``solvers/ddp.py``,
K2's plain version.

Counterpart of ``bunmpc_tpu/mpc/ik.py`` (reference src/ik/*.cpp, driven from
examples/mpc/abstract_cyclic_gen.py:545-562). The stage cost is one
fixed-shape weighted residual vector per knot:

    r_k = [ ee-position residuals (n_eff*3); CoM tracking (3);
            momentum tracking (6); state regularization (2nv) ]

with the dense per-row weights of ``dense_weights`` — the same input format
the CUDA kernel takes (``solvers/cuda_ddp.solve_ik_batch``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.func import jacfwd, jacrev

from ..kin import algorithms as K
from ..robots.model import RobotModel
from ..solvers import ddp
from ..utils import quat as Q


@dataclasses.dataclass(frozen=True)
class IkTasks:
    """Batched IK task data. Per-problem fields carry a leading batch axis;
    the weights and the regularization state may be shared vectors/scalars
    (cyclic gaits) or per-knot arrays with a leading (H+1,) / (H,) axis."""

    ee_targets: torch.Tensor  # (B, H, n_eff, 3) tracked foot positions
    ee_wts: torch.Tensor  # (B, H, n_eff) per-knot per-foot weights
    com_ref: torch.Tensor  # (B, H+1, 3) from the dynamics solve
    mom_ref: torch.Tensor  # (B, H+1, 6) [lin(3), ang(3)] momentum targets
    com_wt: float
    mom_wt: float
    state_wt: torch.Tensor  # (2nv,) or (H+1, 2nv)
    x_reg: torch.Tensor  # (nq+nv,) or (H+1, nq+nv)
    reg_wt_state: float | torch.Tensor  # scalar or (H+1,)
    reg_wt_ctrl: float | torch.Tensor  # scalar or (H,)
    ctrl_wt: torch.Tensor  # (nv,) or (H, nv)
    dts: torch.Tensor  # (B, H)


def _common(model: RobotModel, eff_frames, x, x_reg):
    nq = model.nq
    com, h_lin, h_ang, ee = K.centroidal_state_and_frames(model, x[..., :nq], x[..., nq:], eff_frames)
    sdiff = ddp._state_diff(model, x_reg, x)
    return com, torch.cat([h_lin, h_ang], dim=-1), ee, sdiff


def stage_residual(model: RobotModel, eff_frames, x, ee_t, com_ref, mom_ref, x_reg):
    """Stage residual (..., 3*n_eff + 9 + 2nv); every argument broadcasts
    over the leading dims."""
    com, h, ee, sdiff = _common(model, eff_frames, x, x_reg)
    r_ee = (ee - ee_t).flatten(-2)
    return torch.cat([r_ee, com - com_ref, h - mom_ref, sdiff], dim=-1)


def term_residual(model: RobotModel, eff_frames, x, com_ref, mom_ref, x_reg):
    """Terminal residual (..., 9 + 2nv)."""
    com, h, _, sdiff = _common(model, eff_frames, x, x_reg)
    return torch.cat([com - com_ref, h - mom_ref, sdiff], dim=-1)


def dense_weights(model: RobotModel, eff_frames, tasks: IkTasks):
    """Dense residual weights in the residual row layout: ``(w_stage (B, H,
    nr), w_term (B, nrt), ctrl_weight (B, H, nv), x_reg (B, H+1, nq+nv))``
    with nr = 3*n_eff + 9 + 2nv and nrt = 9 + 2nv."""
    B, H = tasks.ee_targets.shape[:2]
    nq, nv = model.nq, model.nv
    like = tasks.ee_targets

    def full(a, shape):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device).expand(shape)

    state_wt = full(tasks.state_wt, (B, H + 1, 2 * nv))
    x_reg = full(tasks.x_reg, (B, H + 1, nq + nv))
    reg_wt_state = full(tasks.reg_wt_state, (B, H + 1))
    reg_wt_ctrl = full(tasks.reg_wt_ctrl, (B, H))
    ctrl_wt = full(tasks.ctrl_wt, (B, H, nv))

    w_ee = torch.repeat_interleave(tasks.ee_wts, 3, dim=-1)
    w_com = full(tasks.com_wt, (B, H, 3))
    w_mom = full(tasks.mom_wt, (B, H, 6))
    w_sd = reg_wt_state[..., :H, None] * state_wt[..., :H, :]
    w_stage = torch.cat([w_ee, w_com, w_mom, w_sd], dim=-1)
    w_term = torch.cat(
        [
            full(tasks.com_wt, (B, 3)),
            full(tasks.mom_wt, (B, 6)),
            reg_wt_state[..., H, None] * state_wt[..., H, :],
        ],
        dim=-1,
    )
    return w_stage, w_term, reg_wt_ctrl[..., None] * ctrl_wt, x_reg.contiguous()


def build_residual_fns(model: RobotModel, eff_frames, tasks: IkTasks):
    """``(stage(x, k) -> (r, w), term(x) -> (r, w), ctrl_weight)`` over the
    batch, the counterpart of the JAX package's per-sample closures."""
    w_stage, w_term, ctrl_w, x_reg = dense_weights(model, eff_frames, tasks)
    H = tasks.ee_targets.shape[1]

    def stage(x, k):
        r = stage_residual(
            model, eff_frames, x, tasks.ee_targets[:, k], tasks.com_ref[:, k],
            tasks.mom_ref[:, k], x_reg[:, k],
        )
        return r, w_stage[:, k]

    def term(x):
        r = term_residual(
            model, eff_frames, x, tasks.com_ref[:, H], tasks.mom_ref[:, H], x_reg[:, H]
        )
        return r, w_term

    return stage, term, ctrl_w


def build_jacobian_fns(model: RobotModel, eff_frames):
    """Structured Gauss-Newton Jacobians of the residual stack and the step,
    per (problem, knot) — the counterpart of the JAX package's
    ``build_jacobian_fns``, which ``solve_ik`` uses by default:

    * ee rows: analytic frame Jacobians from one FK pass (zero wrt v);
    * CoM + momentum rows wrt dq: reverse-mode through integrate + FK;
      momentum wrt dv: the centroidal momentum matrix (h is linear in v);
    * state-regularization rows: identity except the 6x6 base block, the
      derivative of the SE(3) difference in a 6-dim chart;
    * step Jacobians Fx/Fu: closed form except the 6x6 base blocks, from an
      18-dim chart of the semi-implicit step.

    Returns ``(stage_jac(x, u, dt, ee_t, com_ref, mom_ref, x_reg) -> (Jr, Fx,
    Fu), term_jac(x, com_ref, mom_ref, x_reg) -> Jt)`` for unbatched inputs."""
    nq, nv = model.nq, model.nv
    ndx, nj = 2 * nv, nv - 6
    eff = tuple(eff_frames)

    def com_mom_jac(q, v):
        def g_of_dq(dq):
            com, h_lin, h_ang = K.centroidal_momentum(model, K.integrate(model, q, dq), v)
            return torch.cat([com, h_lin, h_ang])

        G = jacrev(g_of_dq)(torch.zeros(nv, dtype=q.dtype, device=q.device))

        def h_of_v(v2):
            _, h_lin, h_ang = K.centroidal_momentum(model, q, v2)
            return torch.cat([h_lin, h_ang])

        Ag = jacfwd(h_of_v)(v)
        Gv = torch.cat([torch.zeros(3, nv, dtype=q.dtype, device=q.device), Ag], dim=0)
        return torch.cat([G, Gv], dim=1)

    def sdiff_jac(q, xr):
        def base_diff(d6):
            p2, q2 = Q.se3_integrate(q[0:3], q[3:7], d6[0:3], d6[3:6])
            dv_, dw_ = Q.se3_difference(xr[0:3], xr[3:7], p2, q2)
            return torch.cat([dv_, dw_])

        B6 = jacfwd(base_diff)(torch.zeros(6, dtype=q.dtype, device=q.device))
        eye = torch.eye(nj, dtype=q.dtype, device=q.device)
        top = torch.cat([B6, torch.zeros(6, ndx - 6, dtype=q.dtype, device=q.device)], dim=1)
        mid = torch.cat(
            [torch.zeros(nj, 6, dtype=q.dtype, device=q.device), eye,
             torch.zeros(nj, nv, dtype=q.dtype, device=q.device)], dim=1)
        bot = torch.cat([torch.zeros(nv, nv, dtype=q.dtype, device=q.device),
                         torch.eye(nv, dtype=q.dtype, device=q.device)], dim=1)
        return torch.cat([top, mid, bot], dim=0)

    def ee_jac(q):
        R, p = K.fk(model, q)
        Jq = torch.cat([K.frame_jacobian(model, q, n, R=R, p=p) for n in eff], dim=0)
        return torch.cat([Jq, torch.zeros_like(Jq)], dim=1)

    def dyn_jacs(x, u, dt):
        q, v = x[:nq], x[nq:]
        v_next = v + u * dt
        pb, qb = Q.se3_integrate(q[0:3], q[3:7], v_next[0:3] * dt, v_next[3:6] * dt)

        def base_step_diff(d18):
            dq6, dv6, du6 = d18[0:6], d18[6:12], d18[12:18]
            p1, q1 = Q.se3_integrate(q[0:3], q[3:7], dq6[0:3], dq6[3:6])
            w6 = (v_next[0:6] + dv6 + du6 * dt) * dt
            p2, q2 = Q.se3_integrate(p1, q1, w6[0:3], w6[3:6])
            dv_, dw_ = Q.se3_difference(pb, qb, p2, q2)
            return torch.cat([dv_, dw_])

        M = jacfwd(base_step_diff)(torch.zeros(18, dtype=x.dtype, device=x.device))
        z = lambda r, c: torch.zeros(r, c, dtype=x.dtype, device=x.device)  # noqa: E731
        eye_j = torch.eye(nj, dtype=x.dtype, device=x.device)
        eye_v = torch.eye(nv, dtype=x.dtype, device=x.device)
        dts = dt.reshape(())
        Fx = torch.cat([
            torch.cat([M[:, 0:6], z(6, nj), M[:, 6:12], z(6, nj)], dim=1),
            torch.cat([z(nj, 6), eye_j, z(nj, 6), dts * eye_j], dim=1),
            torch.cat([z(nv, nv), eye_v], dim=1),
        ], dim=0)
        Fu = torch.cat([
            torch.cat([M[:, 12:18], z(6, nj)], dim=1),
            torch.cat([z(nj, 6), dts * dts * eye_j], dim=1),
            dts * eye_v,
        ], dim=0)
        return Fx, Fu

    def stage_jac(x, u, dt, ee_t, com_ref, mom_ref, x_reg):
        q, v = x[:nq], x[nq:]
        Jr = torch.cat([ee_jac(q), com_mom_jac(q, v), sdiff_jac(q, x_reg)], dim=0)
        Fx, Fu = dyn_jacs(x, u, dt)
        return Jr, Fx, Fu

    def term_jac(x, com_ref, mom_ref, x_reg):
        q, v = x[:nq], x[nq:]
        return torch.cat([com_mom_jac(q, v), sdiff_jac(q, x_reg)], dim=0)

    return stage_jac, term_jac


def solve_dense(
    model: RobotModel, eff_frames, x0, ee_targets, com_ref, mom_ref, x_reg,
    w_stage, w_term, ctrl_weight, dts, cfg: ddp.DdpConfig = ddp.DdpConfig(),
) -> ddp.DdpResult:
    """Batched kinematic GN-DDP from the dense task arrays (the signature of
    ``solvers/cuda_ddp.solve_ik_batch``); the controls start at zero."""
    H = dts.shape[-1]
    eff = tuple(eff_frames)

    def stage_fn(x, ee_t, c, mo, xr):
        return stage_residual(model, eff, x, ee_t, c, mo, xr)

    def term_fn(x, c, mo, xr):
        return term_residual(model, eff, x, c, mo, xr)

    stage_jac, term_jac = build_jacobian_fns(model, eff)
    us0 = torch.zeros(dts.shape + (model.nv,), dtype=x0.dtype, device=x0.device)
    return ddp.solve(
        model, x0, us0, dts,
        stage_fn, (ee_targets, com_ref[:, :H], mom_ref[:, :H], x_reg[:, :H]), w_stage,
        ctrl_weight,
        term_fn, (com_ref[:, H], mom_ref[:, H], x_reg[:, H]), w_term,
        stage_jac, term_jac, cfg,
    )


def solve_ik(
    model: RobotModel, eff_frames, x0, tasks: IkTasks, cfg: ddp.DdpConfig = ddp.DdpConfig()
) -> ddp.DdpResult:
    """Batched kinematic DDP solve (reference InverseKinematics::optimize);
    ``x0`` (B, nq+nv)."""
    w_stage, w_term, ctrl_w, x_reg = dense_weights(model, eff_frames, tasks)
    return solve_dense(
        model, eff_frames, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, x_reg,
        w_stage, w_term, ctrl_w, tasks.dts, cfg,
    )
