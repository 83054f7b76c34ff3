"""Batched biconvex ADMM for centroidal dynamics — K1's plain version.

Counterpart of ``bunmpc_tpu/solvers/biconvex.py`` (reference
src/motion_planner/biconvex.cpp:6-151): alternate a force QP (projected
FISTA onto the friction cone, or with ``use_soc=False`` onto the box
``f_bounds``) and a state QP (``x_solver="thomas"``: the exact block-Thomas
solve clipped to the kinematic box; ``"fista"``: projected FISTA onto the
box), update the scaled dual with the over-relaxed dynamics violation, and
escalate rho on stalled problems, until ``||A_f X - b_f|| < exit_tol``.

The FISTA step is a power-iteration estimate (``step_mode="power"``; with
``precondition=True`` in a Jacobi metric, ``centroidal.ax_diag_iso``,
``af_diag``) or the reference's backtracking (``step_mode="linesearch"``,
fista.cpp:6-27), which carries each subproblem's Lipschitz estimate from
one ADMM iteration to the next from ``L0_x``/``L0_f``. ``soc_mode`` and
``momentum`` select the reference's quirks (``solvers/fista.py``), and
``log_statistics`` records the violation of every ADMM iteration in
``BiconvexResult.viol_hist`` (zero after a problem converged).

Masks are per problem: a problem that converges is frozen and its result
depends on nothing but its own data, which is what lets the CUDA kernel
(``solvers/cuda_admm.py``) let each problem leave its loops on its own. The
kernel computes the defaults of ``step_mode``, ``soc_mode``, ``momentum``,
``use_soc`` and ``log_statistics`` only; the other values run here alone.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..mpc import centroidal as cd
from . import block_thomas, fista


@dataclasses.dataclass(frozen=True)
class BiconvexConfig:
    rho: float = 1e5
    max_admm_iters: int = 100
    fista_max_iters: int = 150
    fista_tol: float = 1e-5
    exit_tol: float = 1e-3
    beta: float = 1.5
    L0_x: float = 2.25e6
    L0_f: float = 506.25
    mu: float = 1.0  # friction coefficient (fista.hpp:60)
    use_soc: bool = True
    soc_mode: str = "exact"
    momentum: str = "reference"
    log_statistics: bool = False
    step_mode: str = "power"
    power_iters: int = 8
    power_safety: float = 1.25
    precondition: bool = False
    # outer-loop acceleration: dual over-relaxation + stall-gated geometric
    # rho escalation with dual rescaling and divergence backoff
    dual_relax: float = 1.8
    rho_growth: float = 3.0
    rho_growth_every: int = 10
    rho_max_scale: float = 81.0
    rho_stall_gate: bool = True
    rho_stall_improve: float = 0.0
    rho_backoff_thresh: float = 2.0
    x_solver: str = "thomas"


class CostX(NamedTuple):
    """Diagonal state cost against X_ref (rows 0..H-1 W_X, row H W_X_ter)."""

    W: torch.Tensor  # (..., H+1, 9)
    X_ref: torch.Tensor  # (..., H+1, 9)


class BiconvexResult(NamedTuple):
    X: torch.Tensor  # (..., H+1, 9)
    F: torch.Tensor  # (..., H, n_eff, 3)
    P: torch.Tensor  # (..., H+1, 9) scaled dual
    viol_norm: torch.Tensor  # (...,) final ||A_f X - b_f||
    admm_iters: torch.Tensor  # (...,)
    viol_hist: torch.Tensor | None = None  # (..., max_admm_iters) if log_statistics


_CHOICES = {"x_solver": ("thomas", "fista"), "step_mode": ("power", "linesearch"),
            "soc_mode": ("exact", "reference"), "momentum": ("reference", "textbook")}


def _check_config(cfg: BiconvexConfig):
    for name, allowed in _CHOICES.items():
        if getattr(cfg, name) not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got {getattr(cfg, name)!r}")


def kinematic_box_bounds(plan: cd.ContactPlan, b_lo, b_hi):
    """CoM box around the support polygon (reference
    create_bound_constraints, biconvex.cpp:48-56): active at knots with any
    contact, +-inf otherwise; velocities and momenta are free."""
    any_cnt = torch.sum(plan.cnt, dim=-1) > 0  # (..., H)
    r_max = torch.amax(plan.r, dim=-2)
    r_min = torch.amin(plan.r, dim=-2)
    inf = torch.full_like(r_max, float("inf"))
    lb_com = torch.where(any_cnt[..., None], r_max + b_lo, -inf)
    ub_com = torch.where(any_cnt[..., None], r_min + b_hi, inf)
    H = plan.cnt.shape[-2]
    shape = lb_com.shape[:-2] + (H + 1, 9)
    lb = torch.full(shape, -float("inf"), dtype=plan.r.dtype, device=plan.r.device)
    ub = torch.full(shape, float("inf"), dtype=plan.r.dtype, device=plan.r.device)
    lb[..., :H, 0:3] = lb_com
    ub[..., :H, 0:3] = ub_com
    return lb, ub


def solve(
    plan: cd.ContactPlan,
    m: float,
    x_init,  # (..., 9)
    cost_x: CostX,
    W_F,  # (..., H, n_eff, 3)
    X_wm,  # (..., H+1, 9)
    F_wm,  # (..., H, n_eff, 3)
    P_wm,  # (..., H+1, 9)
    cfg: BiconvexConfig,
    x_bounds=None,  # optional (lb, ub) from kinematic_box_bounds
    f_bounds=None,  # (lb, ub) for the forces when use_soc=False
    F_ref=None,  # optional (..., H, n_eff, 3) force regularization point
) -> BiconvexResult:
    _check_config(cfg)
    batch_shape = x_init.shape[:-1]
    dtype, device = x_init.dtype, x_init.device
    if cfg.use_soc:
        proj_f = fista.soc_projector(cfg.mu, cfg.soc_mode)
    else:
        proj_f = fista.box_projector(*f_bounds)
    proj_x = (lambda z: z) if x_bounds is None else fista.box_projector(*x_bounds)
    fcfg = fista.FistaConfig(max_iters=cfg.fista_max_iters, tol=cfg.fista_tol, beta=cfg.beta,
                             momentum=cfg.momentum)
    linesearch = cfg.step_mode == "linesearch"
    q_x = -2.0 * cost_x.W * cost_x.X_ref

    def solve_f(X, F0, P, rho_k, L0):
        """min F'W_F F + rho ||A_x F - b_x + P||^2 (or F - F_ref); returns the
        solution and the Lipschitz estimate a line search carries."""
        rho = rho_k[..., None, None, None]
        bP = P - cd.bx_vec(plan, X)

        def quad_op(y):
            return 2.0 * (W_F * y + rho * cd.ax_applyT(plan, m, X, cd.ax_apply(plan, m, X, y)))

        def grad(y):
            reg = y if F_ref is None else y - F_ref
            return 2.0 * (
                W_F * reg + rho * cd.ax_applyT(plan, m, X, cd.ax_apply(plan, m, X, y) + bP)
            )

        if linesearch:
            def obj_diff(y1, y0):
                ctr = (y1 + y0) if F_ref is None else (y1 + y0 - 2.0 * F_ref)
                quad = torch.sum(ctr * W_F * (y1 - y0), dim=(-3, -2, -1))
                r1 = cd.ax_apply(plan, m, X, y1) + bP
                r0 = cd.ax_apply(plan, m, X, y0) + bP
                pen = torch.sum(r1 * r1, dim=(-2, -1)) - torch.sum(r0 * r0, dim=(-2, -1))
                return quad + rho_k * pen

            r = fista.solve(F0, grad, obj_diff, proj_f, L0, fcfg, n_var_dims=3)
            return r.x, r.L
        if cfg.precondition:
            # per-contact isotropic diag of 2(W_F + rho A_x^T A_x)
            wf_iso = torch.mean(W_F, dim=-1, keepdim=True)
            d0 = 2.0 * (wf_iso + rho * cd.ax_diag_iso(plan, m, X)) + 1e-12
            return _diag_fista(F0, quad_op, grad, proj_f, d0, 3), L0
        L = fista.power_iteration_L(
            quad_op, F0.shape, F0, 3, cfg.power_iters, cfg.power_safety
        )
        return fista.solve_fixed_step(F0, grad, proj_f, L, fcfg, n_var_dims=3).x, L0

    def solve_x(F, X0, P, rho_k, L0):
        if cfg.x_solver == "thomas":
            X = block_thomas.solve_x_exact(
                plan, m, F, cost_x.W, cost_x.X_ref, P, rho_k, x_init
            )
            return proj_x(X), L0
        # projected FISTA (reference biconvex.cpp:90-96)
        rho = rho_k[..., None, None]
        bP = P - cd.bf_vec(plan, m, F, x_init)

        def quad_op(y):
            return 2.0 * (
                cost_x.W * y + rho * cd.af_applyT(plan, m, F, cd.af_apply(plan, m, F, y))
            )

        def grad(y):
            return 2.0 * (
                cost_x.W * y + rho * cd.af_applyT(plan, m, F, cd.af_apply(plan, m, F, y) + bP)
            ) + q_x

        if linesearch:
            def obj_diff(y1, y0):
                d = y1 - y0
                quad = torch.sum((y1 + y0) * cost_x.W * d, dim=(-2, -1))
                lin = torch.sum(q_x * d, dim=(-2, -1))
                r1 = cd.af_apply(plan, m, F, y1) + bP
                r0 = cd.af_apply(plan, m, F, y0) + bP
                pen = torch.sum(r1 * r1, dim=(-2, -1)) - torch.sum(r0 * r0, dim=(-2, -1))
                return quad + lin + rho_k * pen

            r = fista.solve(X0, grad, obj_diff, proj_x, L0, fcfg, n_var_dims=2)
            return r.x, r.L
        if cfg.precondition:
            d0 = 2.0 * (cost_x.W + rho * cd.af_diag(plan, F)) + 1e-12
            return _diag_fista(X0, quad_op, grad, proj_x, d0, 2), L0
        L = fista.power_iteration_L(
            quad_op, X0.shape, X0, 2, cfg.power_iters, cfg.power_safety
        )
        return fista.solve_fixed_step(X0, grad, proj_x, L, fcfg, n_var_dims=2).x, L0

    def _diag_fista(x0, quad_op, grad, proj, d0, n_var_dims):
        """FISTA in the Jacobi metric D = lam d0, lam the power-iteration
        estimate of the largest eigenvalue of d0^-1/2 H d0^-1/2."""
        sq = torch.sqrt(d0)
        lam = fista.power_iteration_L(
            lambda z: quad_op(z / sq) / sq, x0.shape, x0, n_var_dims, cfg.power_iters,
            cfg.power_safety,
        )
        D = lam.reshape(lam.shape + (1,) * n_var_dims) * d0
        return fista.solve_diag_step(x0, grad, proj, D, fcfg, n_var_dims=n_var_dims).x

    X, F, P = X_wm, F_wm, P_wm
    rho_k = torch.full(batch_shape, cfg.rho, dtype=dtype, device=device)
    L_x = torch.full(batch_shape, cfg.L0_x, dtype=dtype, device=device)
    L_f = torch.full(batch_shape, cfg.L0_f, dtype=dtype, device=device)
    viol_n = torch.full(batch_shape, float("inf"), dtype=dtype, device=device)
    viol_chk = viol_n.clone()
    iters = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    done = torch.zeros(batch_shape, dtype=torch.bool, device=device)
    hist = (torch.zeros(batch_shape + (cfg.max_admm_iters,), dtype=dtype, device=device)
            if cfg.log_statistics else None)
    for it in range(cfg.max_admm_iters):
        if bool(done.all()):
            break
        F_new, L_f_new = solve_f(X, F, P, rho_k, L_f)
        X_new, L_x_new = solve_x(F_new, X, P, rho_k, L_x)
        v = cd.af_apply(plan, m, F_new, X_new) - cd.bf_vec(plan, m, F_new, x_init)
        vn = torch.sqrt(torch.sum(v * v, dim=(-2, -1)))
        P_new = P + cfg.dual_relax * v

        act = ~done
        X = torch.where(act[..., None, None], X_new, X)
        F = torch.where(act[..., None, None, None], F_new, F)
        P = torch.where(act[..., None, None], P_new, P)
        L_x = torch.where(act, L_x_new, L_x)
        L_f = torch.where(act, L_f_new, L_f)
        viol_n = torch.where(act, vn, viol_n)
        iters = torch.where(act, torch.full_like(iters, it + 1), iters)
        if hist is not None:
            hist[..., it] = torch.where(act, vn, torch.zeros_like(vn))
        done = done | (vn < cfg.exit_tol) | torch.isnan(vn)
        if cfg.rho_growth != 1.0:
            at_check = (((it + 1) % cfg.rho_growth_every) == 0) & ~done
            capok = rho_k * cfg.rho_growth <= cfg.rho * cfg.rho_max_scale
            one = torch.ones_like(rho_k)
            if cfg.rho_stall_gate:
                stalled = viol_n > cfg.rho_stall_improve * viol_chk
                diverged = viol_n > cfg.rho_backoff_thresh * viol_chk
                flook = rho_k >= cfg.rho * cfg.rho_growth * 0.999
                grow = at_check & stalled & ~diverged & capok
                back = at_check & diverged & flook
                g = torch.where(grow, cfg.rho_growth * one, one)
                g = torch.where(back, one / cfg.rho_growth, g)
                viol_chk = torch.where(at_check, vn, viol_chk)
            else:
                g = torch.where(at_check & capok, cfg.rho_growth * one, one)
            rho_k = rho_k * g
            P = P / g[..., None, None]
        if it == 0:  # seed the stall checkpoint with the first violation
            viol_chk = vn
    # the loop's P is scaled to the (possibly escalated) final rho; rescale to
    # the base rho a warm-started solve restarts from
    if cfg.rho_growth != 1.0:
        P = P * (rho_k / cfg.rho)[..., None, None]
    return BiconvexResult(X=X, F=F, P=P, viol_norm=viol_n, admm_iters=iters, viol_hist=hist)
