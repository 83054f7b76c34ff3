"""Batched projected FISTA (PyTorch).

Counterpart of ``bunmpc_tpu/solvers/fista.py`` (reference
src/solvers/fista.cpp:6-70): a fixed step (``solve_fixed_step``, from a
power-iteration Lipschitz estimate), a diagonal metric (``solve_diag_step``)
or the reference's backtracking line search with monotone Lipschitz growth
``L <- beta L`` (``solve``). Every per-problem scalar (step, momentum,
convergence flag) is a tensor over the leading batch dimensions; the loop
runs until every problem has converged or the cap is hit, and a converged
problem is frozen by its mask, so a problem's result depends on nothing but
its own data.

The momentum defaults to the reference variant ``t+ = 1 + sqrt(1 + 4 t^2) / 2``
(fista.cpp:34), kept for trajectory parity; ``momentum="textbook"`` is
Nesterov's ``(1 + sqrt(1 + 4 t^2)) / 2``. The cone projection defaults to the
exact Euclidean one; ``soc_mode="reference"`` reproduces the reference's
squared-norm projection (fista.cpp:59-62).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class FistaConfig:
    max_iters: int = 150
    tol: float = 1e-5
    beta: float = 1.5
    max_linesearch: int = 30
    momentum: str = "reference"  # or "textbook"


class FistaResult(NamedTuple):
    x: torch.Tensor  # solution, batch_shape + var_shape
    L: torch.Tensor  # final per-problem Lipschitz estimates (batch_shape)
    iters: torch.Tensor  # per-problem iterations taken while not converged (int32)
    g_norm: torch.Tensor  # per-problem norm of the last live step


def _vdot(a, b, n_var_dims):
    return torch.sum(a * b, dim=tuple(range(-n_var_dims, 0)))


def _expand(s, n_var_dims):
    return s.reshape(s.shape + (1,) * n_var_dims)


def _momentum(t_k, momentum: str):
    if momentum == "reference":
        return 1.0 + torch.sqrt(1.0 + 4.0 * t_k * t_k) / 2.0
    return (1.0 + torch.sqrt(1.0 + 4.0 * t_k * t_k)) / 2.0


def box_projector(lb, ub):
    """Projection onto [lb, ub]."""

    def proj(z):
        return torch.minimum(torch.maximum(z, lb), ub)

    return proj


def soc_projector(mu: float, mode: str = "exact"):
    """Per-3-vector projection onto the friction cone ||f_xy|| <= mu f_z
    (trailing axis of a (..., 3) force layout). ``mode="reference"`` uses the
    squared tangential norm and zeroes any point with f_z < 0, as the
    reference does."""

    def proj(z):
        fxy = z[..., 0:2]
        fz = z[..., 2]
        sq = torch.sum(fxy * fxy, dim=-1)
        s = sq if mode == "reference" else torch.sqrt(sq)
        inside = s <= mu * fz
        polar = mu * s <= -fz
        if mode == "reference":
            polar = polar | (fz < 0)
        s_safe = torch.where(s > 0, s, torch.ones_like(s))
        coef = ((mu * mu) * s + mu * fz) / (((mu * mu) + 1.0) * s_safe)
        fz_proj = (mu * s + fz) / (mu * mu + 1.0)
        surface = torch.cat([fxy * coef[..., None], fz_proj[..., None]], dim=-1)
        out = torch.where(inside[..., None], z, surface)
        return torch.where((polar & ~inside)[..., None], torch.zeros_like(z), out)

    return proj


def power_iteration_L(
    matvec: Callable, shape, like, n_var_dims: int, iters: int = 8, safety: float = 1.25
):
    """Largest-eigenvalue estimate of a PSD operator (per problem), times
    ``safety``: ``iters`` normalized applications from a vector of ones."""
    z = torch.ones(shape, dtype=like.dtype, device=like.device)
    for _ in range(iters):
        w = matvec(z)
        nrm = torch.sqrt(_vdot(w, w, n_var_dims))
        z = w / (_expand(nrm, n_var_dims) + 1e-30)
    w = matvec(z)
    lam = _vdot(z, w, n_var_dims) / (_vdot(z, z, n_var_dims) + 1e-30)
    return safety * lam


def solve_fixed_step(
    x0, grad_fn: Callable, proj_fn: Callable, L, cfg: FistaConfig, n_var_dims: int = 1
):
    """Projected FISTA with the fixed step 1/L; returns a ``FistaResult``
    whose ``L`` is the step's (broadcast over the batch)."""
    batch_shape = x0.shape[: x0.ndim - n_var_dims]
    L = torch.broadcast_to(torch.as_tensor(L, dtype=x0.dtype, device=x0.device), batch_shape)
    res = solve_diag_step(x0, grad_fn, proj_fn, _expand(L, n_var_dims), cfg, n_var_dims)
    return res._replace(L=L)


def solve_diag_step(
    x0, grad_fn: Callable, proj_fn: Callable, D, cfg: FistaConfig, n_var_dims: int = 1
):
    """Projected FISTA in a diagonal metric, ``y <- proj(y - grad / D)`` with
    ``D`` broadcastable to ``x0`` (counterpart of ``fista.solve_diag_step``).
    With D = lam_max(D0^-1/2 H D0^-1/2) * safety * D0 for a Jacobi estimate D0
    of diag(H) this is plain FISTA on z = D^1/2 x: exact for a box, and for
    the friction cone when D is isotropic on each 3-vector. Returns a
    ``FistaResult`` whose ``L`` is the largest entry of D per problem."""
    batch_shape = x0.shape[: x0.ndim - n_var_dims]
    x_k, y_k = x0, x0
    t_k = torch.ones(batch_shape, dtype=x0.dtype, device=x0.device)
    g_norm = torch.full(batch_shape, float("inf"), dtype=x0.dtype, device=x0.device)
    iters = torch.zeros(batch_shape, dtype=torch.int32, device=x0.device)
    done = torch.zeros(batch_shape, dtype=torch.bool, device=x0.device)
    for it in range(cfg.max_iters):
        if bool(done.all()):
            break
        y_next = proj_fn(y_k - grad_fn(y_k) / D)
        d = y_next - y_k
        g = torch.sqrt(_vdot(d, d, n_var_dims))
        t_next = _momentum(t_k, cfg.momentum)
        y_mom = y_next + _expand((t_k - 1.0) / t_next, n_var_dims) * (y_next - x_k)
        upd = _expand(~done, n_var_dims)
        x_k = torch.where(upd, y_next, x_k)
        y_k = torch.where(upd, y_mom, y_k)
        t_k = torch.where(~done, t_next, t_k)
        g_norm = torch.where(~done, g, g_norm)
        iters = torch.where(~done, torch.full_like(iters, it + 1), iters)
        done = done | (g < cfg.tol)
    L = torch.broadcast_to(torch.as_tensor(D, dtype=x0.dtype, device=x0.device), x0.shape)
    return FistaResult(x=x_k, L=torch.amax(L, dim=tuple(range(-n_var_dims, 0))), iters=iters,
                       g_norm=g_norm)


def solve(
    x0, grad_fn: Callable, obj_diff_fn: Callable, proj_fn: Callable, L0, cfg: FistaConfig,
    n_var_dims: int = 1,
):
    """Projected FISTA with the reference's per-problem backtracking
    (``compute_step_length``, fista.cpp:6-27): from the carried ``L``, grow
    ``L <- beta L`` until ``f(y+) - f(y) <= <grad, d> + L/2 |d|^2`` or
    ``max_linesearch`` trials. ``obj_diff_fn(y1, y0)`` is f(y1) - f(y0) per
    problem (the reference's objective-difference trick, problem.cpp:46-51).
    Returns a ``FistaResult``: the solution, the final Lipschitz estimates,
    the iterations and the last step norm per problem."""
    batch_shape = x0.shape[: x0.ndim - n_var_dims]
    L = torch.broadcast_to(torch.as_tensor(L0, dtype=x0.dtype, device=x0.device),
                           batch_shape).clone()

    def line_search(y_k, L, skip):
        grad = grad_fn(y_k)

        def trial(L):
            y_try = proj_fn(y_k - grad / _expand(L, n_var_dims))
            d = y_try - y_k
            rhs = _vdot(grad, d, n_var_dims) + 0.5 * L * _vdot(d, d, n_var_dims)
            return y_try, obj_diff_fn(y_try, y_k) <= rhs

        y_best, accepted = trial(L)
        accepted = accepted | skip
        for _ in range(cfg.max_linesearch):
            if bool(accepted.all()):
                break
            L = torch.where(accepted, L, L * cfg.beta)
            y_try, ok = trial(L)
            y_best = torch.where(_expand(accepted, n_var_dims), y_best, y_try)
            accepted = accepted | ok
        return y_best, L

    x_k, y_k = x0, x0
    t_k = torch.ones(batch_shape, dtype=x0.dtype, device=x0.device)
    g_norm = torch.full(batch_shape, float("inf"), dtype=x0.dtype, device=x0.device)
    iters = torch.zeros(batch_shape, dtype=torch.int32, device=x0.device)
    done = torch.zeros(batch_shape, dtype=torch.bool, device=x0.device)
    for it in range(cfg.max_iters):
        if bool(done.all()):
            break
        y_next, L_new = line_search(y_k, L, done)
        d = y_next - y_k
        g = torch.sqrt(_vdot(d, d, n_var_dims))
        t_next = _momentum(t_k, cfg.momentum)
        y_mom = y_next + _expand((t_k - 1.0) / t_next, n_var_dims) * (y_next - x_k)
        upd = _expand(~done, n_var_dims)
        x_k = torch.where(upd, y_next, x_k)
        y_k = torch.where(upd, y_mom, y_k)
        L = torch.where(~done, L_new, L)
        t_k = torch.where(~done, t_next, t_k)
        g_norm = torch.where(~done, g, g_norm)
        iters = torch.where(~done, torch.full_like(iters, it + 1), iters)
        done = done | (g < cfg.tol)
    return FistaResult(x=x_k, L=L, iters=iters, g_norm=g_norm)
