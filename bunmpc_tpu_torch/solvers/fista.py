"""Batched projected FISTA with a fixed power-iteration step (PyTorch).

Counterpart of the ``step_mode="power"`` path of ``bunmpc_tpu/solvers/fista.py``
(reference src/solvers/fista.cpp:6-70). Every per-problem scalar (step,
momentum, convergence flag) is a tensor over the leading batch dimensions;
the loop runs until every problem has converged or the cap is hit, and a
converged problem is frozen by its mask, so a problem's result depends on
nothing but its own data.

The momentum is the reference variant ``t+ = 1 + sqrt(1 + 4 t^2) / 2``
(fista.cpp:34), kept for trajectory parity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class FistaConfig:
    max_iters: int = 150
    tol: float = 1e-5


def _vdot(a, b, n_var_dims):
    return torch.sum(a * b, dim=tuple(range(-n_var_dims, 0)))


def _expand(s, n_var_dims):
    return s.reshape(s.shape + (1,) * n_var_dims)


def box_projector(lb, ub):
    """Projection onto [lb, ub]."""

    def proj(z):
        return torch.minimum(torch.maximum(z, lb), ub)

    return proj


def soc_projector(mu: float):
    """Exact per-3-vector projection onto the friction cone ||f_xy|| <= mu f_z
    (trailing axis of a (..., 3) force layout)."""

    def proj(z):
        fxy = z[..., 0:2]
        fz = z[..., 2]
        s = torch.sqrt(torch.sum(fxy * fxy, dim=-1))
        inside = s <= mu * fz
        polar = mu * s <= -fz
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
    """Projected FISTA with the fixed step 1/L; returns the solution."""
    batch_shape = x0.shape[: x0.ndim - n_var_dims]
    return solve_diag_step(
        x0, grad_fn, proj_fn, _expand(torch.broadcast_to(L, batch_shape), n_var_dims), cfg,
        n_var_dims,
    )


def solve_diag_step(
    x0, grad_fn: Callable, proj_fn: Callable, D, cfg: FistaConfig, n_var_dims: int = 1
):
    """Projected FISTA in a diagonal metric, ``y <- proj(y - grad / D)`` with
    ``D`` broadcastable to ``x0`` (counterpart of ``fista.solve_diag_step``).
    With D = lam_max(D0^-1/2 H D0^-1/2) * safety * D0 for a Jacobi estimate D0
    of diag(H) this is plain FISTA on z = D^1/2 x: exact for a box, and for
    the friction cone when D is isotropic on each 3-vector."""
    batch_shape = x0.shape[: x0.ndim - n_var_dims]
    x_k, y_k = x0, x0
    t_k = torch.ones(batch_shape, dtype=x0.dtype, device=x0.device)
    done = torch.zeros(batch_shape, dtype=torch.bool, device=x0.device)
    for _ in range(cfg.max_iters):
        if bool(done.all()):
            break
        y_next = proj_fn(y_k - grad_fn(y_k) / D)
        d = y_next - y_k
        g = torch.sqrt(_vdot(d, d, n_var_dims))
        t_next = 1.0 + torch.sqrt(1.0 + 4.0 * t_k * t_k) / 2.0
        y_mom = y_next + _expand((t_k - 1.0) / t_next, n_var_dims) * (y_next - x_k)
        upd = _expand(~done, n_var_dims)
        x_k = torch.where(upd, y_next, x_k)
        y_k = torch.where(upd, y_mom, y_k)
        t_k = torch.where(~done, t_next, t_k)
        done = done | (g < cfg.tol)
    return x_k
