"""Exact block-tridiagonal solve of the ADMM X-subproblem (PyTorch).

Counterpart of ``bunmpc_tpu/solvers/block_thomas.py``. The X-subproblem

    min_X  (X-X_ref)' W (X-X_ref) + rho ||A_f(F) X - (b_f - P)||^2

has the block-tridiagonal normal matrix  M = 2 W + 2 rho A_f' A_f  (9x9
blocks in the knot index): A_f is block bidiagonal plus one row pinning X_0.
One block-Thomas sweep (H+1 block Cholesky factorizations and a
back-substitution) solves it exactly.

    row-block t (t<H):  D_t = [[I,0,0],[0,I,0],[G_t,0,I]]   at column t
                        E_t = [[-I, dt_t I, 0],[0,-I,0],[0,0,-I]] at column t+1
    M_k = 2 W_k + 2 rho ( 1_{k<H} D_k'D_k + 1_{k>0} E_{k-1}'E_{k-1} + 1_{k=0} I )
    U_k = 2 rho D_k'E_k          (coupling k -> k+1)
"""

from __future__ import annotations

import torch

from ..mpc import centroidal as cd


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], z, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], z], -1),
        ],
        -2,
    )


def _b9(rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def x_normal_blocks(plan: cd.ContactPlan, F, W, rho):
    """Blocks ``(M (..., H+1, 9, 9), U (..., H, 9, 9))`` of the X normal
    system; ``rho`` is per problem (...,) or a scalar."""
    cnt, dt = plan.cnt, plan.dt
    cF = torch.sum(cnt[..., None] * F, dim=-2)  # (..., H, 3)
    G = dt[..., None, None] * _skew(cF)
    I3 = torch.eye(3, dtype=F.dtype, device=F.device).expand(G.shape)
    Z3 = torch.zeros_like(G)
    GtG = G.transpose(-1, -2) @ G
    Gt = G.transpose(-1, -2)
    dtI = dt[..., None, None] * I3
    DtD = _b9([[I3 + GtG, Z3, Gt], [Z3, I3, Z3], [G, Z3, I3]])
    EtE = _b9(
        [[I3, -dtI, Z3], [-dtI, (1.0 + (dt * dt)[..., None, None]) * I3, Z3], [Z3, Z3, I3]]
    )
    DtE = _b9([[-I3, dtI, -Gt], [Z3, -I3, Z3], [Z3, Z3, -I3]])

    rho_b = torch.as_tensor(rho, dtype=F.dtype, device=F.device)[..., None, None, None]
    zpad = torch.zeros_like(DtD[..., :1, :, :])
    eye9 = torch.eye(9, dtype=F.dtype, device=F.device)
    pin = torch.cat([eye9.expand(zpad.shape), torch.zeros_like(DtD)], dim=-3)
    AtA = torch.cat([DtD, zpad], dim=-3) + torch.cat([zpad, EtE], dim=-3) + pin
    M = 2.0 * (W[..., None] * eye9) + 2.0 * rho_b * AtA
    U = 2.0 * rho_b * DtE
    return M, U


def _cho_solve(L, b):
    return torch.cholesky_solve(b, L)


def solve_block_tridiag(M, U, rhs):
    """Solve the SPD block-tridiagonal system diag(M) + off-diag(U, U')
    against ``rhs``: M (..., K, n, n), U (..., K-1, n, n), rhs (..., K, n)."""
    K = M.shape[-3]
    chols, ds = [], []
    C = M[..., 0, :, :]
    y = rhs[..., 0, :]
    for k in range(K):
        if k > 0:
            Uk = U[..., k - 1, :, :]
            CiU = _cho_solve(chols[-1], Uk)
            C = M[..., k, :, :] - Uk.transpose(-1, -2) @ CiU
            y = rhs[..., k, :] - (Uk.transpose(-1, -2) @ ds[-1][..., None])[..., 0]
        L = torch.linalg.cholesky_ex(C)[0]
        chols.append(L)
        ds.append(_cho_solve(L, y[..., None])[..., 0])
    xs = [ds[K - 1]]
    for k in range(K - 2, -1, -1):
        Ux = (U[..., k, :, :] @ xs[0][..., None])
        xs.insert(0, ds[k] - _cho_solve(chols[k], Ux)[..., 0])
    return torch.stack(xs, dim=-2)


def solve_x_exact(plan: cd.ContactPlan, m, F, W, X_ref, P, rho, x_init):
    """Exact minimizer of the (unbounded) X-subproblem (..., H+1, 9)."""
    M, U = x_normal_blocks(plan, F, W, rho)
    b = cd.bf_vec(plan, m, F, x_init)
    rho_b = torch.as_tensor(rho, dtype=F.dtype, device=F.device)[..., None, None]
    rhs = 2.0 * W * X_ref + 2.0 * rho_b * cd.af_applyT(plan, m, F, b - P)
    return solve_block_tridiag(M, U, rhs)
