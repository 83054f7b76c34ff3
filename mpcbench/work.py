"""The work of the two solver kernels, counted from the problem's shapes
(frozen copies of the counts ``chip_smoke.py`` uses), and the peaks they are
held to.

K1 (``csrc/admm.cu``, the centroidal ADMM) does data-dependent work: its
operations follow the ADMM iterations each problem reports in its plan and
the F-step FISTA iterations it runs. K2 (``csrc/ddp.cu``, the GN-DDP) does
fixed work set by its shapes and ``DdpConfig``. Bytes count each input read
once and each output written once, in float32.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 bandwidth
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def admm_ops(admm_iters: float, fista_iters: float, H: int, power_iters: int = 8) -> float:
    """K1's float32 operations for ``admm_iters`` ADMM iterations and
    ``fista_iters`` F-step FISTA iterations in all (summed over problems),
    counted from csrc/admm_core.cuh per problem: per ADMM iteration
    (power_iters+1) applications of the F operator (~260 ops per knot) with
    a norm, one Thomas sweep (~3,400 ops per knot: the 9x9 Cholesky on the
    lower triangle ~500, the 9x10 block solve ~1,800, the Schur update of the
    next block's lower triangle and right-hand side ~1,100) and the dual
    update (~150 ops per knot); per FISTA iteration one operator
    application, the step, the cone projection and the momentum update (~400
    ops per knot)."""
    f_op = 260.0 * H
    per_admm = (power_iters + 1) * (f_op + 36.0 * H) + 3400.0 * (H + 1) + 150.0 * (H + 1)
    per_fista = f_op + 140.0 * H
    return float(admm_iters) * per_admm + float(fista_iters) * per_fista


def admm_bytes(n_problems: int, H: int) -> float:
    """K1's bytes: it reads cnt, r, dt, x_init, W, ql, W_F, qF, lb, ub, X_wm,
    F_wm (and the dual P_wm where one is carried, not counted here) and
    writes X, F, viol, iters."""
    nX, nF = (H + 1) * 9, H * 12
    return 4.0 * n_problems * (H * 4 + nF + H + 9 + 5 * nX + 3 * nF + nX + nF + 2)


def ddp_ops(n_problems: int, H: int, n_iters: int = 6, n_alphas: int = 5, nj: int = 12) -> float:
    """K2's arithmetic (fixed work, no data dependence), counted from
    csrc/ddp.cu per problem and iteration, at 12 joints (nb 13 bodies, nv
    18, ndx 36): per knot of the backward sweep the kinematics (~3.5k ops),
    the 36-direction tangent pass (~60k), the Gauss-Newton products (~27k)
    and the block-structured Riccati step (~100k); per knot of each alpha's
    rollout ~7k ops. At another joint count each term scales with what it
    loops over."""
    nb, nv = nj + 1, nj + 6
    ndx = 2 * nv
    kin, tan, gn = 3.5e3 * nb / 13, 60e3 * (ndx / 36) * (nb / 13), 27e3 * (ndx / 36) ** 2
    ric = 100e3 * (nv / 18) * (ndx / 36) ** 2
    knot = 7e3 * (nv * ndx) / (18 * 36)
    backward = (H + 1) * (kin + tan + gn) + H * ric
    rollouts = n_alphas * H * knot
    first = H * knot
    return n_problems * (first + n_iters * (backward + rollouts))


def ddp_bytes(n_problems: int, H: int, nj: int = 12) -> float:
    """K2's bytes: each input read once (x0, the feet targets, the CoM and
    momentum references, the reference states, the stage and terminal
    weights, the control weights, the knot durations) and each output
    written once (xs, us, cost)."""
    nv = nj + 6
    nx, ndx = nv + nj + 7, 2 * nv
    nr, nrt = 12 + 9 + ndx, 9 + ndx
    return 4.0 * n_problems * (nx + H * 12 + (H + 1) * (3 + 6 + nx) + H * nr + nrt + H * nv
                               + H + (H + 1) * nx + H * nv + 1)


def bound_s(n_bytes: float, n_ops: float):
    """The least time the card could take: ``(seconds, "operations" or
    "bytes")``, whichever bound is larger."""
    t_ops = n_ops / F32_FLOPS
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline_pct(n_bytes: float, n_ops: float, seconds: float) -> float:
    """The share of the roofline, in percent, of work that took ``seconds``."""
    return 100.0 * bound_s(n_bytes, n_ops)[0] / seconds
