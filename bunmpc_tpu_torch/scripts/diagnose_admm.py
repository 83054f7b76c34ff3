"""ADMM/FISTA convergence diagnostics on the trot QPs.

Counterpart of ``scripts/diagnose_admm.py``: the outer-iteration
distribution, the dyn-violation decay curve and the FISTA iteration counts
of the F and X subproblems at the converged iterate, the numbers that say
whether the ADMM's time goes to outer iterations, to inner FISTA iterations
(conditioning) or to the power-iteration step sizing.

    python -m bunmpc_tpu_torch.scripts.diagnose_admm [batch=16]

It diagnoses the plain solver (``solvers/biconvex.solve`` with
``log_statistics=True``, ``precondition`` False then True), as the JAX
script does: on the card that solver runs in float32 on CUDA tensors and
launches no kernel; ``device=cpu`` runs it on the CPU.
"""

import sys

import numpy as np


def draws(B: int, dtype, device):
    """The JAX script's seeded problems (rng = default_rng(0)): q0 with
    joint noise, random velocities, clocks in [0, 0.5) and commands."""
    import torch

    from ..robots.solo12 import Solo12Config

    def t_(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rng = np.random.default_rng(0)
    q = t_(np.tile(Solo12Config.q0(), (B, 1)))
    q[:, 7:] += t_(rng.normal(size=(B, 12)) * 0.05)  # added in ``dtype``, as the JAX script
    v = t_(rng.normal(size=(B, 18)) * 0.05)
    t = t_(rng.uniform(0, 0.5, size=B))
    v_des = t_(np.stack([rng.uniform(-0.3, 0.5, B), rng.uniform(-0.2, 0.2, B), np.zeros(B)], -1))
    w_des = t_(rng.uniform(-0.3, 0.3, size=B))
    return q, v, t, v_des, w_des


def diagnose(B: int, dtype, device) -> dict:
    """Every number of the report, as numpy arrays: per ``precondition``
    the ADMM iterations, final violations and violation history; the F and
    X subproblems' FISTA iterations and Lipschitz estimates at the
    preconditioned solve's iterate (from cold starts), and the X cost's
    diagonal."""
    import torch

    from ..mpc import centroidal as cd
    from ..mpc import kino_dyn as KD
    from ..mpc.motions.solo12_cyclic import trot
    from ..robots.solo12 import Solo12Config
    from ..solvers import biconvex, fista

    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0(), device=device)
    prob = KD._prepare_problem(spec, *draws(B, dtype, device))
    m = spec.model.total_mass
    plan = prob["plan"]
    cost_x = biconvex.CostX(W=prob["W"], X_ref=prob["X_ref"])
    out = {}
    for precond in (False, True):
        cfg = biconvex.BiconvexConfig(rho=spec.params.rho, log_statistics=True,
                                      precondition=precond)
        res = biconvex.solve(plan, m, prob["x_init"], cost_x, prob["W_F"], prob["X_wm"],
                             prob["F_wm"], torch.zeros_like(prob["X_wm"]), cfg,
                             x_bounds=prob["x_bounds"])
        tag = f"precondition={precond}"
        out[tag] = {"admm_iters": res.admm_iters.cpu().numpy(),
                    "viol_norm": res.viol_norm.cpu().numpy(),
                    "viol_hist": res.viol_hist.cpu().numpy(),
                    "max_admm_iters": cfg.max_admm_iters}

    # FISTA iteration counts at the converged iterate: the two subproblems
    # re-run from cold starts with fresh Lipschitz estimates (the worst case)
    cfg = biconvex.BiconvexConfig(rho=spec.params.rho, precondition=False)
    fcfg = fista.FistaConfig(max_iters=cfg.fista_max_iters, tol=cfg.fista_tol, beta=cfg.beta,
                             momentum=cfg.momentum)
    rho = cfg.rho
    X, F, P = res.X, res.F, res.P

    b = cd.bx_vec(plan, X)
    bP = P - b

    def f_quad(y):
        return 2.0 * (prob["W_F"] * y + rho * cd.ax_applyT(plan, m, X, cd.ax_apply(plan, m, X, y)))

    def f_grad(y):
        return 2.0 * (prob["W_F"] * y
                      + rho * cd.ax_applyT(plan, m, X, cd.ax_apply(plan, m, X, y) + bP))

    Lf = fista.power_iteration_L(f_quad, F.shape, F, 3, cfg.power_iters)
    rf = fista.solve_fixed_step(torch.zeros_like(F), f_grad, fista.soc_projector(cfg.mu,
                                cfg.soc_mode), Lf, fcfg, n_var_dims=3)

    bx = P - cd.bf_vec(plan, m, F, prob["x_init"])
    q_x = -2.0 * cost_x.W * cost_x.X_ref

    def x_quad(y):
        return 2.0 * (cost_x.W * y + rho * cd.af_applyT(plan, m, F, cd.af_apply(plan, m, F, y)))

    def x_grad(y):
        return 2.0 * (cost_x.W * y
                      + rho * cd.af_applyT(plan, m, F, cd.af_apply(plan, m, F, y) + bx)) + q_x

    Lx = fista.power_iteration_L(x_quad, X.shape, X, 2, cfg.power_iters)
    rx = fista.solve_fixed_step(torch.zeros_like(X), x_grad,
                                fista.box_projector(*prob["x_bounds"]), Lx, fcfg, n_var_dims=2)
    out["f_sub"] = {"iters": rf.iters.cpu().numpy(), "L": Lf.cpu().numpy()}
    out["x_sub"] = {"iters": rx.iters.cpu().numpy(), "L": Lx.cpu().numpy()}
    out["fista_max_iters"] = cfg.fista_max_iters
    out["W_x"] = cost_x.W.cpu().numpy()
    return out


SHOW = [0, 1, 2, 4, 8, 16, 32, 64, 99]


def report(d: dict, B: int) -> list:
    """The JAX script's printed report, line by line."""
    lines = []
    for precond in (False, True):
        r = d[f"precondition={precond}"]
        iters, hist, viol = r["admm_iters"], r["viol_hist"], r["viol_norm"]
        lines.append(
            f"[precondition={precond}] B={B} outer iters: mean={iters.mean():.1f} "
            f"median={np.median(iters):.0f} max={iters.max()} (cap {r['max_admm_iters']}); "
            f"final viol mean={viol.mean():.2e} max={viol.max():.2e}")
        med = np.nanmedian(np.where(hist > 0, hist, np.nan), axis=0)
        lines.append("  median dyn violation by outer iter:")
        for i in SHOW:
            if i < len(med) and np.isfinite(med[i]):
                lines.append(f"    iter {i:3d}: {med[i]:.4e}")
    cap = d["fista_max_iters"]
    for tag, name in (("f_sub", "F"), ("x_sub", "X")):
        s = d[tag]
        lines.append(f"{name}-subproblem (cold x0): FISTA iters mean={np.mean(s['iters']):.1f} "
                     f"max={np.max(s['iters'])} (cap {cap}); L mean={np.mean(s['L']):.3e}")
    Wd = d["W_x"]
    lines.append(f"X diag cost W: min={Wd.min():.1e} max={Wd.max():.1e}")
    return lines


def main(argv=None) -> int:
    import warnings

    import torch

    from ..utils.runtime import setup_torch

    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else list(argv)))
    device = setup_torch(args.get("device"))
    B = int(args.get("batch", 16))
    with warnings.catch_warnings():  # nanmedian over iterations no problem reached
        warnings.simplefilter("ignore", RuntimeWarning)
        lines = report(diagnose(B, torch.float32, device), B)
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
