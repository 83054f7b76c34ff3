"""The plain ADMM's options off the kernels' path (``solvers/biconvex.py``,
``solvers/fista.py``) against the JAX package's ``biconvex.solve`` and
``fista.solve`` in f64: the reference's backtracking (``step_mode=
"linesearch"``, with the X-step by block Thomas and by FISTA), the
squared-norm cone (``soc_mode="reference"``), Nesterov's momentum
(``momentum="textbook"``), box-bounded forces (``use_soc=False`` with
``f_bounds``, loose and binding) and the violation history
(``log_statistics``).

The problems are the Solo12 trot's on 8 of ``workload.trot_states``' draws,
assembled by the port's ``kino_dyn._prepare_problem`` in f64 (the same
numpy arrays go to both packages). Gates: X, F and P atol 1e-7 with equal
iteration counts (tests/test_torch_admm.py's f64 gate), ``viol_hist`` atol
1e-7, and ``viol_hist`` None where the option is off, as in JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.mpc import centroidal as jcd
from bunmpc_tpu.solvers import biconvex as jbc
from bunmpc_tpu.solvers import fista as jfista
from bunmpc_tpu_torch import workload
from bunmpc_tpu_torch.mpc import centroidal as tcd
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu_torch.robots.solo12 import Solo12Config
from bunmpc_tpu_torch.solvers import biconvex as tbc
from bunmpc_tpu_torch.solvers import fista as tfista

N = 8
# the cut that keeps the line search's JAX compile and the CPU runs short:
# 30 ADMM iterations (the trot converges in ~25 with the defaults)
BASE = dict(rho=trot.rho, max_admm_iters=30, fista_max_iters=40)


@pytest.fixture(scope="module")
def problem():
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0(), device="cpu")
    args = [torch.as_tensor(a, dtype=torch.float64) for a in workload.trot_states(N, seed=3)]
    pr = KD._prepare_problem(spec, *args)
    out = {k: pr[k].numpy() for k in ("x_init", "W", "X_ref", "W_F", "X_wm", "F_wm")}
    out.update(cnt=pr["plan"].cnt.numpy(), r=pr["plan"].r.numpy(), dt=pr["plan"].dt.numpy(),
               lb=pr["x_bounds"][0].numpy(), ub=pr["x_bounds"][1].numpy(),
               m=spec.model.total_mass)
    return out


def f_bounds(p, fz_max):
    """Box bounds on the forces: |fx|, |fy| <= 5 N, 0 <= fz <= fz_max."""
    lb = np.broadcast_to(np.array([-5.0, -5.0, 0.0]), p["F_wm"].shape).copy()
    ub = np.broadcast_to(np.array([5.0, 5.0, fz_max]), p["F_wm"].shape).copy()
    return lb, ub


def run_jax(p, kw, fb=None):
    c = {k: jnp.asarray(v, jnp.float64) for k, v in p.items() if k != "m"}
    plan = jcd.ContactPlan(cnt=c["cnt"], r=c["r"], dt=c["dt"])
    res = jbc.solve(
        plan, p["m"], c["x_init"], jbc.CostX(W=c["W"], X_ref=c["X_ref"]), c["W_F"], c["X_wm"],
        c["F_wm"], jnp.zeros_like(c["X_wm"]), jbc.BiconvexConfig(**{**BASE, **kw}),
        x_bounds=(c["lb"], c["ub"]),
        f_bounds=None if fb is None else tuple(jnp.asarray(b) for b in fb))
    return {k: None if getattr(res, k) is None else np.asarray(getattr(res, k))
            for k in res._fields}


def run_torch(p, kw, fb=None):
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in p.items() if k != "m"}
    plan = tcd.ContactPlan(cnt=t["cnt"], r=t["r"], dt=t["dt"])
    res = tbc.solve(
        plan, p["m"], t["x_init"], tbc.CostX(W=t["W"], X_ref=t["X_ref"]), t["W_F"], t["X_wm"],
        t["F_wm"], torch.zeros_like(t["X_wm"]), tbc.BiconvexConfig(**{**BASE, **kw}),
        x_bounds=(t["lb"], t["ub"]),
        f_bounds=None if fb is None else tuple(torch.as_tensor(b) for b in fb))
    return {k: None if getattr(res, k) is None else getattr(res, k).numpy()
            for k in res._fields}


def assert_match(got, ref):
    for k in ("X", "F", "P"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-7, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["admm_iters"], ref["admm_iters"])
    assert (got["viol_hist"] is None) == (ref["viol_hist"] is None)
    if ref["viol_hist"] is not None:
        np.testing.assert_allclose(got["viol_hist"], ref["viol_hist"], atol=1e-7, rtol=0)


# The reference's squared-norm cone map is not a projection (not
# nonexpansive): FISTA iterated on it amplifies rounding, 1e-10 apart after 3
# ADMM iterations of 40 FISTA iterations each and 2e-3 after 30, between the
# two packages and between any two orders of summation. Its cases take 5
# FISTA iterations a step, where both packages agree to 1e-13 over 30 ADMM
# iterations.
CHAOTIC = dict(fista_max_iters=5)
OPTIONS = {
    "linesearch_thomas": dict(step_mode="linesearch"),
    "linesearch_fista": dict(step_mode="linesearch", x_solver="fista"),
    "soc_reference": dict(soc_mode="reference", **CHAOTIC),
    "momentum_textbook": dict(momentum="textbook", x_solver="fista"),
    "log_statistics": dict(log_statistics=True),
    "reference_everything": dict(step_mode="linesearch", soc_mode="reference",
                                 momentum="textbook", log_statistics=True, dual_relax=1.0,
                                 rho_growth=1.0, **CHAOTIC),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_against_jax(problem, name):
    kw = OPTIONS[name]
    ref = run_jax(problem, kw)
    got = run_torch(problem, kw)
    assert_match(got, ref)
    assert np.all(np.isfinite(got["X"])) and np.all(got["admm_iters"] > 1)


@pytest.mark.parametrize("fz_max, binds", [(1e3, False), (6.0, True)])
def test_box_bounded_forces_against_jax(problem, fz_max, binds):
    """``use_soc=False``: the F-step projects onto ``f_bounds``. With fz <=
    6 N (a quarter of the robot's weight split over fewer feet) the bound
    binds on the stance feet."""
    fb = f_bounds(problem, fz_max)
    kw = dict(use_soc=False, log_statistics=True)
    ref = run_jax(problem, kw, fb)
    got = run_torch(problem, kw, fb)
    assert_match(got, ref)
    at_bound = np.isclose(got["F"][..., 2], fz_max, atol=1e-9, rtol=0)
    assert bool(at_bound.any()) == binds
    assert np.all(got["F"] <= fb[1] + 1e-12) and np.all(got["F"] >= fb[0] - 1e-12)


@pytest.mark.parametrize("field", ["x_solver", "step_mode", "soc_mode", "momentum"])
def test_unknown_choices_raise(problem, field):
    with pytest.raises(ValueError, match=field):
        run_torch(problem, {field: "bogus"})


def test_viol_hist_is_the_iterations_violations(problem):
    """The last logged violation of each problem is its final violation,
    and nothing is logged past its last iteration."""
    got = run_torch(problem, dict(log_statistics=True))
    it = got["admm_iters"]
    for b in range(N):
        assert got["viol_hist"][b, it[b] - 1] == got["viol_norm"][b]
        assert np.all(got["viol_hist"][b, it[b]:] == 0.0)
        assert np.all(got["viol_hist"][b, :it[b]] > 0.0)


@pytest.mark.parametrize("mode", ["exact", "reference"])
def test_soc_projector_against_jax(mode):
    rng = np.random.default_rng(0)
    z = rng.normal(size=(64, 4, 3)) * 3.0
    z[:5, :, :2] = 0.0  # s = 0 on the axis
    got = tfista.soc_projector(0.7, mode)(torch.as_tensor(z)).numpy()
    ref = np.asarray(jfista.soc_projector(0.7, mode)(jnp.asarray(z)))
    np.testing.assert_allclose(got, ref, atol=1e-14, rtol=0)


@pytest.mark.parametrize("momentum", ["reference", "textbook"])
def test_backtracking_fista_against_jax(momentum):
    """``fista.solve`` on a batch of box-constrained least squares
    ``|A x - b|^2`` from L0 = 1 (every problem backtracks): the solution,
    the final Lipschitz estimates and, through them, the trials taken."""
    rng = np.random.default_rng(1)
    B, n = 6, 5
    A = rng.normal(size=(B, 8, n))
    b = rng.normal(size=(B, 8))
    lb, ub = -0.3 * np.ones(n), 0.3 * np.ones(n)

    cfg_kw = dict(max_iters=60, tol=1e-6, beta=1.5, max_linesearch=30, momentum=momentum)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)

    def res_j(x):
        return (Aj @ x[..., None])[..., 0] - bj

    ref = jfista.solve(
        jnp.zeros((B, n)), lambda x: 2.0 * (jnp.swapaxes(Aj, 1, 2) @ res_j(x)[..., None])[..., 0],
        lambda x1, x0: (res_j(x1) ** 2).sum(-1) - (res_j(x0) ** 2).sum(-1),
        jfista.box_projector(lb, ub), 1.0, jfista.FistaConfig(**cfg_kw))

    At, bt = torch.as_tensor(A), torch.as_tensor(b)

    def res_t(x):
        return (At @ x[..., None])[..., 0] - bt

    res = tfista.solve(
        torch.zeros(B, n, dtype=torch.float64),
        lambda x: 2.0 * (At.transpose(1, 2) @ res_t(x)[..., None])[..., 0],
        lambda x1, x0: (res_t(x1) ** 2).sum(-1) - (res_t(x0) ** 2).sum(-1),
        tfista.box_projector(torch.as_tensor(lb), torch.as_tensor(ub)), 1.0,
        tfista.FistaConfig(**cfg_kw))
    x, L = res.x, res.L
    np.testing.assert_allclose(x.numpy(), np.asarray(ref.x), atol=1e-12, rtol=0)
    np.testing.assert_array_equal(res.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(L.numpy(), np.asarray(ref.L))
    assert np.all(L.numpy() > 1.0)
