"""K1's plain version (the port's batched ADMM, ``solvers/biconvex.py``) and
K1's per-problem math (``csrc/admm.cu`` built for the host with g++) against
the JAX package's ``biconvex.solve``, on the ``problem`` fixture of
tests/test_pallas_admm.py: x_solver "thomas" at B=8; the other branches
(x_solver "fista", with and without precondition) at B=4.

Tolerances: f32 with the reference schedule and 15 iterations, the JAX
package's own Pallas-vs-XLA gates (X 1e-4, F 1e-3, viol rtol 1e-3); f64 with
the accelerated default schedule, X/F atol 1e-7 and equal iteration counts
(the same algorithm in double precision); the fista branches in f32 with the
reference schedule of tests/test_pallas_admm.py:43-46 and its fista gates
(:69-72: X 5e-3, F 2e-1, viol rtol 1e-3)."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bunmpc_tpu.mpc import centroidal as jcd
from bunmpc_tpu.solvers import biconvex as jbc
from bunmpc_tpu_torch.mpc import centroidal as tcd
from bunmpc_tpu_torch.solvers import biconvex as tbc
from bunmpc_tpu_torch.solvers import cuda_admm

from torch_port_helpers import M_ADMM, admm_problem, call_host, host_lib, to_torch

B = 8
RHO = 5e4
PINNED = dict(max_admm_iters=15, dual_relax=1.0, rho_growth=1.0)


@pytest.fixture(scope="module")
def problem():
    return admm_problem(B)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host_lib("admm", tmp_path_factory)


def run_jax(p, cfg, dtype):
    c = {k: jnp.asarray(v, dtype) for k, v in p.items()}
    plan = jcd.ContactPlan(cnt=c["cnt"], r=c["r"], dt=c["dt"])
    res = jbc.solve(
        plan, M_ADMM, c["x_init"], jbc.CostX(W=c["W"], X_ref=c["X_ref"]), c["W_F"], c["X_wm"],
        c["F_wm"], jnp.zeros_like(c["X_wm"]), cfg, x_bounds=(c["lb"], c["ub"]),
    )
    return [np.asarray(a) for a in (res.X, res.F, res.viol_norm, res.admm_iters)]


def admm_args(p, dtype):
    t = to_torch(p, dtype)
    plan = tcd.ContactPlan(cnt=t["cnt"], r=t["r"], dt=t["dt"])
    return (plan, M_ADMM, t["x_init"], t["W"], t["X_ref"], t["W_F"], t["X_wm"], t["F_wm"],
            (t["lb"], t["ub"]))


def run_torch(p, cfg, dtype):
    args = admm_args(p, dtype)
    res = tbc.solve(*args[:3], tbc.CostX(W=args[3], X_ref=args[4]), *args[5:8],
                    torch.zeros_like(args[6]), cfg, x_bounds=args[8])
    return [a.numpy() for a in (res.X, res.F, res.viol_norm, res.admm_iters)]


def run_host(lib, p, cfg, dtype):
    args, keep, out = cuda_admm.kernel_args(*admm_args(p, dtype), cfg)
    symbol = "admm_host_f64" if dtype == torch.float64 else "admm_host_f32"
    call_host(lib, symbol, cuda_admm.ARGTYPES, args)
    return [a.numpy() for a in out[:4]]


def assert_pinned_gates(got, ref):
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-6)


def assert_f64_match(got, ref):
    np.testing.assert_allclose(got[0], ref[0], atol=1e-7, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-7, rtol=0)
    np.testing.assert_array_equal(got[3], ref[3])


@pytest.fixture(scope="module")
def jax_refs(problem):
    return {
        "pinned32": run_jax(problem, jbc.BiconvexConfig(rho=RHO, x_solver="thomas", **PINNED),
                            jnp.float32),
        "default64": run_jax(problem, jbc.BiconvexConfig(rho=RHO, x_solver="thomas"),
                             jnp.float64),
    }


def test_plain_f32_reference_schedule(problem, jax_refs):
    got = run_torch(problem, tbc.BiconvexConfig(rho=RHO, **PINNED), torch.float32)
    assert_pinned_gates(got, jax_refs["pinned32"])


def test_plain_f64_accelerated_schedule(problem, jax_refs):
    got = run_torch(problem, tbc.BiconvexConfig(rho=RHO), torch.float64)
    assert_f64_match(got, jax_refs["default64"])
    assert np.all(got[2] < 1e-3)


def test_kernel_math_f32_reference_schedule(lib, problem, jax_refs):
    got = run_host(lib, problem, cuda_admm.CudaAdmmConfig(rho=RHO, **PINNED), torch.float32)
    assert_pinned_gates(got, jax_refs["pinned32"])


def test_kernel_math_f64_accelerated_schedule(lib, problem, jax_refs):
    got = run_host(lib, problem, cuda_admm.CudaAdmmConfig(rho=RHO), torch.float64)
    assert_f64_match(got, jax_refs["default64"])


def test_kernel_math_fista_cap_and_box(lib, problem):
    """The capped FISTA of the main path (fista_max_iters=30) and a binding
    kinematic box (the CoM x within +-2 cm): the kernel math against the plain
    version in f64 over the first 5 ADMM iterations (a binding box keeps the
    alternation from converging, so only the early iterates are compared)."""
    p = dict(problem)
    p["lb"] = p["lb"].copy()
    p["ub"] = p["ub"].copy()
    p["lb"][:, :20, 0] = -0.02
    p["ub"][:, :20, 0] = 0.02
    cfg = cuda_admm.CudaAdmmConfig(rho=RHO, fista_max_iters=30, max_admm_iters=5)
    got = run_host(lib, p, cfg, torch.float64)
    ref = [a.numpy() for a in cuda_admm.solve_plain(*admm_args(p, torch.float64), cfg)]
    assert np.sum(np.abs(np.abs(ref[0][:, :20, 0]) - 0.02) < 1e-12) > 10  # the box binds
    np.testing.assert_allclose(got[0], ref[0], atol=1e-9, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-8, rtol=0)
    np.testing.assert_array_equal(got[3], ref[3])


@pytest.mark.parametrize("h", [1, 6, 10, 12, 20, 24, 30, 40])
def test_scratch_layout_matches_kernel(lib, h):
    """The wrapper's size of a problem's shared-memory slice is the kernel's
    layout (K1's and K3's), at every Solo12 gait's horizon (6, 10, 12, 20,
    24, 30) and 40."""
    lib.admm_shared_size.restype = ctypes.c_long
    lib.admm_shared_size.argtypes = [ctypes.c_int]
    assert lib.admm_shared_size(h) == cuda_admm.shared_size(h)


def test_horizon_past_shared_memory_raises():
    """K1 and K3 fit fewer problems a block at a long horizon; a horizon
    whose one problem does not fit a block's shared memory raises, naming
    the limit."""
    assert cuda_admm.launch_per_block(20) == cuda_admm.PER_BLOCK
    assert 1 <= cuda_admm.launch_per_block(120) < cuda_admm.PER_BLOCK
    with pytest.raises(ValueError, match="232448 bytes a thread block"):
        cuda_admm.launch_per_block(200)


@pytest.mark.parametrize("runner", ["plain", "kernel_math"])
def test_batch_equals_single(lib, problem, runner):
    """Solving a batch equals solving each problem alone: convergence masks
    are per problem, which is what makes K1's per-problem early exit exact."""
    cfg = tbc.BiconvexConfig(rho=RHO)
    kcfg = cuda_admm.CudaAdmmConfig(rho=RHO)

    def run(p):
        if runner == "plain":
            return run_torch(p, cfg, torch.float64)
        return run_host(lib, p, kcfg, torch.float64)

    batch = run(problem)
    for i in (0, 3, 7):
        single = run({k: v[i : i + 1] for k, v in problem.items()})
        np.testing.assert_allclose(batch[0][i], single[0][0], atol=1e-12, rtol=0)
        np.testing.assert_allclose(batch[1][i], single[1][0], atol=1e-10, rtol=0)
        assert batch[3][i] == single[3][0]


BRANCHES = {"fista": dict(x_solver="fista"),
            "fista_precondition": dict(x_solver="fista", precondition=True)}
REFERENCE_FISTA = dict(max_admm_iters=60, fista_max_iters=120, dual_relax=1.0, rho_growth=1.0)


@pytest.fixture(scope="module")
def problem4():
    return admm_problem(4)


@pytest.fixture(scope="module")
def branch_runs(problem4):
    """Per branch, the JAX package's solve and the plain version in f64."""
    return {
        name: (run_jax(problem4, jbc.BiconvexConfig(rho=RHO, **kw), jnp.float64),
               run_torch(problem4, tbc.BiconvexConfig(rho=RHO, **kw), torch.float64))
        for name, kw in BRANCHES.items()
    }


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_plain_branch_f64(branch_runs, branch):
    ref, got = branch_runs[branch]
    assert_f64_match(got, ref)
    assert np.all(got[2] < 1e-3)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_kernel_math_branch_f64(lib, problem4, branch_runs, branch):
    got = run_host(lib, problem4, cuda_admm.CudaAdmmConfig(rho=RHO, **BRANCHES[branch]),
                   torch.float64)
    assert_f64_match(got, branch_runs[branch][1])


def test_kernel_math_fista_precondition_f32(lib, problem4):
    kw = dict(x_solver="fista", precondition=True, **REFERENCE_FISTA)
    ref = run_jax(problem4, jbc.BiconvexConfig(rho=RHO, **kw), jnp.float32)
    got = run_host(lib, problem4, cuda_admm.CudaAdmmConfig(rho=RHO, **kw), torch.float32)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got[0], ref[0], atol=5e-3, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=2e-1, rtol=0)


# the gaits whose shapes the trot never reaches: jump (H=30, every foot in
# phase, knots with all feet in flight), walk (H=6), still (stance 1.0)
GAIT_CASES = ("jump", "walk", "still")


@pytest.mark.parametrize("name", GAIT_CASES)
def test_kernel_math_at_gait_horizons(lib, name):
    """K1's per-problem math on a gait's own problems (its horizon and
    contact plan, ``workload.gait_states(name, 4)``): the g++ build against
    the plain version in f64 with bench.py's config (thomas, capped FISTA,
    the accelerated schedule), X and F within 1e-7 and equal iteration
    counts, as the trot's f64 gate. Jump from a mid-trot draw (problem 1:
    seven knots of flight from the window's start) makes the ADMM diverge
    in both, as it does in the JAX package (its solve of such a draw ends
    at a violation of 1.2e7, tests/fixtures/torch_gaits_solo12.npz): there
    both stop at the iteration cap with a violation above 1e3, and rounding
    grows without bound, so their iterates are not compared."""
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.workload import gait_states

    g = GAITS[name]
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), g, Solo12Config.q0(), device="cpu")
    pr = KD._prepare_problem(spec, *[torch.as_tensor(a, dtype=torch.float64)
                                     for a in gait_states(name, 4)])
    args = (pr["plan"], spec.model.total_mass, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"],
            pr["X_wm"], pr["F_wm"], pr["x_bounds"])
    cfg = cuda_admm.CudaAdmmConfig(rho=g.rho, fista_max_iters=30)
    kargs, keep, out = cuda_admm.kernel_args(*args, cfg)
    call_host(lib, "admm_host_f64", cuda_admm.ARGTYPES, kargs)
    ref = cuda_admm.solve_plain(*args, cfg)
    assert out[0].shape == (4, spec.horizon + 1, 9)
    np.testing.assert_array_equal(out[3].numpy(), ref[3].numpy())
    ok = ref[2] < cfg.exit_tol
    assert int(ok.sum()) == (3 if name == "jump" else 4)
    assert_f64_match([a[ok].numpy() for a in out[:4]], [a[ok].numpy() for a in ref])
    assert bool((out[2][~ok] > 1e3).all() and (ref[2][~ok] > 1e3).all())
    assert bool((ref[3][~ok] == cfg.max_admm_iters).all())
    assert bool(torch.isfinite(out[0]).all() and torch.isfinite(out[1]).all())
    cnt = pr["plan"].cnt
    if name == "jump":
        assert bool((cnt.sum(-1) == 0).any())
        flight = cnt == 0
        assert float(out[1].abs()[flight].max()) < 1e-12  # no force on a foot in flight
    if name == "still":
        assert bool((cnt == 1).all())


@pytest.fixture(scope="module")
def carried(problem4):
    """A previous window's solution with a non-zero dual: 25 iterations of the
    plain version in f64 (the rho schedule escalates at iterations 10 and
    20, so the returned dual has been rescaled to the base rho)."""
    args = admm_args(problem4, torch.float64)
    X, F, _, _, P = cuda_admm.solve_plain(*args, cuda_admm.CudaAdmmConfig(rho=RHO,
                                                                          max_admm_iters=25))
    return X, F, P


@pytest.mark.parametrize("precondition", [False, True])
def test_kernel_math_carries_the_dual(lib, problem4, carried, precondition):
    """K1 with a carried (X, F, P) on both precondition branches: the g++
    build in f64 against the plain version with the same ``P_wm``, and the
    plain version against the JAX package's ``biconvex.solve``, X, F and the
    returned dual P within 1e-7 (f64), equal iteration counts. The dual is
    read at the base rho and given back at it."""
    X0, F0, P0 = carried
    assert float(P0.abs().max()) > 1e-4
    args = admm_args(problem4, torch.float64)[:6] + (X0, F0, admm_args(problem4, torch.float64)[8])
    cfg = cuda_admm.CudaAdmmConfig(rho=RHO, precondition=precondition)
    kargs, keep, out = cuda_admm.kernel_args(*args, cfg, P_wm=P0)
    call_host(lib, "admm_host_f64", cuda_admm.ARGTYPES, kargs)
    ref = cuda_admm.solve_plain(*args, cfg, P_wm=P0)
    for i, name in ((0, "X"), (1, "F"), (5, "P")):
        np.testing.assert_allclose(out[i].numpy(), ref[4 if name == "P" else i].numpy(),
                                   atol=1e-7, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out[3].numpy(), ref[3].numpy())
    assert bool((ref[2] < cfg.exit_tol).all())
    c = {k: jnp.asarray(v, jnp.float64) for k, v in problem4.items()}
    jres = jbc.solve(
        jcd.ContactPlan(cnt=c["cnt"], r=c["r"], dt=c["dt"]), M_ADMM, c["x_init"],
        jbc.CostX(W=c["W"], X_ref=c["X_ref"]), c["W_F"], jnp.asarray(X0.numpy()),
        jnp.asarray(F0.numpy()), jnp.asarray(P0.numpy()),
        jbc.BiconvexConfig(rho=RHO, precondition=precondition), x_bounds=(c["lb"], c["ub"]))
    for a, b, name in ((ref[0], jres.X, "X"), (ref[1], jres.F, "F"), (ref[4], jres.P, "P")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7, rtol=0, err_msg=name)
    np.testing.assert_array_equal(ref[3].numpy(), np.asarray(jres.admm_iters))
    # the carried dual moves the solve: the same warm start with a zero dual differs
    cold = cuda_admm.solve_plain(*args, cfg)
    assert float((cold[4] - ref[4]).abs().max()) > 1e-6


def test_kernel_math_without_dual_is_the_cold_start(lib, problem4):
    """No ``P_wm`` (a null pointer) starts the dual at zero: the g++ build
    equals a launch with an explicit zero dual bit for bit."""
    args = admm_args(problem4, torch.float64)
    cfg = cuda_admm.CudaAdmmConfig(rho=RHO)
    outs = []
    for P_wm in (None, torch.zeros_like(args[6])):
        kargs, keep, out = cuda_admm.kernel_args(*args, cfg, P_wm=P_wm)
        call_host(lib, "admm_host_f64", cuda_admm.ARGTYPES, kargs)
        outs.append(out)
    for a, b in zip(outs[0][:4] + outs[0][5:], outs[1][:4] + outs[1][5:]):
        assert torch.equal(a, b)
