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


@pytest.mark.parametrize("h", [1, 20, 30, 40])
def test_scratch_layout_matches_kernel(lib, h):
    """The wrapper's size of a problem's shared-memory slice is the kernel's
    layout (K1's and K3's), at the trot's horizon (20), 30 and 40."""
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
