"""The hand-written kernels against their plain versions on the card, at the
main path's shapes (B=512). Marked ``cuda``: they skip on a host without a
CUDA device and run on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: the suite's conftest configures JAX, which the card does
not need.)

Gates: K1 with the reference schedule and 15 iterations, the JAX package's
Pallas-vs-XLA gates (X 1e-4, F 1e-3, viol rtol 1e-3); K2 for one iteration
with one alpha against the plain version in f64 (xs 2e-4, us 2e-3, cost rtol
1e-4); the launch counters rise by one per kernel call; K1, K2 and K3 give a
5-problem batch the rows of the 512-problem batch, bit for bit; K1 at H=40
and K2 at IK H=20 (fewer problems a block) with the same gates."""

import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)

pytestmark = pytest.mark.cuda

B = 512


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no interpreter)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def main_path(device):
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config

    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0())
    inputs = [torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in workload.trot_states(B)]
    return spec, KD._prepare_problem(spec, *inputs)


def test_admm_kernel_matches_plain(main_path):
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu_torch.solvers import cuda_admm

    spec, prob = main_path
    args = (prob["plan"], spec.model.total_mass, prob["x_init"], prob["W"], prob["X_ref"],
            prob["W_F"], prob["X_wm"], prob["F_wm"], prob["x_bounds"])
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, max_admm_iters=15, dual_relax=1.0,
                                   rho_growth=1.0)
    before = cuda_admm.KERNEL.launches
    Xk, Fk, vk, _ = cuda_admm.solve(*args, cfg)
    assert cuda_admm.KERNEL.launches == before + 1
    Xp, Fp, vp, _ = cuda_admm.solve_plain(*args, cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(Xk, Xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(Fk, Fp, atol=1e-3, rtol=0)
    torch.testing.assert_close(vk, vp, rtol=1e-3, atol=1e-6)


def test_ddp_kernel_matches_plain(main_path):
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.solvers import cuda_ddp

    spec, _ = main_path
    args = workload.random_ik_problems(spec.model, spec.eff_frames, B, spec.ik_hor,
                                       torch.device("cuda"))
    args64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    cfg = cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,))
    before = cuda_ddp.KERNEL.launches
    xs, us, cost = cuda_ddp.solve_ik_batch(*args, cfg=cfg)
    assert cuda_ddp.KERNEL.launches == before + 1
    xs_p, us_p, cost_p = cuda_ddp.solve_ik_batch_plain(*args64, cfg=cfg)
    torch.cuda.synchronize()
    torch.testing.assert_close(xs.double(), xs_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(us.double(), us_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(cost.double(), cost_p, rtol=1e-4, atol=0)


def test_any_batch_size_gives_the_same_rows(main_path):
    """Problems never wait for or read each other: the first 5 problems
    solved alone (a ragged last block, lanes of absent problems idle) equal
    their rows of the 512-problem solve, bit for bit."""
    from bunmpc_tpu_torch.mpc import ik as IK
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    spec, prob = main_path
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, fista_max_iters=30)
    plan = prob["plan"]
    full = (plan, spec.model.total_mass, prob["x_init"], prob["W"], prob["X_ref"],
            prob["W_F"], prob["X_wm"], prob["F_wm"], prob["x_bounds"])

    def rows(a):
        return a[:5].contiguous()

    part = (type(plan)(cnt=rows(plan.cnt), r=rows(plan.r), dt=rows(plan.dt)),
            spec.model.total_mass, *[rows(a) for a in full[2:8]],
            tuple(rows(a) for a in full[8]))
    X, F, viol, iters = cuda_admm.solve(*full, cfg)
    Xp, Fp, violp, itersp = cuda_admm.solve(*part, cfg)
    assert torch.equal(X[:5], Xp) and torch.equal(F[:5], Fp) and torch.equal(iters[:5], itersp)

    tasks, x0 = KD._build_ik_tasks(spec, prob, X)
    ws, wt, cw, xr = IK.dense_weights(spec.model, spec.eff_frames, tasks)
    args = (x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, xr, ws, wt, cw, tasks.dts)
    xs, us, cost = cuda_ddp.solve_ik_batch(spec.model, spec.eff_frames, *args)
    xs5, us5, cost5 = cuda_ddp.solve_ik_batch(spec.model, spec.eff_frames,
                                              *[rows(a) for a in args])
    torch.cuda.synchronize()
    assert torch.equal(xs[:5], xs5) and torch.equal(us[:5], us5) and torch.equal(cost[:5], cost5)


def test_fused_any_batch_size_gives_the_same_rows(device, main_path):
    """K3 (problem assembly + ADMM) on the first 5 problems, a ragged block,
    equals its rows of the 512-problem launch bit for bit, plan included."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_fused

    spec, _ = main_path
    inputs = [torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in workload.trot_states(B)]
    _, t, vdw, x_init, ee, hip, amom = KD._compact_inputs(spec, *inputs)
    ins = (t, vdw, inputs[4], x_init, ee, hip, amom)
    rest = (spec.model.total_mass, KD.make_prep_consts(spec),
            cuda_admm.CudaAdmmConfig(rho=trot.rho, fista_max_iters=30), spec.horizon,
            spec.n_eff)
    before = cuda_fused.KERNEL.launches
    full = cuda_fused.solve_from_state(*ins, *rest)
    part = cuda_fused.solve_from_state(*[a[:5].contiguous() for a in ins], *rest)
    torch.cuda.synchronize()
    assert cuda_fused.KERNEL.launches == before + 2
    for a, b in zip(full, part):
        assert torch.equal(a[:5], b)


def test_long_horizon_kernels_match_plain(device, main_path):
    """The trot with gait_horizon=4.0 (ADMM H=40, IK H=20, twice the main
    path's), where fewer problems fit a block's shared memory: K1 and K2
    against their plain versions with the gates above."""
    import dataclasses

    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    spec = KD.make_cyclic_spec(Solo12Config.load_model(),
                               dataclasses.replace(trot, gait_horizon=4.0), Solo12Config.q0())
    assert (spec.horizon, spec.ik_hor) == (40, 20)
    assert cuda_ddp.launch_per_block(spec.ik_hor) < cuda_ddp.PER_BLOCK
    inputs = [torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in workload.trot_states(B)]
    prob = KD._prepare_problem(spec, *inputs)
    args = (prob["plan"], spec.model.total_mass, prob["x_init"], prob["W"], prob["X_ref"],
            prob["W_F"], prob["X_wm"], prob["F_wm"], prob["x_bounds"])
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, max_admm_iters=15, dual_relax=1.0,
                                   rho_growth=1.0)
    Xk, Fk, vk, _ = cuda_admm.solve(*args, cfg)
    Xp, Fp, vp, _ = cuda_admm.solve_plain(*args, cfg)
    torch.testing.assert_close(Xk, Xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(Fk, Fp, atol=1e-3, rtol=0)
    torch.testing.assert_close(vk, vp, rtol=1e-3, atol=1e-6)
    ik = workload.random_ik_problems(spec.model, spec.eff_frames, B, spec.ik_hor, device)
    ik64 = tuple(a.double() if torch.is_tensor(a) else a for a in ik)
    one = cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,))
    xs, us, cost = cuda_ddp.solve_ik_batch(*ik, cfg=one)
    xs_p, us_p, cost_p = cuda_ddp.solve_ik_batch_plain(*ik64, cfg=one)
    torch.cuda.synchronize()
    torch.testing.assert_close(xs.double(), xs_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(us.double(), us_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(cost.double(), cost_p, rtol=1e-4, atol=0)
