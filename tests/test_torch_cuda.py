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
and K2 at IK H=20 (fewer problems a block) with the same gates; the closed
loop launches K1 and K2 once a window and gives 37 episodes the records of
the same episodes inside a batch of 64, bit for bit; the policy rollouts
(vc and cc goals) launch no MPC kernel and end within 10x the CPU's f32
distance to the JAX package's f64 fixture; the gated rollouts (SafeDAgger,
DAgger) launch K1 and K2 once a window and keep the gate of the JAX
package's f64 fixture; every Solo12 gait's K1, K2 and K3 against the plain
versions at B=16; K1 with a carried dual on both precondition branches
against the plain version in f64 (X and P at phase 6's quantile gate); every
Go2 gait's K1, K2 (with the Go2's model buffer) and K3 at B=16; the Go2 loop
with every per-episode option gives 17 of the sweep's rows, and the rows in
reverse order, the records of the same rows inside the 40-row sweep, bit for
bit; K2 built for 8 joints (the Solo8; its own library and launch count) at
IK H 10 and 30 and K2 at 12 joints
at the acyclic motions' IK H 30 against the plain version in f64 with the
gates above, and with ragged batches and every block size that fits, bit for
bit; every acyclic motion's K1 at B=16 with the gates above."""

import numpy as np
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
    Xk, Fk, vk, _, _ = cuda_admm.solve(*args, cfg)
    assert cuda_admm.KERNEL.launches == before + 1
    Xp, Fp, vp, _, _ = cuda_admm.solve_plain(*args, cfg)
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
    X, F, viol, iters, _ = cuda_admm.solve(*full, cfg)
    Xp, Fp, violp, itersp, _ = cuda_admm.solve(*part, cfg)
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
    Xk, Fk, vk, _, _ = cuda_admm.solve(*args, cfg)
    Xp, Fp, vp, _, _ = cuda_admm.solve_plain(*args, cfg)
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


GAIT_NAMES = ("trot", "trot_sim", "trot_turn", "jump", "bound", "bound_turn", "air_bound",
              "still", "gallop", "walk")


@pytest.mark.parametrize("name", GAIT_NAMES)
def test_gait_kernels_match_plain(device, name):
    """Every Solo12 gait at B=16 on its own problems (``workload.
    gait_states``: H 6..30, IK H 3..15, stance 1.0, all-flight knots): K1 and
    K3 with the reference schedule and 15 iterations against their plain
    versions (X 1e-4, F 1e-3, viol rtol 1e-3; K3's contact plan flags exact,
    r and dt 1e-5), K2 one iteration with one alpha on the random IK
    problems at the gait's IK horizon against the plain version in f64 (xs
    2e-4, us 2e-3, cost rtol 1e-4); each call launches its kernel once."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused

    g = GAITS[name]
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), g, Solo12Config.q0())
    m, H = spec.model.total_mass, spec.horizon
    inputs = [torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in workload.gait_states(name, 16)]
    prob = KD._prepare_problem(spec, *inputs)
    args = (prob["plan"], m, prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"],
            prob["X_wm"], prob["F_wm"], prob["x_bounds"])
    cfg = cuda_admm.CudaAdmmConfig(rho=g.rho, max_admm_iters=15, dual_relax=1.0, rho_growth=1.0)
    before = {k: mod.KERNEL.launches for k, mod in (("admm", cuda_admm), ("ddp", cuda_ddp),
                                                     ("fused", cuda_fused))}
    Xk, Fk, vk, _, _ = cuda_admm.solve(*args, cfg)
    Xp, Fp, vp, _, _ = cuda_admm.solve_plain(*args, cfg)
    torch.testing.assert_close(Xk, Xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(Fk, Fp, atol=1e-3, rtol=0)
    torch.testing.assert_close(vk, vp, rtol=1e-3, atol=1e-6)
    _, t, vdw, x_init, ee, hip, amom = KD._compact_inputs(spec, *inputs)
    k3_in = (t, vdw, inputs[4], x_init, ee, hip, amom, m, KD.make_prep_consts(spec), cfg, H,
             spec.n_eff)
    K = cuda_fused.solve_from_state(*k3_in)
    P = cuda_fused.solve_from_state_plain(*k3_in)
    assert torch.equal(K[4], P[4]) and torch.equal(K[7], P[7])
    torch.testing.assert_close(K[5], P[5], atol=1e-5, rtol=0)
    torch.testing.assert_close(K[6], P[6], atol=1e-5, rtol=0)
    torch.testing.assert_close(K[0], P[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(K[1], P[1], atol=1e-3, rtol=0)
    ik = workload.random_ik_problems(spec.model, spec.eff_frames, 16, spec.ik_hor, device)
    ik64 = tuple(a.double() if torch.is_tensor(a) else a for a in ik)
    one = cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,))
    xs, us, cost = cuda_ddp.solve_ik_batch(*ik, cfg=one)
    xs_p, us_p, cost_p = cuda_ddp.solve_ik_batch_plain(*ik64, cfg=one)
    torch.cuda.synchronize()
    torch.testing.assert_close(xs.double(), xs_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(us.double(), us_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(cost.double(), cost_p, rtol=1e-4, atol=0)
    after = {k: mod.KERNEL.launches for k, mod in (("admm", cuda_admm), ("ddp", cuda_ddp),
                                                    ("fused", cuda_fused))}
    assert {k: after[k] - before[k] for k in after} == {"admm": 1, "ddp": 1, "fused": 1}


def test_closed_loop_launches_once_a_window_and_any_batch_size(device):
    """Three windows of the closed loop (trot_sim from the settled start):
    K1 and K2 launch once a window for the whole batch, and 37 episodes give
    the records of the same episodes inside a batch of 64, bit for bit."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.sim import physics, rollout
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0())
    sim = workload.closed_loop_sim_params()
    start = workload.settled_start(64)
    v_des, w_des = (torch.as_tensor(a, dtype=torch.float32, device=device)
                    for a in workload.command_draw(64))
    cfg = rollout.RolloutConfig(episode_length=150, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    before = (cuda_admm.KERNEL.launches, cuda_ddp.KERNEL.launches)
    full = rollout.rollout_mpc(spec, sim, cfg, start, v_des, w_des)
    assert (cuda_admm.KERNEL.launches, cuda_ddp.KERNEL.launches) == (before[0] + 3,
                                                                      before[1] + 3)
    part = rollout.rollout_mpc(
        spec, sim, cfg, physics.SimState(start.q[:37].contiguous(), start.v[:37].contiguous()),
        v_des[:37].contiguous(), w_des[:37].contiguous())
    torch.cuda.synchronize()
    assert torch.isfinite(full.states).all()
    for name in ("states", "actions", "vc_goals", "base", "com", "contact_forces",
                 "contact_pos", "in_contact", "failed", "fail_step"):
        assert torch.equal(getattr(part, name), getattr(full, name)[:37]), name


@pytest.mark.parametrize("variant", ["vc", "cc"])
def test_policy_rollout_on_the_card_matches_the_jax_fixture(device, variant):
    """100 steps of the policy rollout fixture (tests/torch_learning_reference.py,
    the JAX package in f64) on the card in f32, each substep a graph replay
    with the MLP inside: no MPC launch, and the end state within 10x the
    CPU's own f32 distance to the fixture (q 5.5e-7, v 9.8e-6)."""
    import numpy as np

    import torch_learning_reference as REF
    from bunmpc_tpu_torch import convert, workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.sim import physics, rollout
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused

    ref = dict(np.load(REF.FIXTURE))
    f32 = torch.float32
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0())
    bundle = convert.policy_bundle_from_flax(
        REF.unflat_params(ref, f"{variant}/params"), ref["state_mean"], ref["state_std"],
        ref[f"{variant}/goal_mean"], ref[f"{variant}/goal_std"], device=device, dtype=f32)

    def rows(a):
        return torch.as_tensor(a, dtype=f32, device=device).expand(REF.B, -1).contiguous()

    cfg = rollout.RolloutConfig(episode_length=REF.T, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    args = (spec, workload.closed_loop_sim_params(), cfg,
            physics.SimState(rows(ref["q0"]), rows(ref["v0"])),
            torch.as_tensor(ref["v_des"], dtype=f32, device=device),
            torch.as_tensor(ref["w_des"], dtype=f32, device=device), bundle)
    before = [k.launches for k in (cuda_admm.KERNEL, cuda_ddp.KERNEL, cuda_fused.KERNEL)]
    if variant == "vc":
        res = rollout.rollout_policy(*args)
    else:
        res = rollout.rollout_policy_cc(*args, ref["schedule"])
    torch.cuda.synchronize()
    assert [k.launches for k in (cuda_admm.KERNEL, cuda_ddp.KERNEL, cuda_fused.KERNEL)] == before
    assert torch.isfinite(res.states).all() and not res.failed.any()
    np.testing.assert_allclose(res.final_state.q.double().cpu().numpy(), ref[f"{variant}/final_q"],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(res.final_state.v.double().cpu().numpy(), ref[f"{variant}/final_v"],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["safedagger", "dagger"])
def test_gated_rollouts_on_the_card_match_the_jax_fixture(device, variant, monkeypatch):
    """The gated rollouts of tests/fixtures/torch_gated_rollout_solo12_trot_sim.npz
    (three episodes with their own start times, 100 steps, the JAX
    package's window clocks) on the card in f32, each substep a graph replay
    with the policy and the gate inside: K1 and K2 launch once a window, the
    gate's record is the fixture's, and the end state lies within 10x the
    CPU's own f32 distance to the fixture (q 1.1e-5, v 4.3e-4). SafeDAgger's
    tilted episode 0 is chaotic (in f32 its release moves by a step on the
    CPU too): it must take over at step 0 and hand back, and agree with the
    fixture's gate on all but 3 steps."""
    import numpy as np

    import torch_dagger_reference as REF
    import torch_learning_reference as POLICY_REF
    from bunmpc_tpu_torch import convert, workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.sim import physics, rollout
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused

    ref = dict(np.load(REF.FIXTURE))
    pol = dict(np.load(POLICY_REF.FIXTURE))
    f32 = torch.float32
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0())
    bundle = convert.policy_bundle_from_flax(
        POLICY_REF.unflat_params(pol, "vc/params"), pol["state_mean"], pol["state_std"],
        pol["vc/goal_mean"], pol["vc/goal_std"], device=device, dtype=f32)
    q0 = ref["q_tilt"] if variant == "safedagger" else np.tile(ref["q0"], (REF.B, 1))
    cfg = rollout.RolloutConfig(episode_length=REF.T, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=f32, device=device)

    monkeypatch.setattr(KD, "window_clock", lambda st, w, pf, like: t(ref["jax_clocks"][:, w]))
    args = (spec, workload.closed_loop_sim_params(), cfg,
            physics.SimState(t(q0), t(np.tile(ref["v0"], (REF.B, 1)))), t(ref["v_des"]),
            t(ref["w_des"]), bundle)
    kernels = (cuda_admm.KERNEL, cuda_ddp.KERNEL, cuda_fused.KERNEL)
    before = [k.launches for k in kernels]
    if variant == "safedagger":
        res = rollout.rollout_safedagger(*args, num_steps_to_block=REF.NUM_STEPS_TO_BLOCK,
                                         start_time=t(ref["start_times"]))
    else:
        res = rollout.rollout_dagger(*args, coins=torch.as_tensor(ref["dagger/coins"]),
                                     start_time=t(ref["start_times"]))
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 0]
    assert torch.isfinite(res.states).all() and not res.failed.any()
    usage, want = res.mpc_usage.cpu().numpy(), ref[f"{variant}/mpc_usage"]
    calm = [1, 2] if variant == "safedagger" else [0, 1, 2]
    np.testing.assert_array_equal(usage[calm], want[calm])
    if variant == "safedagger":
        assert usage[0, 0] == 1 and usage[0, -1] == 0 and (usage[0] != want[0]).sum() <= 3
    np.testing.assert_allclose(res.final_state.q[calm].double().cpu().numpy(),
                               ref[f"{variant}/final_q"][calm], atol=1.1e-4, rtol=0)
    np.testing.assert_allclose(res.final_state.v[calm].double().cpu().numpy(),
                               ref[f"{variant}/final_v"][calm], atol=4.3e-3, rtol=0)


@pytest.mark.parametrize("precondition", [False, True])
def test_admm_kernel_carries_the_dual(main_path, precondition):
    """K1 warm-started from a first solve's (X, F, P) with the accelerated
    schedule (rho escalates and backs off, rescaling the dual): X and the
    returned P against the plain version in f64 at phase 6's quantile gate
    (|d| q0.999 < 5e-3, max < 5e-2) on 64 problems."""
    import dataclasses

    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu_torch.solvers import cuda_admm

    spec, prob = main_path
    n = 64
    args = tuple(a[:n].contiguous() if torch.is_tensor(a) else a for a in (
        prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"], prob["X_wm"], prob["F_wm"]))
    pl = prob["plan"]
    plan = type(pl)(cnt=pl.cnt[:n].contiguous(), r=pl.r[:n].contiguous(),
                    dt=pl.dt[:n].contiguous())
    box = tuple(a[:n].contiguous() for a in prob["x_bounds"])
    cfg = dataclasses.replace(cuda_admm.CudaAdmmConfig(rho=trot.rho, fista_max_iters=30),
                              precondition=precondition)
    m = spec.model.total_mass
    X0, F0, _, _, P0 = cuda_admm.solve(plan, m, *args, box, cfg)
    assert float(P0.abs().max()) > 0
    warm = (plan, m) + args[:4] + (X0, F0, box)
    X, F, viol, iters, P = cuda_admm.solve(*warm, cfg, P_wm=P0)

    def f64(a):
        if isinstance(a, type(pl)):
            return type(pl)(cnt=a.cnt.double(), r=a.r.double(), dt=a.dt.double())
        if isinstance(a, tuple):
            return tuple(x.double() for x in a)
        return a.double() if torch.is_tensor(a) else a

    Xr, Fr, vr, itr, Pr = cuda_admm.solve_plain(*(f64(a) for a in warm), cfg, P_wm=P0.double())
    torch.cuda.synchronize()
    for a, b in ((X, Xr), (P, Pr)):
        d = (a.double() - b).abs().flatten().cpu().numpy()
        assert float(np.quantile(d, 0.999)) < 5e-3 and float(d.max()) < 5e-2


GO2_GAITS = ("trot", "trot_sim", "trot_extended", "bound")


@pytest.mark.parametrize("name", GO2_GAITS)
def test_go2_gait_kernels_match_plain(device, name):
    """Every Go2 gait at B=16 on its own problems (``workload.go2_states``:
    H 20..30, rho 2e5-4e5, the "vdes" warm start, the generic offsets): K1
    and K3 with the reference schedule and 15 iterations against their plain
    versions (X 1e-4, F 1e-3 relative to the 6x heavier forces: 6e-3, viol
    rtol 1e-3; K3's contact plan flags exact, r and dt 1e-5), K2 with the
    Go2's model buffer one iteration with one alpha on the random IK
    problems at the gait's IK horizon against the plain version in f64 (xs
    2e-4, us 2e-3, cost rtol 1e-4)."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.go2_cyclic import GAITS
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused

    g = GAITS[name]
    spec = workload.go2_spec(name)
    m, H = spec.model.total_mass, spec.horizon
    inputs = [torch.as_tensor(a, dtype=torch.float32, device=device)
              for a in workload.go2_states(name, 16)]
    prob = KD._prepare_problem(spec, *inputs)
    args = (prob["plan"], m, prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"],
            prob["X_wm"], prob["F_wm"], prob["x_bounds"])
    cfg = cuda_admm.CudaAdmmConfig(rho=g.rho, max_admm_iters=15, dual_relax=1.0, rho_growth=1.0)
    Xk, Fk, vk, _, _ = cuda_admm.solve(*args, cfg)
    Xp, Fp, vp, _, _ = cuda_admm.solve_plain(*args, cfg)
    torch.testing.assert_close(Xk, Xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(Fk, Fp, atol=6e-3, rtol=0)
    torch.testing.assert_close(vk, vp, rtol=1e-3, atol=1e-6)
    _, t, vdw, x_init, ee, hip, amom = KD._compact_inputs(spec, *inputs)
    k3_in = (t, vdw, inputs[4], x_init, ee, hip, amom, m, KD.make_prep_consts(spec), cfg, H,
             spec.n_eff)
    K = cuda_fused.solve_from_state(*k3_in)
    P = cuda_fused.solve_from_state_plain(*k3_in)
    assert torch.equal(K[4], P[4]) and torch.equal(K[7], P[7])
    torch.testing.assert_close(K[5], P[5], atol=1e-5, rtol=0)
    torch.testing.assert_close(K[6], P[6], atol=1e-5, rtol=0)
    torch.testing.assert_close(K[0], P[0], atol=1e-4, rtol=0)
    torch.testing.assert_close(K[1], P[1], atol=6e-3, rtol=0)
    ik = workload.random_ik_problems(spec.model, spec.eff_frames, 16, spec.ik_hor, device)
    ik64 = tuple(a.double() if torch.is_tensor(a) else a for a in ik)
    one = cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,))
    xs, us, cost = cuda_ddp.solve_ik_batch(*ik, cfg=one)
    xs_p, us_p, cost_p = cuda_ddp.solve_ik_batch_plain(*ik64, cfg=one)
    torch.cuda.synchronize()
    torch.testing.assert_close(xs.double(), xs_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(us.double(), us_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(cost.double(), cost_p, rtol=1e-4, atol=0)


def test_go2_loop_per_episode_options_any_batch_size(device):
    """Two windows of the Go2 loop over the 40 rows of the stability sweep
    (per-episode gains, contact, swing_blend and force_gate, read inside the
    substep's CUDA graph): K1 and K2 launch once a window, and 17 of the
    rows, run alone and in reverse order, give the records of the same rows
    inside the 40-row call, bit for bit."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc.motions.go2_cyclic import trot_sim
    from bunmpc_tpu_torch.sim import controllers, physics, rollout
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    spec = workload.go2_spec("trot_sim")
    grid = workload.go2_sweep_grid()
    gains, sp, sb, fg = workload.go2_sweep_options(grid)
    start = workload.go2_settled_start(40, sim_params=sp, kp=gains.kp, kd=gains.kd)
    vd = torch.zeros((40, 3), device=device)
    vd[:, 0] = 0.3
    wd = torch.zeros(40, device=device)
    cfg = rollout.RolloutConfig(episode_length=100, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)

    def run(idx):
        def take(x):
            return x[idx].contiguous()

        p = physics.SimParams(contact=physics.ContactParams(
            foot_radius=take(sp.contact.foot_radius), kn=take(sp.contact.kn),
            dn=take(sp.contact.dn), mu=take(sp.contact.mu), kt=take(sp.contact.kt)),
            joint_damping=take(sp.joint_damping), torque_limit=take(sp.torque_limit))
        return rollout.rollout_mpc(
            spec, p, cfg, physics.SimState(take(start.q), take(start.v)), take(vd), take(wd),
            gains=controllers.IdControllerGains(kp=take(gains.kp), kd=take(gains.kd)),
            swing_blend=take(sb), force_gate=take(fg))

    before = (cuda_admm.KERNEL.launches, cuda_ddp.KERNEL.launches)
    full = run(torch.arange(40, device=device))
    assert (cuda_admm.KERNEL.launches, cuda_ddp.KERNEL.launches) == (before[0] + 2,
                                                                      before[1] + 2)
    idx = torch.arange(39, 5, -2, device=device)  # 17 rows, reversed
    part = run(idx)
    torch.cuda.synchronize()
    assert torch.isfinite(full.states).all()
    for name in ("states", "actions", "base", "contact_forces", "in_contact", "failed"):
        assert torch.equal(getattr(part, name), getattr(full, name)[idx]), name


def _k2_rows(args, per_block):
    """K2 launched directly with ``per_block`` problems a block (the
    wrapper picks the largest that fits): ``(xs, us, cost)``."""
    from bunmpc_tpu_torch.solvers import cuda_ddp

    model, eff, *rest = args
    a, keep, out = cuda_ddp.kernel_args(model, eff, *rest, cuda_ddp.CudaDdpConfig())
    stream = torch.cuda.current_stream().cuda_stream
    cuda_ddp.KERNELS[model.n_joints].launch("ddp_launch_f32", a + [per_block, stream],
                                            cuda_ddp.ARGTYPES + [cuda_ddp._I, cuda_ddp._P])
    torch.cuda.synchronize()
    return out


def _k2_ragged_and_block_sizes(args):
    """Rows of the whole batch at the wrapper's block size equal the rows of
    the first 5 and first 37 problems alone and of every smaller block size,
    bit for bit."""
    from bunmpc_tpu_torch.solvers import cuda_ddp

    model = args[0]
    H = args[-1].shape[1]
    fit = cuda_ddp.launch_per_block(H, model.nq, model.nv)
    full = cuda_ddp.solve_ik_batch(*args)
    for n in (5, 37):
        part = cuda_ddp.solve_ik_batch(*args[:2], *[a[:n].contiguous() for a in args[2:]])
        for a, b in zip(full, part):
            assert torch.equal(a[:n], b)
    for per_block in range(1, fit):
        for a, b in zip(full, _k2_rows(args, per_block)):
            assert torch.equal(a, b)
    return fit


@pytest.mark.parametrize("ik_hor", [10, 30])
def test_ddp_kernel_at_8_joints(device, ik_hor):
    """K2 built for 8 joints on the Solo8's random IK problems at B=512:
    one iteration with one alpha against the plain version in f64 (the
    gates of ``test_ddp_kernel_matches_plain``), the launch counted under 8
    joints, ragged batches and block sizes bit for bit."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.robots.solo8 import Solo8Config
    from bunmpc_tpu_torch.solvers import cuda_ddp

    model = Solo8Config.load_model()
    args = workload.random_ik_problems(model, tuple(Solo8Config.eff_names), B, ik_hor, device,
                                       q0=workload.solo8_q0())
    args64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    one = cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,))
    before = {nj: k.launches for nj, k in cuda_ddp.KERNELS.items()}
    xs, us, cost = cuda_ddp.solve_ik_batch(*args, cfg=one)
    assert {nj: k.launches for nj, k in cuda_ddp.KERNELS.items()} == {12: before[12],
                                                                     8: before[8] + 1}
    xs_p, us_p, cost_p = cuda_ddp.solve_ik_batch_plain(*args64, cfg=one)
    torch.cuda.synchronize()
    assert xs.shape == (B, ik_hor + 1, 29)
    torch.testing.assert_close(xs.double(), xs_p, atol=2e-4, rtol=0)
    torch.testing.assert_close(us.double(), us_p, atol=2e-3, rtol=0)
    torch.testing.assert_close(cost.double(), cost_p, rtol=1e-4, atol=0)
    fit = _k2_ragged_and_block_sizes(args)
    assert fit >= cuda_ddp.launch_per_block(ik_hor)  # 8 joints fit at least as many


def test_ddp_kernel_at_ik_h30(device):
    """K2 at 12 joints at the acyclic motions' longest IK horizon (stand, IK
    H 30: one problem a block) on the motion's own IK problems, built from
    K1's solve, at B=64: the full config against the plain version in f64 at
    phase 6's quantile gate, and ragged batches bit for bit."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import acyclic as AC
    from bunmpc_tpu_torch.mpc import ik as IK
    from bunmpc_tpu_torch.mpc.motions.solo12_acyclic import stand
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    spec = workload.acyclic_spec("stand")
    q, v, t = (torch.as_tensor(a, dtype=torch.float32, device=device)
               for a in workload.acyclic_states("stand", 64))
    pr = AC._prepare(spec, q, v, t)
    X = cuda_admm.solve(pr["plan"], spec.model.total_mass, pr["x_init"], pr["W"], pr["X_ref"],
                        pr["W_F"], pr["X_wm"], pr["F_wm"], pr["x_bounds"],
                        cuda_admm.CudaAdmmConfig(rho=stand.rho))[0]
    tasks = AC._ik_tasks(spec, pr, X)
    ws, wt, cw, xr = IK.dense_weights(spec.model, spec.eff_frames, tasks)
    args = (spec.model, spec.eff_frames, torch.cat([q, v], -1), tasks.ee_targets, tasks.com_ref,
            tasks.mom_ref, xr, ws, wt, cw, tasks.dts)
    assert tasks.dts.shape[1] == 30 and cuda_ddp.launch_per_block(30) == 1
    xs, us, cost = cuda_ddp.solve_ik_batch(*args)
    xs_p = cuda_ddp.solve_ik_batch_plain(*[a.double() if torch.is_tensor(a) else a
                                           for a in args])[0]
    d = (xs.double() - xs_p).abs().flatten()
    assert float(torch.quantile(d, 0.999)) < 5e-3 and float(d.max()) < 5e-2
    _k2_ragged_and_block_sizes(args)


@pytest.mark.parametrize("name", ("jump_fwd", "cartwheel", "rearing", "stand", "hifive",
                                  "rearing_jump"))
def test_acyclic_admm_kernel_matches_plain(device, name):
    """Every acyclic motion's K1 (H 20-30, per-knot contact plan, box and
    nominal state, no force reference) at B=16 with the reference schedule
    and 15 iterations against the plain version in f64 (X 1e-4, viol rtol
    1e-3; F 3e-3: on these draws the plain version's own f32 run lands up to
    9.8e-4 N from its f64 run, on hifive)."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import acyclic as AC
    from bunmpc_tpu_torch.mpc.motions.solo12_acyclic import MOTIONS
    from bunmpc_tpu_torch.solvers import cuda_admm

    spec = workload.acyclic_spec(name)
    q, v, t = (torch.as_tensor(a, dtype=torch.float32, device=device)
               for a in workload.acyclic_states(name, 16))
    pr = AC._prepare(spec, q, v, t)
    args = (pr["plan"], spec.model.total_mass, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"],
            pr["X_wm"], pr["F_wm"], pr["x_bounds"])
    cfg = cuda_admm.CudaAdmmConfig(rho=MOTIONS[name].rho, max_admm_iters=15, dual_relax=1.0,
                                   rho_growth=1.0)
    Xk, Fk, vk, _, _ = cuda_admm.solve(*args, cfg)
    plan = args[0]
    args64 = (type(plan)(cnt=plan.cnt.double(), r=plan.r.double(), dt=plan.dt.double()),
              args[1], *[a.double() for a in args[2:8]], tuple(a.double() for a in args[8]))
    Xp, Fp, vp, _, _ = cuda_admm.solve_plain(*args64, cfg)
    torch.testing.assert_close(Xk.double(), Xp, atol=1e-4, rtol=0)
    torch.testing.assert_close(Fk.double(), Fp, atol=3e-3, rtol=0)
    torch.testing.assert_close(vk.double(), vp, rtol=1e-3, atol=1e-6)
