"""K4, the closed loop's substep kernel (``csrc/substep.cu``, wrapper
``bunmpc_tpu_torch/sim/cuda_substep.py``), on the CPU.

* The g++ build of K4's per-episode math (``_build.build_host``, built once
  for the file) in float64 against the plain ``rollout._substep`` at B=4 for
  Solo12, the Go2 and Solo8, over the option sets (every one on Solo12):
  none; sensor bias with a push; terrain; swing_blend with force_gate;
  per-episode (B,) contact, damping, limit and gains; the torque and
  structured action encodings.
  Every case starts past the failure predicate's grace period, with one
  episode tilted past the fail angle (it fails when the grace period ends,
  inside the window, and is frozen from there) and one whose plan is bad (it
  is frozen from the first step). Every buffer within 1e-10 after one step
  and 1e-8 after a 50-step window; flags, failure steps and contacts equal.
* The wrapper: the layout size against the C one; wrong dtype, device,
  shape or a non-contiguous buffer raise; on CPU tensors ``rollout_mpc``
  takes the plain substep and never builds K4.
"""

import ctypes

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu_torch import workload
from bunmpc_tpu_torch.kin import algorithms as K
from bunmpc_tpu_torch.mpc import kino_dyn as KD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
from bunmpc_tpu_torch.robots.go2 import Go2Config
from bunmpc_tpu_torch.robots.solo12 import Solo12Config
from bunmpc_tpu_torch.sim import controllers, cuda_substep, physics
from bunmpc_tpu_torch.sim import rollout as R
from bunmpc_tpu_torch.solvers import biconvex, ddp
from torch_port_helpers import host_lib

F64 = torch.float64
B = 4
K0 = 480  # the first step: the grace period (500 steps) ends inside the window
STEPS = 50
OPTIONS = ("none", "bias_push", "terrain", "swing_gate", "per_episode", "torque", "structured")
# every option set on Solo12; on the Go2 those its loops run (11b, 11c), on
# Solo8 the 8-joint build's own shapes (the file stays near 30 s)
CASES = ([("solo12", o) for o in OPTIONS]
         + [("go2", o) for o in ("none", "bias_push", "swing_gate", "per_episode")]
         + [("solo8", o) for o in ("none", "terrain", "structured")])


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host_lib("substep", tmp_path_factory)


def robot(name):
    """The robot's spec (on the CPU) and its standing configuration."""
    if name == "solo12":
        return (KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0(),
                                    device="cpu"), Solo12Config.q0())
    if name == "go2":
        return workload.go2_spec("trot_sim", device="cpu"), Go2Config.q0()
    return workload.solo8_spec("trot", device="cpu"), workload.solo8_q0()


def substep_args(name, option, seed=0, dtype=F64, device="cpu", batch=B):
    """``rollout._substep``'s arguments for one window of ``batch`` episodes
    on ``device``: feet 1 mm into the ground, a plan near the state, and the
    option set."""
    B = batch
    spec, q0 = robot(name)
    m = spec.model
    rng = np.random.default_rng(seed)
    q0 = np.array(q0, np.float64)
    feet = K.frame_positions(m, torch.as_tensor(q0)[None], spec.eff_frames)[0, :, 2].numpy()
    q0[2] -= feet.min() - 0.017
    q = np.tile(q0, (B, 1))
    q[:, 7:] += rng.normal(size=(B, m.n_joints)) * 0.02
    q[:, 0:3] += rng.normal(size=(B, 3)) * 0.001
    half = np.radians(40.0) / 2  # episode 1 tilted past the fail angle
    q[1, 3:7] = (np.sin(half), 0.0, 0.0, np.cos(half))
    v = rng.normal(size=(B, m.nv)) * 0.05
    action_type = option if option in ("torque", "structured") else "pd_target"
    cfg = R.RolloutConfig(episode_length=K0 + 2 * STEPS, kp=3.0, kd=0.05, action_type=action_type)
    b = R._make_buffers(spec, cfg, torch.as_tensor(q, dtype=dtype, device=device),
                        torch.as_tensor(v, dtype=dtype, device=device))
    n_int, nx = spec.n_int, m.nq + m.nv
    xs = np.concatenate([q, v], 1)[:, None].repeat(n_int, 1) + rng.normal(size=(B, n_int, nx)) * 0.01
    f = np.zeros((B, n_int, 4, 3))
    f[..., 2] = m.total_mass * 9.81 / 4
    f += rng.normal(size=f.shape) * 0.3
    for buf, x in ((b.xs_int, xs), (b.us_int, rng.normal(size=(B, n_int, m.nv)) * 0.1),
                   (b.f_int, f.reshape(B, n_int, 12)), (b.sim_t, rng.uniform(0, 1, B))):
        buf.copy_(torch.as_tensor(x))
    b.k.fill_(K0)
    b.mpc_bad[2] = True
    sp = workload.closed_loop_sim_params()
    gains = controllers.IdControllerGains(kp=12.0, kd=0.5)
    opts, push = R._LoopOptions(), None

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    if option == "bias_push":
        opts = opts._replace(q_noise=t(rng.normal(size=(B, m.nq)) * 0.01),
                             v_noise=t(rng.normal(size=(B, m.nv)) * 0.05))
        push = t(rng.normal(size=(B, cfg.episode_length, 3)) * 3.0)
    elif option == "terrain":
        opts = opts._replace(terrain=physics.Terrain(t(rng.normal(size=(40, 40)) * 0.005),
                                                     origin=(-1.0, -1.0), cell=0.05))
    elif option == "swing_gate":
        opts = opts._replace(swing_blend=t(rng.uniform(0, 1, B)), force_gate=t(rng.uniform(0, 1, B)),
                             leg_mask=t(R.leg_joint_mask(m, spec.eff_frames)))
        b.prev_cnt.copy_(torch.as_tensor(rng.uniform(size=(B, 4)) > 0.5))
    elif option == "per_episode":
        sp = R._sim_params_on(physics.SimParams(
            contact=physics.ContactParams(
                kn=rng.uniform(5e3, 2e4, B), dn=rng.uniform(200, 600, B),
                kt=rng.uniform(200, 600, B), mu=rng.uniform(0.5, 1.0, B),
                foot_radius=rng.uniform(0.017, 0.019, B)),
            joint_damping=rng.uniform(0.01, 0.05, B), torque_limit=rng.uniform(1.0, 3.0, B)),
            B, b.q)
        gains = controllers.IdControllerGains(kp=t(rng.uniform(5, 15, B)),
                                              kd=t(rng.uniform(0.2, 0.6, B)))
    v_des, w_des = t(rng.normal(size=(B, 3)) * 0.2), t(rng.normal(size=B) * 0.1)
    step0 = t(rng.uniform(0, 300, B))
    return spec, sp, cfg, gains, v_des, w_des, step0, push, opts, b


def clone(b):
    return R._Buffers(*[x.clone() if torch.is_tensor(x) else x for x in b])


def gaps(a, b):
    """Largest |difference| of every float buffer; mismatches of the others."""
    out = {}
    for name in R._Buffers._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            continue
        if x.is_floating_point():
            out[name] = float((x - y).abs().max())
        else:
            out[name] = int((x != y).sum())
    return out


@pytest.mark.parametrize("name, option", CASES)
def test_kernel_math_matches_the_plain_substep(lib, name, option):
    args = substep_args(name, option)
    plain, kern = clone(args[-1]), clone(args[-1])
    nj, ptrs, scal, ints, keep = cuda_substep.kernel_args(*args[:-1], kern)
    fn = lib.substep_host_f64
    fn.argtypes, fn.restype = cuda_substep.ARGTYPES, ctypes.c_int
    for step in range(STEPS):
        R._substep(*args[:-1], plain)
        assert fn(nj, ctypes.addressof(ptrs), ctypes.addressof(scal), ctypes.addressof(ints)) == 0
        if step == 0:
            one = gaps(plain, kern)
            assert max(one.values()) <= 1e-10, one
    window = gaps(plain, kern)
    assert max(window.values()) <= 1e-8, window
    assert int(plain.k) == K0 + STEPS and int(plain.i) == STEPS
    # the cases reach what they are meant to: contacts, failures, the freeze
    assert bool(plain.in_contact[:, K0:].any())
    assert bool(plain.failed[1]) and bool(plain.failed[2])
    assert int(plain.fail_step[1]) == 501 and int(plain.fail_step[2]) == K0
    assert torch.equal(plain.q[2], args[-1].q[2])


def test_layout_size_matches_the_kernel(lib):
    for nj in cuda_substep.JOINT_COUNTS:
        assert lib.substep_work_size(nj) == cuda_substep.work_size(nj)
    assert lib.substep_work_size(10) == -1
    # four episodes a block fit the 48 KB a launch gets without an opt-in
    assert cuda_substep.per_block(12) == cuda_substep.PER_BLOCK


@pytest.mark.parametrize("fault", ("dtype", "shape", "contiguous", "device", "push"))
def test_wrapper_refuses_buffers_it_cannot_read(fault):
    spec, sp, cfg, gains, v_des, w_des, step0, push, opts, b = substep_args("solo12", "none")
    if fault == "dtype":
        b = b._replace(sim_t=b.sim_t.float())
    elif fault == "shape":
        b = b._replace(prev_cnt=b.prev_cnt[:, :3])
    elif fault == "contiguous":
        b = b._replace(v=b.v.t().contiguous().t())
    elif fault == "push":
        push = torch.zeros((B, 3, cfg.episode_length), dtype=F64).transpose(1, 2)
    if fault == "device":  # a CPU tensor: only the plain version runs there
        with pytest.raises(ValueError, match="CUDA device"):
            cuda_substep.Launch(spec, sp, cfg, gains, v_des, w_des, step0, push, opts, b)
        return
    with pytest.raises(ValueError, match="K4"):
        cuda_substep.kernel_args(spec, sp, cfg, gains, v_des, w_des, step0, push, opts, b)


def test_cpu_rollout_takes_the_plain_substep(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("K4 built for CPU tensors")

    monkeypatch.setattr(cuda_substep, "Launch", type("Refused", (), {"__init__": refuse}))
    spec, q0 = robot("solo12")
    n = 2
    state0 = physics.SimState(q=torch.as_tensor(q0, dtype=F64).expand(n, -1).contiguous(),
                              v=torch.zeros((n, spec.model.nv), dtype=F64))
    cfg = R.RolloutConfig(episode_length=20, plan_freq=0.01, kp=trot_sim.kp, kd=trot_sim.kd)
    res = R.rollout_mpc(spec, workload.closed_loop_sim_params(), cfg, state0,
                        torch.zeros((n, 3), dtype=F64), torch.zeros(n, dtype=F64),
                        admm_cfg=biconvex.BiconvexConfig(rho=trot_sim.rho, max_admm_iters=4),
                        ddp_cfg=ddp.DdpConfig(n_iters=1), admm_backend="torch", ik_backend="torch")
    assert res.states.shape[:2] == (n, cfg.episode_length)
    assert bool(torch.isfinite(res.states).all())
