"""The inputs the port is driven and measured with, made from a seed with
numpy: bench.py's batch of Solo12 trot states (and, per gait, the same batch
led by the gait's own check), the random IK problems of the JAX package's own
DDP kernel check (tests/test_pallas_ddp.py), and the closed loop's settled
standing start and command draw."""

from __future__ import annotations

import numpy as np
import torch

from .mpc import ik as IK
from .mpc import kino_dyn as KD
from .mpc.motions.solo12_cyclic import trot_sim
from .robots.solo12 import Solo12Config
from .sim import physics, rollout


def trot_states(n: int, seed: int = 0):
    """bench.py's inputs ``(q, v, t, v_des, w_des)`` as float64 numpy arrays:
    q0 with N(0, 0.05) joint offsets, N(0, 0.05) velocities, a uniform gait
    clock in [0, 0.5), commands v_des in [-0.3, 0.5] x [-0.2, 0.2] and yaw
    rates in [-0.3, 0.3]."""
    rng = np.random.default_rng(seed)
    q = np.tile(Solo12Config.q0(), (n, 1))
    q[:, 7:] += rng.normal(size=(n, 12)) * 0.05
    v = rng.normal(size=(n, 18)) * 0.05
    t = rng.uniform(0, 0.5, size=n)
    v_des = np.stack([rng.uniform(-0.3, 0.5, n), rng.uniform(-0.2, 0.2, n), np.zeros(n)], -1)
    w_des = rng.uniform(-0.3, 0.3, size=n)
    return q, v, t, v_des, w_des


# Each gait's command on its own check: the JAX package's where it solves the
# gait (tests/test_mpc.py:177-221: walk at vx 0.15, air_bound at vx 0.2,
# bound_turn at vx 0.2 and a yaw rate of 0.5); vx 0.2 elsewhere, with a yaw
# rate of 0.3 on the trot's turning variant and no motion for the stand-still.
GAIT_COMMANDS = {
    "trot": (0.2, 0.0), "trot_sim": (0.2, 0.0), "trot_turn": (0.2, 0.3), "jump": (0.2, 0.0),
    "bound": (0.2, 0.0), "bound_turn": (0.2, 0.5), "air_bound": (0.2, 0.0), "still": (0.0, 0.0),
    "gallop": (0.2, 0.0), "walk": (0.15, 0.0),
}


def gait_states(name: str, n: int, seed: int = 0):
    """``trot_states(n, seed)`` led by the gait's own check: problem 0 is
    Solo12's q0 at rest at t=0 with ``GAIT_COMMANDS[name]``."""
    q, v, t, v_des, w_des = trot_states(n, seed)
    vx, w = GAIT_COMMANDS[name]
    q[0], v[0], t[0], w_des[0] = Solo12Config.q0(), 0.0, 0.0, w
    v_des[0] = (vx, 0.0, 0.0)
    return q, v, t, v_des, w_des


def random_ik_problems(model, eff_frames, n: int, H: int, device):
    """The random IK problems of tests/test_pallas_ddp.py's full-size check
    (rng seed 3; distinct start states, shared random targets and weights) at
    batch n in float32, as the argument tuple of
    ``solvers/cuda_ddp.solve_ik_batch``."""
    rng = np.random.default_rng(3)
    dtype = torch.float32
    nv = model.nv

    def rep(a):
        a = np.asarray(a)
        return torch.as_tensor(np.broadcast_to(a, (n,) + a.shape).copy(), dtype=dtype,
                               device=device)

    def vec(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    x_reg = np.concatenate([Solo12Config.q0(), np.zeros(nv)])
    tasks = IK.IkTasks(
        ee_targets=rep(rng.normal(size=(H, 4, 3)) * 0.1),
        ee_wts=rep(rng.uniform(0.5, 2.0, size=(H, 4))),
        com_ref=rep(rng.normal(size=(H + 1, 3)) * 0.05),
        mom_ref=rep(rng.normal(size=(H + 1, 6)) * 0.05),
        com_wt=3.0, mom_wt=2.0,
        state_wt=vec(rng.uniform(0.1, 1.0, size=2 * nv)),
        x_reg=vec(x_reg),
        reg_wt_state=0.7, reg_wt_ctrl=1e-4,
        ctrl_wt=vec(rng.uniform(0.1, 1.0, size=nv)),
        dts=rep(np.full(H, 0.05)),
    )
    q0 = np.tile(Solo12Config.q0(), (n, 1))
    q0[:, 7:] += rng.normal(size=(n, 12)) * 0.03
    x0 = vec(np.concatenate([q0, rng.normal(size=(n, nv)) * 0.05], 1))
    w_stage, w_term, ctrl_w, xr = IK.dense_weights(model, eff_frames, tasks)
    return (model, eff_frames, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, xr, w_stage,
            w_term, ctrl_w, tasks.dts)


def closed_loop_sim_params():
    """The simulator the walking trot (``trot_sim``) is validated on: the
    default SimParams with contact kn=1e4, dn=500, kt=500."""
    return physics.SimParams(contact=physics.ContactParams(kn=1e4, dn=500.0, kt=500.0))


def settled_start(n: int, device="cuda", dtype=torch.float32):
    """The closed loop's start: Solo12's q0 PD-held for 500 ms
    (``rollout.settle_state`` at trot_sim's gains on the closed-loop
    simulator), as n copies of one state on ``device``."""
    device = KD.resolve_device(device)
    model = Solo12Config.load_model()
    s0 = physics.SimState(
        q=torch.as_tensor(Solo12Config.q0()[None], dtype=dtype, device=device),
        v=torch.zeros((1, model.nv), dtype=dtype, device=device),
    )
    s = rollout.settle_state(model, tuple(Solo12Config.eff_names), closed_loop_sim_params(), s0,
                             trot_sim.kp, trot_sim.kd)
    return physics.SimState(q=s.q.expand(n, -1).contiguous(), v=s.v.expand(n, -1).contiguous())


def command_draw(n: int, seed: int = 0):
    """Commands of the reference envelope (the data-collection config's
    vx_range [0, 0.3], vy_range and w_range [0, 0]): ``(v_des (n, 3),
    w_des (n,))`` as float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    v_des = np.zeros((n, 3))
    v_des[:, 0] = rng.uniform(0.0, 0.3, n)
    return v_des, np.zeros(n)
