"""The inputs the port is driven and measured with, made from a seed with
numpy: bench.py's batch of Solo12 trot states, and the random IK problems of
the JAX package's own DDP kernel check (tests/test_pallas_ddp.py)."""

from __future__ import annotations

import numpy as np
import torch

from .mpc import ik as IK
from .robots.solo12 import Solo12Config


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
