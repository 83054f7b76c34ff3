"""Solo12 cyclic gait parameter sets.

Copy of the ``trot`` and ``trot_sim`` tables of
``bunmpc_tpu/mpc/motions/solo12_cyclic.py``: ``trot`` is the numeric twin of
the reference gait (reference examples/motions/cyclic/solo12_trot.py:13-75),
``trot_sim`` its variant that walks in the soft-contact simulator.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .params import BiconvexMotionParams

_NJ = 12  # Solo12 actuated joints; nv = 18


def _state_wt(base_pos, base_ori, joints_q, base_vel, base_w, joints_v):
    return np.array(
        list(base_pos) + list(base_ori) + [joints_q] * _NJ
        + list(base_vel) + list(base_w) + [joints_v] * _NJ
    )


trot = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="trot",
    gait_period=0.5,
    stance_percent=(0.6, 0.6, 0.6, 0.6),
    gait_dt=0.05,
    phase_offset=(0.0, 0.5, 0.5, 0.0),
    step_ht=0.075,
    state_wt=_state_wt([0.0, 0.0, 10.0], [1000.0] * 3, 1.0, [0.0] * 3, [100.0] * 3, 0.5),
    ctrl_wt=np.array([0.0, 0.0, 1000.0] + [5e2] * 3 + [1.0] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(0.0, 5e2),
    reg_wt=(5e-2, 1e-5),
    W_X=np.array([1e-5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e4, 1e4, 1e4]),
    W_X_ter=10.0 * np.array([1e5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5]),
    W_F=np.array([1e1, 1e1, 1e1] * 4),
    rho=5e4,
    ori_correction=(0.3, 0.5, 0.4),
    gait_horizon=2.0,
    nom_ht=0.2,
    kp=3.0,
    kd=0.05,
)


# The walking closed-loop variant: the reference's soft PD gains (kp=3,
# kd=0.05) roll the robot over on the implicit soft-contact simulator, and
# W_F=1e1 sinks the plan's CoM below nominal; with kp=12, kd=0.5, W_F x0.1
# and ContactParams(kn=1e4, dn=500, kt=500) it walks (the JAX package's
# sweep, artifacts/stability_sweep_solo12_wf01.json).
trot_sim = dataclasses.replace(trot, motion_name="trot_sim", kp=12.0, kd=0.5, W_F=trot.W_F * 0.1)
