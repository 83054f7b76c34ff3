"""Solo12 cyclic gait parameter sets.

Copy of the tables of ``bunmpc_tpu/mpc/motions/solo12_cyclic.py``: numeric
twins of the reference gait definitions (reference
examples/motions/cyclic/solo12_trot.py:13-75, solo12_jump.py,
solo12_bound.py, solo12_wip.py) — the tunable MPC parameters the Bayesian
layer searches over — and ``trot_sim``, the trot's variant that walks in the
soft-contact simulator. ``GAITS`` registers all ten by name.
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


trot_turn = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="trot_turn",
    gait_period=0.5,
    stance_percent=(0.6, 0.6, 0.6, 0.6),
    gait_dt=0.05,
    phase_offset=(0.0, 0.4, 0.4, 0.0),
    step_ht=0.05,
    state_wt=_state_wt([0.0, 0.0, 10.0], [1000.0, 1000.0, 10.0], 1.0, [0.0] * 3, [100.0, 100.0, 10.0], 0.5),
    ctrl_wt=np.array([0.0, 0.0, 1000.0] + [5e2] * 3 + [1.0] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(0.0, 5e2),
    reg_wt=(5e-2, 1e-5),
    W_X=np.array([1e-5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e4, 1e4, 1e4]),
    W_X_ter=10.0 * np.array([1e5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5]),
    W_F=np.array([1e1, 1e1, 1e1] * 4),
    rho=5e4,
    ori_correction=(0.0, 0.5, 0.4),
    gait_horizon=1.0,
    nom_ht=0.2,
    kp=3.0,
    kd=0.05,
)


# Jump gait (reference examples/motions/cyclic/solo12_jump.py:13-46)
jump = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="jump",
    gait_period=0.5,
    stance_percent=(0.3, 0.3, 0.3, 0.3),
    gait_dt=0.05,
    phase_offset=(0.7, 0.7, 0.7, 0.7),
    step_ht=0.05,
    state_wt=_state_wt([0.0, 0.0, 10.0], [1000.0] * 3, 1.0, [0.0] * 3, [100.0] * 3, 0.5),
    ctrl_wt=np.array([0.0, 0.0, 1000.0] + [5e2] * 3 + [1.0] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(0.0, 5e2),
    reg_wt=(5e-2, 1e-5),
    W_X=np.array([1e-5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e4, 1e4, 1e4]),
    W_X_ter=10.0 * np.array([1e5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5]),
    W_F=np.array([1e1, 1e1, 1.5e1] * 4),
    rho=5e4,
    ori_correction=(0.2, 0.5, 0.4),
    gait_horizon=3.0,
    nom_ht=0.25,
    kp=2.5,
    kd=0.08,
)


# Bound gait (reference examples/motions/cyclic/solo12_bound.py:13-46)
bound = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="bound",
    gait_period=0.3,
    stance_percent=(0.5, 0.5, 0.5, 0.5),
    gait_dt=0.05,
    phase_offset=(0.0, 0.0, 0.5, 0.5),
    step_ht=0.07,
    state_wt=_state_wt([0.0, 0.0, 1e3], [10.0, 10.0, 10.0], 50.0, [0.0] * 3, [100.0, 10.0, 100.0], 0.5),
    ctrl_wt=np.array([0.5, 0.5, 0.5] + [1.0] * 3 + [0.5] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(5e1, 5e2),
    reg_wt=(7e-3, 7e-5),
    W_X=np.array([1e-5, 1e-5, 5e4, 1e1, 1e1, 1e3, 5e3, 1e4, 5e3]),
    W_X_ter=10.0 * np.array([1e-5, 1e-5, 5e4, 1e1, 1e1, 1e3, 1e4, 1e4, 1e4]),
    W_F=np.array([1e1, 1e1, 1.5e1] * 4),
    rho=5e4,
    ori_correction=(0.2, 0.8, 0.8),
    gait_horizon=4.0,
    nom_ht=0.25,
    kp=3.0,
    kd=0.05,
)


# Bound with turning (reference examples/motions/cyclic/solo12_bound.py:49-81):
# same contact pattern as bound, but a short 1-period horizon and a softened
# yaw-rate tracking weight (base_w z 10 instead of 100) so the yaw-momentum
# command dominates.
bound_turn = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="bound_turn",
    gait_period=0.3,
    stance_percent=(0.5, 0.5, 0.5, 0.5),
    gait_dt=0.05,
    phase_offset=(0.0, 0.0, 0.5, 0.5),
    step_ht=0.07,
    state_wt=_state_wt([0.0, 0.0, 1e3], [10.0, 10.0, 10.0], 50.0, [0.0] * 3, [100.0, 10.0, 10.0], 0.5),
    ctrl_wt=np.array([0.5, 0.5, 0.5] + [1.0] * 3 + [0.5] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(5e1, 5e2),
    reg_wt=(7e-3, 7e-5),
    W_X=np.array([1e-5, 1e-5, 5e4, 1e1, 1e1, 1e3, 5e3, 1e4, 5e3]),
    W_X_ter=10.0 * np.array([1e-5, 1e-5, 5e4, 1e1, 1e1, 1e3, 1e4, 1e4, 1e4]),
    W_F=np.array([1e1, 1e1, 1.5e1] * 4),
    rho=5e4,
    ori_correction=(0.2, 0.8, 0.8),
    gait_horizon=1.0,
    nom_ht=0.25,
    kp=3.0,
    kd=0.05,
)


# Air bound (reference examples/motions/cyclic/solo12_bound.py:84-120):
# 0.4 stance percent opens a full flight phase between front/rear pairs;
# heavier vertical force weight (W_F z 3e1). The reference's "modified"
# cent_wt there is the per-dimension expansion [3*[5e1], 6*[5e2]] of the
# same (com, mom) = (5e1, 5e2) scalars used here.
air_bound = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="air_bound",
    gait_period=0.3,
    stance_percent=(0.4, 0.4, 0.4, 0.4),
    gait_dt=0.05,
    phase_offset=(0.0, 0.0, 0.5, 0.5),
    step_ht=0.07,
    state_wt=_state_wt([0.0, 0.0, 1e3], [10.0, 10.0, 10.0], 50.0, [0.0] * 3, [100.0, 10.0, 100.0], 0.5),
    ctrl_wt=np.array([0.5, 0.5, 0.5] + [1.0] * 3 + [0.5] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(5e1, 5e2),
    reg_wt=(7e-3, 7e-5),
    W_X=np.array([1e-5, 1e-5, 5e4, 1e1, 1e1, 1e3, 5e3, 1e4, 5e3]),
    W_X_ter=10.0 * np.array([1e-5, 1e-5, 5e4, 1e1, 1e1, 1e3, 1e4, 1e4, 1e4]),
    W_F=np.array([1e1, 1e1, 3e1] * 4),
    rho=5e4,
    ori_correction=(0.2, 0.8, 0.8),
    gait_horizon=2.0,
    nom_ht=0.25,
    kp=3.0,
    kd=0.05,
)


# Stand-still / gallop / walk gaits (reference examples/motions/cyclic/
# solo12_wip.py:13-113; that file's stray `plan.sim_dt` line references an
# undefined name and is not reproduced).
still = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="still",
    gait_period=0.5,
    stance_percent=(1.0, 1.0, 1.0, 1.0),
    gait_dt=0.05,
    phase_offset=(0.0, 0.4, 0.4, 0.0),
    step_ht=0.13,
    state_wt=_state_wt([0.0, 0.0, 10.0], [1000.0] * 3, 1.0, [0.0] * 3, [100.0] * 3, 0.5),
    ctrl_wt=np.array([0.0, 0.0, 1000.0] + [5e2] * 3 + [1.0] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(0.0, 5e2),
    reg_wt=(5e-2, 1e-5),
    W_X=np.array([1e-5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e4, 1e4, 1e4]),
    W_X_ter=10.0 * np.array([1e5, 1e5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5]),
    W_F=np.array([1e1, 1e1, 1e1] * 4),
    rho=5e4,
    ori_correction=(0.4, 0.5, 0.4),
    gait_horizon=2.0,
    nom_ht=0.26,
    kp=3.0,
    kd=0.1,
)


gallop = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="gallop",
    gait_period=0.5,
    stance_percent=(0.35, 0.35, 0.35, 0.35),
    gait_dt=0.05,
    phase_offset=(0.0, 0.80, 0.70, 0.5),
    step_ht=0.08,
    state_wt=np.array(
        [0.0, 0.0, 10.0] + [5000.0] * 3 + [0.0, 60.0, 60.0] * 4
        + [0.0, 0.0, 0.0] + [1000.0] * 3 + [30.0, 30.0, 30.0] * 4
    ),
    ctrl_wt=np.array([0.0, 0.0, 1000.0] + [5e2] * 3 + [1.0] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(5e3, 5e3),
    reg_wt=(5e-2, 1e-5),
    W_X=np.array([1e-5, 1e-5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5]),
    W_X_ter=10.0 * np.array([1e5, 1e5, 1e5, 1e1, 1e1, 2e2, 1e5, 1e5, 1e5]),
    W_F=np.array([1e1, 1e1, 1e1] * 4),
    rho=5e4,
    ori_correction=(0.6, 0.6, 0.4),
    gait_horizon=2.0,
    nom_ht=0.26,
    kp=3.5,
    kd=0.1,
)


walk = BiconvexMotionParams(
    robot_name="solo12",
    motion_name="walk",
    gait_period=0.6,
    stance_percent=(0.8, 0.8, 0.8, 0.8),
    gait_dt=0.05,
    phase_offset=(0.6, 0.0, 0.2, 0.8),
    step_ht=0.05,
    state_wt=_state_wt([0.0, 0.0, 1000.0], [1e3] * 3, 0.5, [0.0] * 3, [50.0] * 3, 1e-2),
    ctrl_wt=np.array([1.0, 1.0, 10.0] + [10.0, 10.0, 20.0] + [5e-3] * _NJ),
    swing_wt=(1e4, 1e4),
    cent_wt=(5e1, 5e2),
    reg_wt=(5e-3, 7e-3),
    W_X=np.array([1e-5, 1e-5, 1e5, 1e2, 1e2, 1e2, 5e3, 5e3, 5e3]),
    W_X_ter=10.0 * np.array([1e-5, 1e-5, 1e5, 1e2, 1e2, 1e2, 1e3, 1e3, 1e3]),
    W_F=np.array([1e1, 1e1, 1e1] * 4),
    rho=5e4,
    ori_correction=(0.2, 0.4, 0.5),
    gait_horizon=0.5,
    nom_ht=0.24,
    kp=3.5,
    kd=0.15,
)


# The walking closed-loop variant: the reference's soft PD gains (kp=3,
# kd=0.05) roll the robot over on the implicit soft-contact simulator, and
# W_F=1e1 sinks the plan's CoM below nominal; with kp=12, kd=0.5, W_F x0.1
# and ContactParams(kn=1e4, dn=500, kt=500) it walks (the JAX package's
# sweep, artifacts/stability_sweep_solo12_wf01.json).
trot_sim = dataclasses.replace(trot, motion_name="trot_sim", kp=12.0, kd=0.5, W_F=trot.W_F * 0.1)


GAITS = {
    "trot": trot,
    "trot_sim": trot_sim,
    "trot_turn": trot_turn,
    "jump": jump,
    "bound": bound,
    "bound_turn": bound_turn,
    "air_bound": air_bound,
    "still": still,
    "gallop": gallop,
    "walk": walk,
}
