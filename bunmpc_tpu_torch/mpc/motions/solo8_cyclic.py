"""Solo8 cyclic gait parameter set (copy of
``bunmpc_tpu/mpc/motions/solo8_cyclic.py``).

The reference supports the Solo8 robot (robot_properties_solo solo8wrapper.py,
config.py:73-138) but ships no solo8 motion files — its motion library is
Solo12/Go2 only. This trot is the framework's extension of the solo12 trot
weights (solo12_trot.py:13-43) to the 8-joint topology: identical dynamics
weights (same mass/leg geometry — Solo8 is Solo12 without the HAA joints),
IK weight vectors resized to nj=8.
"""

from __future__ import annotations

import numpy as np

from .params import BiconvexMotionParams

_NJ = 8  # Solo8 actuated joints; nv = 14


def _state_wt(base_pos, base_ori, joints_q, base_vel, base_w, joints_v):
    return np.array(
        list(base_pos) + list(base_ori) + [joints_q] * _NJ
        + list(base_vel) + list(base_w) + [joints_v] * _NJ
    )


trot = BiconvexMotionParams(
    robot_name="solo8",
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

GAITS = {"trot": trot}
