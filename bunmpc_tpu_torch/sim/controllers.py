"""Whole-body inverse-dynamics controller (the 1 kHz low level).

Counterpart of ``bunmpc_tpu/sim/controllers.py`` (reference
examples/controllers/robot_id_controller.py:12-86): RNEA feed-forward
torque minus the J^T contact-force compensation, plus joint PD feedback.
Batched over leading dimensions.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kin import algorithms as K
from ..robots.model import RobotModel
from .physics import per_robot


@dataclasses.dataclass(frozen=True)
class IdControllerGains:
    """PD gains: floats for the whole batch, or (B,) tensors per episode
    (the JAX package's ``vmap`` over gains)."""

    kp: float
    kd: float


def id_joint_torques(
    model: RobotModel,
    eff_frames,
    gains: IdControllerGains,
    q,  # (..., nq) measured
    v,  # (..., nv) measured
    q_des,
    v_des,
    a_des,  # (..., nv) desired acceleration (IK us)
    f_ff,  # (..., n_eff*3) feed-forward contact forces
    f_scale=None,  # optional (..., n_eff) per-leg force-compensation scale
):
    """``(tau_ff, tau_fb)``, each (..., n_joints), split as in the reference
    (robot_id_controller.py:57-86): tau_ff from the desired-state RNEA and
    the force compensation, tau_fb from the measured-state PD. ``f_scale``
    scales each leg's J^T f_ff term; None applies every force."""
    kin = K.body_velocities(model, q_des, v_des)
    tau_id = K.rnea_from_kin(model, kin, v_des, a_des)  # (..., nv)
    R, p = kin[2], kin[3]
    tau_eff = torch.zeros_like(tau_id)
    for j, name in enumerate(eff_frames):
        J = K.frame_jacobian(model, q_des, name, R=R, p=p)  # (..., 3, nv)
        fj = f_ff[..., 3 * j : 3 * (j + 1)]
        if f_scale is not None:
            fj = fj * f_scale[..., j : j + 1]
        tau_eff = tau_eff + K._mv(J.transpose(-1, -2), fj)
    tau_ff = (tau_id - tau_eff)[..., 6:]
    kp, kd = per_robot(gains.kp), per_robot(gains.kd)
    tau_fb = -kp * (q[..., 7:] - q_des[..., 7:]) - kd * (v[..., 6:] - v_des[..., 6:])
    return tau_ff, tau_fb
