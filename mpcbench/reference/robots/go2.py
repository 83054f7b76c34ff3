"""Unitree Go2 robot description (copy of ``bunmpc_tpu/robots/go2.py``; the
constants load from the committed ``robots/assets/go2_model.npz``,
byte-identical to the JAX package's).

``build_go2_model`` builds the same model from the xacro constants of the
reference's ``robot_properties_go2`` (const.xacro, leg.xacro,
go2.urdf.xacro): trunk + 4 legs x (hip-x, thigh-y, calf-y) with the leg
macro's left/right mirror and front/hind sign flips. The end-effector order
is FR, FL, RR, RL: the first foot sits at -y, where Solo12's first (FL)
sits at +y.
"""

from __future__ import annotations

import os

import numpy as np

from .assets_io import load_model
from .model import Frame, RobotModel, compose_inertia


_ASSET = os.path.join(os.path.dirname(__file__), "assets", "go2_model.npz")

# --- xacro constants (const.xacro:25-120) ---
_LEG_OFFSET_X = 0.1934
_LEG_OFFSET_Y = 0.0465
_HIP_OFFSET = 0.0955  # thigh joint lateral offset from the hip
_THIGH_LENGTH = 0.213
_CALF_LENGTH = 0.213
_FOOT_RADIUS = 0.02

_TRUNK = dict(
    mass=6.921,
    com=np.array([0.021112, 0.0, -0.005366]),
    I=np.array(
        [
            [0.02448, 0.00012166, 0.0014849],
            [0.00012166, 0.098077, -3.12e-05],
            [0.0014849, -3.12e-05, 0.107],
        ]
    ),
)
_HIP = dict(
    mass=0.678,
    com=np.array([-0.0054, 0.00194, -0.000105]),
    I=np.array(
        [
            [0.00048, -3.01e-06, 1.11e-06],
            [-3.01e-06, 0.000884, -1.42e-06],
            [1.11e-06, -1.42e-06, 0.000596],
        ]
    ),
)
_THIGH = dict(
    mass=1.152,
    com=np.array([-0.00374, -0.0223, -0.0327]),
    I=np.array(
        [
            [0.00584, 8.72e-05, -0.000289],
            [8.72e-05, 0.0058, 0.000808],
            [-0.000289, 0.000808, 0.00103],
        ]
    ),
)
_CALF = dict(
    mass=0.154,
    com=np.array([0.00548, -0.000975, -0.115]),
    I=np.array(
        [
            [0.00108, 3.4e-07, 1.72e-05],
            [3.4e-07, 0.0011, 8.28e-06],
            [1.72e-05, 8.28e-06, 3.29e-05],
        ]
    ),
)
_FOOT_MASS = 0.06
_FOOT_I = (2 * _FOOT_MASS / 5.0) * _FOOT_RADIUS**2 * np.eye(3)

# joint limits (const.xacro:53-66)
_LIMITS = {
    "hip": (-1.0472, 1.0472, 30.1, 23.7),
    "thigh": (-1.5708, 3.4907, 30.1, 23.7),
    "calf": (-2.7227, -0.83776, 20.06, 35.55),
}

# leg instantiation order and signs (go2.urdf.xacro:129-132)
_LEGS = [("FR", -1, 1), ("FL", 1, 1), ("RR", -1, -1), ("RL", 1, -1)]


def _signed(base: dict, mirror: int, front_hind: int, kind: str):
    """Apply the leg macro's mirror/front-hind sign flips (leg.xacro:60-107)."""
    m, fh = mirror, front_hind
    com = base["com"].copy()
    I = base["I"].copy()
    if kind == "hip":
        com = com * np.array([fh, m, 1.0])
        signs = np.array([[1, m * fh, fh], [m * fh, 1, m], [fh, m, 1]])
    elif kind == "thigh":
        com = com * np.array([1.0, m, 1.0])
        signs = np.array([[1, m, 1], [m, 1, m], [1, m, 1]])
    else:  # calf: no mirroring
        signs = np.ones((3, 3))
    return base["mass"], com, I * signs


def build_go2_model() -> RobotModel:
    parent, joint_rot, joint_pos, axis, names, limits = [], [], [], [], [], []
    masses = [_TRUNK["mass"]]
    coms = [_TRUNK["com"].copy()]
    inertias = [_TRUNK["I"].copy()]
    frames = {}
    eye = np.eye(3)

    for leg, mirror, front_hind in _LEGS:
        hip_body = len(masses)
        parent.append(0)
        joint_rot.append(eye.copy())
        joint_pos.append(np.array([front_hind * _LEG_OFFSET_X, mirror * _LEG_OFFSET_Y, 0.0]))
        axis.append(np.array([1.0, 0.0, 0.0]))
        names.append(f"{leg}_hip_joint")
        limits.append(_LIMITS["hip"])
        m, c, I = _signed(_HIP, mirror, front_hind, "hip")
        masses.append(m)
        coms.append(c)
        inertias.append(I)

        thigh_body = len(masses)
        parent.append(hip_body)
        joint_rot.append(eye.copy())
        joint_pos.append(np.array([0.0, mirror * _HIP_OFFSET, 0.0]))
        axis.append(np.array([0.0, 1.0, 0.0]))
        names.append(f"{leg}_thigh_joint")
        limits.append(_LIMITS["thigh"])
        m, c, I = _signed(_THIGH, mirror, front_hind, "thigh")
        masses.append(m)
        coms.append(c)
        inertias.append(I)

        calf_body = len(masses)
        parent.append(thigh_body)
        joint_rot.append(eye.copy())
        joint_pos.append(np.array([0.0, 0.0, -_THIGH_LENGTH]))
        axis.append(np.array([0.0, 1.0, 0.0]))
        names.append(f"{leg}_calf_joint")
        limits.append(_LIMITS["calf"])
        m, c, I = _signed(_CALF, mirror, front_hind, "calf")
        # weld the foot sphere into the calf (fixed joint, leg.xacro:146-150)
        foot_pos = np.array([0.0, 0.0, -_CALF_LENGTH])
        m, c, I = compose_inertia(m, c, I, _FOOT_MASS, foot_pos, _FOOT_I)
        masses.append(m)
        coms.append(c)
        inertias.append(I)
        frames[f"{leg}_foot"] = Frame(body=calf_body, rot=eye.copy(), pos=foot_pos)
        frames[f"{leg}_thigh_joint"] = Frame(body=thigh_body, rot=eye.copy(), pos=np.zeros(3))

    limits_arr = np.array(limits)
    return RobotModel(
        name="go2",
        n_joints=12,
        parent=np.array(parent, np.int32),
        joint_rot=np.stack(joint_rot),
        joint_pos=np.stack(joint_pos),
        axis=np.stack(axis),
        mass=np.array(masses),
        com=np.stack(coms),
        inertia=np.stack(inertias),
        joint_names=tuple(names),
        frames=frames,
        joint_lower=limits_arr[:, 0],
        joint_upper=limits_arr[:, 1],
        velocity_limit=limits_arr[:, 2],
        effort_limit=limits_arr[:, 3],
    )


class Go2Config:
    name = "go2"
    eff_names = ["FR_foot", "FL_foot", "RR_foot", "RL_foot"]
    hip_names = ["FR_thigh_joint", "FL_thigh_joint", "RR_thigh_joint", "RL_thigh_joint"]
    n_eff = 4
    foot_size = _FOOT_RADIUS

    # config.py:162-165
    initial_configuration = np.array(
        [0.0, 0.0, 0.35, 0.0, 0.0, 0.0, 1.0] + [0.0, 0.8, -1.6] * 4
    )

    _model: RobotModel | None = None

    @classmethod
    def load_model(cls) -> RobotModel:
        if cls._model is None:
            cls._model = load_model(_ASSET)
        return cls._model

    @classmethod
    def q0(cls) -> np.ndarray:
        return cls.initial_configuration.copy()

    @classmethod
    def v0(cls) -> np.ndarray:
        return np.zeros(cls.load_model().nv)
