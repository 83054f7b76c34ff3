"""Serialize :class:`RobotModel` constants to/from a compact ``.npz``.

A copy of ``bunmpc_tpu/robots/assets_io.py``: robot constants ship as a
committed ``.npz`` (``robots/assets/solo12_model.npz``, byte-identical to the
JAX package's), so the port runs without any URDF on disk.
"""

from __future__ import annotations

import numpy as np

from .model import Frame, RobotModel


def save_model(model: RobotModel, path: str) -> None:
    """Write ``model`` to ``path`` in the layout ``load_model`` reads."""
    frame_names = list(model.frames.keys())
    np.savez_compressed(
        path,
        name=np.array(model.name),
        n_joints=np.array(model.n_joints),
        parent=model.parent,
        joint_rot=model.joint_rot,
        joint_pos=model.joint_pos,
        axis=model.axis,
        mass=model.mass,
        com=model.com,
        inertia=model.inertia,
        joint_names=np.array(list(model.joint_names)),
        frame_names=np.array(frame_names),
        frame_body=np.array([model.frames[n].body for n in frame_names], dtype=np.int32),
        frame_rot=np.stack([model.frames[n].rot for n in frame_names]),
        frame_pos=np.stack([model.frames[n].pos for n in frame_names]),
        joint_lower=model.joint_lower,
        joint_upper=model.joint_upper,
        velocity_limit=model.velocity_limit,
        effort_limit=model.effort_limit,
    )


def load_model(path: str) -> RobotModel:
    z = np.load(path, allow_pickle=False)
    frames = {}
    for i, n in enumerate(z["frame_names"]):
        frames[str(n)] = Frame(
            body=int(z["frame_body"][i]), rot=z["frame_rot"][i], pos=z["frame_pos"][i]
        )
    return RobotModel(
        name=str(z["name"]),
        n_joints=int(z["n_joints"]),
        parent=z["parent"],
        joint_rot=z["joint_rot"],
        joint_pos=z["joint_pos"],
        axis=z["axis"],
        mass=z["mass"],
        com=z["com"],
        inertia=z["inertia"],
        joint_names=tuple(str(n) for n in z["joint_names"]),
        frames=frames,
        joint_lower=z["joint_lower"],
        joint_upper=z["joint_upper"],
        velocity_limit=z["velocity_limit"],
        effort_limit=z["effort_limit"],
    )
