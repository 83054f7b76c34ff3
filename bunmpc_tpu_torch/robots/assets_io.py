"""Load :class:`RobotModel` constants from a compact ``.npz``.

A copy of ``bunmpc_tpu/robots/assets_io.py``: robot constants ship as a
committed ``.npz`` (``robots/assets/solo12_model.npz``, byte-identical to the
JAX package's), so the port runs without any URDF on disk.
"""

from __future__ import annotations

import numpy as np

from .model import Frame, RobotModel


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
