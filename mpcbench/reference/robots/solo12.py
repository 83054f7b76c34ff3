"""Solo12 robot description (copy of ``bunmpc_tpu/robots/solo12.py``; the
constants load from the committed ``robots/assets/solo12_model.npz``)."""

from __future__ import annotations

import os

import numpy as np

from .assets_io import load_model
from .model import RobotModel

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "solo12_model.npz")


class Solo12Config:
    name = "solo12"
    eff_names = ["FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT"]
    hip_names = ["FL_HFE", "FR_HFE", "HL_HFE", "HR_HFE"]
    n_eff = 4
    foot_size = 0.018

    # robot_info.yaml:6-11
    initial_configuration = np.array(
        [0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 1.0]
        + [0.0, 0.8, -1.6] * 2
        + [0.0, -0.8, 1.6] * 2
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
