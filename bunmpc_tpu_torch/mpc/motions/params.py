"""Motion/gait parameter containers.

Copy of ``bunmpc_tpu/mpc/motions/params.py`` (the cyclic and the acyclic
containers): frozen dataclasses of numpy constants, the twins of the
reference's data-only parameter classes (reference
examples/motions/weight_abstract.py:7-84).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BiconvexMotionParams:
    robot_name: str
    motion_name: str

    # Contact / gait timing
    gait_period: float
    stance_percent: tuple
    gait_dt: float
    phase_offset: tuple
    step_ht: float

    # IK weights
    state_wt: np.ndarray  # (2nv,)
    ctrl_wt: np.ndarray  # (nv,)
    swing_wt: tuple  # (contact task, via task)
    cent_wt: tuple  # (com, momentum)
    reg_wt: tuple  # (state, ctrl)

    # Dynamics weights
    W_X: np.ndarray  # (9,)
    W_X_ter: np.ndarray  # (9,)
    W_F: np.ndarray  # (3*n_eff,)
    rho: float
    ori_correction: tuple  # (3,)
    gait_horizon: float
    nom_ht: float

    # low-level controller gains
    kp: float
    kd: float

    plan_freq: float = 0.05

    # Force-regularization style (round-5, VERDICT task 6):
    # * "zero"   — reference-verbatim: min F' W_F F pulls every force toward
    #              zero (biconvex.cpp:60-72). The regularizer then fights
    #              gravity: stance Fz settles below m g and the CoM droops,
    #              with a (m g)^2-scaled severity that forced per-robot W_F
    #              sweep patches (Solo12 trot_sim x0.1, Go2 1e-1).
    # * "weight" — mass-normalized: regularize toward the weight-distributed
    #              nominal (active feet share m g equally per knot), i.e.
    #              min (F - F_nom)' W_F (F - F_nom). Gravity lives in the
    #              reference point instead of the penalty, so ONE table value
    #              transfers across robots and the CoM holds nominal height.
    # Reference-verbatim tables keep "zero" (frozen parity fixtures depend
    # on it); sim-validated *_sim tables use "weight".
    f_reg_style: str = "zero"

    @property
    def horizon(self) -> int:
        """Dynamics collocation knots (abstract_cyclic_gen.py:125)."""
        return int(np.round(self.gait_horizon * self.gait_period / self.gait_dt, 2))

    def ik_horizon(self, ratio: float = 0.5) -> int:
        """IK knots (abstract_cyclic_gen.py:128)."""
        return int(np.round(ratio * self.gait_horizon * self.gait_period / self.gait_dt, 2))


@dataclasses.dataclass(frozen=True)
class ACyclicMotionParams:
    """Acyclic motions (jumps, cartwheels, rearing): time-stamped contact plan
    and windowed costs (reference weight_abstract.py:45-84)."""

    robot_name: str
    motion_name: str
    n_col: int
    dt_arr: np.ndarray  # (n_col,)
    plan_freq: float
    cnt_plan: np.ndarray  # segments [[c, x, y, z, t_start, t_end] x n_eff]
    W_X: np.ndarray
    W_X_ter: np.ndarray
    W_F: np.ndarray
    X_nom: np.ndarray  # [[9 values, t_start, t_end], ...]
    X_ter: np.ndarray
    rho: float
    bounds: np.ndarray  # [[bx, by, bz, t_start, t_end], ...]
    swing_wt: list  # [[wt, x, y, z, t_start, t_end], ...] via points
    cent_wt: tuple
    state_wt: np.ndarray
    state_reg: np.ndarray
    state_scale: np.ndarray
    ctrl_wt: np.ndarray
    ctrl_reg: np.ndarray
    ctrl_scale: np.ndarray
    kp: object  # scalar or windowed [[kp, t_start, t_end], ...]
    kd: object
    cnt_wt: float = 5e4  # IK contact-tracking weight (plan_jump.py:72)
