"""Robot model constants for the batched PyTorch rigid-body stack.

A copy of ``bunmpc_tpu/robots/model.py`` (numpy only: the containers and
the inertia helpers that assemble a model): ``RobotModel`` is the
replacement for the Pinocchio ``Model``/``Data`` pair. Topology is *static*:
every array here is a host-side numpy constant, so the kinematics unroll into
a fixed chain of small batched tensor ops, and the CUDA kernels receive the
same constants packed into one small argument buffer
(``solvers/cuda_ddp.pack_model``).

Layout conventions (Pinocchio-compatible so reference states transfer 1:1):
* ``q = [base_pos(3), base_quat(xyzw), theta(n_joints)]``    (nq = 7 + nj)
* ``v = [base_lin_vel_local(3), base_ang_vel_local(3), theta_dot]`` (nv = 6 + nj)

Bodies are indexed 0..n_bodies-1 with body 0 = floating base; moving joint j
connects ``parent[j]`` to body ``j + 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Frame:
    """A fixed frame attached to a moving body (e.g. a foot)."""

    body: int  # moving-body index the frame is welded to
    rot: np.ndarray  # (3, 3) frame rotation in body coordinates
    pos: np.ndarray  # (3,) frame origin in body coordinates


@dataclasses.dataclass(frozen=True)
class RobotModel:
    name: str
    n_joints: int  # number of revolute joints (12 for Solo12/Go2)
    parent: np.ndarray  # (nj,) parent *body* index of joint j (0 = base)
    joint_rot: np.ndarray  # (nj, 3, 3) joint frame rotation in parent body frame
    joint_pos: np.ndarray  # (nj, 3) joint origin in parent body frame
    axis: np.ndarray  # (nj, 3) rotation axis in joint (== child body) frame
    # Inertial constants per body (n_bodies = 1 + nj), composited over fixed joints:
    mass: np.ndarray  # (nb,)
    com: np.ndarray  # (nb, 3) body-frame CoM
    inertia: np.ndarray  # (nb, 3, 3) rotational inertia about the body-frame CoM
    joint_names: Tuple[str, ...]
    frames: Dict[str, Frame]
    # URDF joint limits (used by safety predicates, reference simulation.py:222-297)
    joint_lower: np.ndarray  # (nj,)
    joint_upper: np.ndarray  # (nj,)
    velocity_limit: np.ndarray  # (nj,)
    effort_limit: np.ndarray  # (nj,)

    @property
    def nq(self) -> int:
        return 7 + self.n_joints

    @property
    def nv(self) -> int:
        return 6 + self.n_joints

    @property
    def n_bodies(self) -> int:
        return 1 + self.n_joints

    @property
    def total_mass(self) -> float:
        return float(np.sum(self.mass))

    def ancestors(self, body: int) -> Tuple[int, ...]:
        """Moving-joint indices on the path base -> ``body`` (static, host side)."""
        chain = []
        b = body
        while b != 0:
            j = b - 1
            chain.append(j)
            b = int(self.parent[j])
        return tuple(reversed(chain))


def compose_inertia(m1, c1, I1, m2, c2, I2):
    """Combine two (mass, com, inertia-about-com) triplets in a shared frame."""
    m = m1 + m2
    if m == 0.0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    c = (m1 * c1 + m2 * c2) / m
    out = np.zeros((3, 3))
    for mi, ci, Ii in ((m1, c1, I1), (m2, c2, I2)):
        d = ci - c
        out += Ii + mi * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
    return m, c, out


def transform_inertia(R, p, m, c, I):
    """Express (m, c, I-about-com) given in frame B in frame A, where the pose
    of B in A is (R, p)."""
    c_new = R @ c + p
    I_new = R @ I @ R.T
    return m, c_new, I_new
