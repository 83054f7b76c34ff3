"""Batched rigid-body kinematics in PyTorch.

Counterpart of ``bunmpc_tpu/kin/algorithms.py``: the kinematics the MPC
solve needs, and the dynamics the simulator and the inverse-dynamics
controller need (RNEA, the mass matrix, the nonlinear effects). The
topology is static (``RobotModel`` numpy constants), so every algorithm
unrolls into a fixed chain of small batched ops over arbitrary leading batch
dimensions.

Conventions are Pinocchio's: world-frame body poses, local-frame base
velocity in ``v[:6]`` (linear first), centroidal momentum about the CoM in
world axes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..robots.model import RobotModel
from ..utils.quat import axis_angle_rot, quat_to_rot, se3_difference, se3_integrate

_G = 9.81

# model constants as tensors, one copy per (array, dtype, device); the array
# itself is kept in the value so its id stays unique while cached. Pass the
# model's own arrays (``model.axis``), not views of them (``model.axis[j]``,
# a new object per call), and index the cached tensor.
_CONST_CACHE: dict = {}


def const(arr, like: torch.Tensor) -> torch.Tensor:
    """A model constant (a numpy array held by the model) as a tensor of
    ``like``'s dtype and device, converted once per (array, dtype, device)."""
    key = (id(arr), like.dtype, like.device)
    hit = _CONST_CACHE.get(key)
    if hit is None:
        t = torch.as_tensor(np.asarray(arr), dtype=like.dtype, device=like.device)
        hit = _CONST_CACHE[key] = (arr, t)
    return hit[1]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _mv(M, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (M @ v[..., None])[..., 0]


def fk(model: RobotModel, q):
    """Forward kinematics: ``(R (..., nb, 3, 3), p (..., nb, 3))`` world
    rotations and positions of every moving body frame."""
    R0 = quat_to_rot(q[..., 3:7])
    Rs = [R0]
    ps = [q[..., 0:3]]
    for j in range(model.n_joints):
        b = int(model.parent[j])
        Rp, pp = Rs[b], ps[b]
        Rrot = axis_angle_rot(const(model.axis, q)[j], q[..., 7 + j])
        Rs.append(Rp @ const(model.joint_rot, q)[j] @ Rrot)
        ps.append(pp + _mv(Rp, const(model.joint_pos, q)[j]))
    return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)


def _frame_pos(model, R, p, name, like):
    f = model.frames[name]
    return p[..., f.body, :] + _mv(R[..., f.body, :, :], const(f.pos, like))


def frame_position(model: RobotModel, q, frame_name: str):
    """World position of a named fixed frame (e.g. a foot): (..., 3)."""
    R, p = fk(model, q)
    return _frame_pos(model, R, p, frame_name, q)


def frame_positions(model: RobotModel, q, frame_names):
    """World positions of several frames, stacked on a new axis: (..., n, 3)."""
    R, p = fk(model, q)
    return torch.stack([_frame_pos(model, R, p, n, q) for n in frame_names], dim=-2)


def body_velocities(model: RobotModel, q, v):
    """World-frame angular & linear velocities of every body-frame origin:
    ``(omega, vel, R, p)``; base twist ``v[:6]`` is local-frame."""
    R, p = fk(model, q)
    R0 = R[..., 0, :, :]
    omegas = [_mv(R0, v[..., 3:6])]
    vels = [_mv(R0, v[..., 0:3])]
    for j in range(model.n_joints):
        b = int(model.parent[j])
        body = j + 1
        a_w = _mv(R[..., body, :, :], const(model.axis, q)[j])
        r = p[..., body, :] - p[..., b, :]
        omegas.append(omegas[b] + a_w * v[..., 6 + j : 7 + j])
        vels.append(vels[b] + _cross(omegas[b], r))
    return torch.stack(omegas, dim=-2), torch.stack(vels, dim=-2), R, p


def com(model: RobotModel, q):
    """World-frame center of mass."""
    R, p = fk(model, q)
    return com_from_fk(model, R, p)


def com_from_fk(model: RobotModel, R, p):
    """``com`` from a forward-kinematics pass ``(R, p)``."""
    mass = const(model.mass, p)
    c_w = p + (R @ const(model.com, p)[..., None])[..., 0]
    return torch.sum(mass[:, None] * c_w, dim=-2) / model.total_mass


def _centroidal(model, q, omega, vel, R, p):
    mass = const(model.mass, q)
    c_off = (R @ const(model.com, q)[..., None])[..., 0]
    c_w = p + c_off
    v_com = vel + _cross(omega, c_off)
    com_w = torch.sum(mass[:, None] * c_w, dim=-2) / model.total_mass
    h_lin = torch.sum(mass[:, None] * v_com, dim=-2)
    I_w = R @ const(model.inertia, q) @ R.transpose(-1, -2)
    h_ang_each = (I_w @ omega[..., None])[..., 0] + mass[:, None] * _cross(
        c_w - com_w[..., None, :], v_com
    )
    return com_w, h_lin, torch.sum(h_ang_each, dim=-2)


def centroidal_state_and_frames(model: RobotModel, q, v, frame_names):
    """(com, h_lin, h_ang, frame positions) from ONE forward-kinematics pass."""
    omega, vel, R, p = body_velocities(model, q, v)
    com_w, h_lin, h_ang = _centroidal(model, q, omega, vel, R, p)
    frames = torch.stack([_frame_pos(model, R, p, n, q) for n in frame_names], dim=-2)
    return com_w, h_lin, h_ang, frames


def centroidal_momentum(model: RobotModel, q, v):
    """Centroidal momentum about the CoM in world axes: ``(com, h_lin, h_ang)``."""
    omega, vel, R, p = body_velocities(model, q, v)
    return _centroidal(model, q, omega, vel, R, p)


def frame_jacobian(model: RobotModel, q, frame_name: str, R=None, p=None):
    """Translation Jacobian of a frame, LOCAL_WORLD_ALIGNED: ``dp/dt = J v``
    (..., 3, nv)."""
    if R is None or p is None:
        R, p = fk(model, q)
    f = model.frames[frame_name]
    R0 = R[..., 0, :, :]
    p0 = p[..., 0, :]
    pf = _frame_pos(model, R, p, frame_name, q)
    zero = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    cols = [zero] * model.nv
    rel = pf - p0
    for k in range(3):
        cols[k] = R0[..., :, k]
        cols[3 + k] = _cross(R0[..., :, k], rel)
    for j in model.ancestors(f.body):
        body = j + 1
        a_w = _mv(R[..., body, :, :], const(model.axis, q)[j])
        cols[6 + j] = _cross(a_w, pf - p[..., body, :])
    return torch.stack(cols, dim=-1)


def rnea(model: RobotModel, q, v, a, gravity: float = _G):
    """Recursive Newton-Euler inverse dynamics ``tau = ID(q, v, a)``
    (..., nv), Pinocchio layout: rows 0:3 base force, 3:6 base torque (both
    local frame), then the joints; ``a``'s base rows are the time derivative
    of the local base twist."""
    return rnea_from_kin(model, body_velocities(model, q, v), v, a, gravity)


def rnea_from_kin(model: RobotModel, kin, v, a, gravity: float = _G):
    """``rnea`` from ``kin = body_velocities(model, q, v)``. ``v`` and ``a``
    may carry more leading axes than ``kin`` where they broadcast against it
    (``mass_matrix``'s column axis)."""
    omega, vel, R, p = kin
    R0 = R[..., 0, :, :]
    axis = const(model.axis, a)
    # base classical acceleration from the local spatial acceleration:
    # v_w = R0 v_loc  =>  dv_w = R0 a_loc + omega x v_w
    accs = [_mv(R0, a[..., 0:3]) + _cross(omega[..., 0, :], vel[..., 0, :])]
    alphas = [_mv(R0, a[..., 3:6])]
    a_ws = [None]
    for j in range(model.n_joints):
        b = int(model.parent[j])
        body = j + 1
        a_w = _mv(R[..., body, :, :], axis[j])
        r = p[..., body, :] - p[..., b, :]
        w_p = omega[..., b, :]
        alphas.append(alphas[b] + a_w * a[..., 6 + j : 7 + j]
                      + _cross(w_p, a_w) * v[..., 6 + j : 7 + j])
        accs.append(accs[b] + _cross(alphas[b], r) + _cross(w_p, _cross(w_p, r)))
        a_ws.append(a_w)

    # per-body net force and torque about its own CoM
    com_b = const(model.com, a)
    inertia = const(model.inertia, a)
    F_net, N_net, c_offs = [], [], []
    for b in range(model.n_bodies):
        Rb = R[..., b, :, :]
        c_off = _mv(Rb, com_b[b])
        w_b = omega[..., b, :]
        a_com = accs[b] + _cross(alphas[b], c_off) + _cross(w_b, _cross(w_b, c_off))
        I_w = Rb @ inertia[b] @ Rb.transpose(-1, -2)
        # a_com - (0, 0, -gravity)
        a_rel = torch.cat([a_com[..., 0:2], a_com[..., 2:3] + gravity], dim=-1)
        F_net.append(float(model.mass[b]) * a_rel)
        N_net.append(_mv(I_w, alphas[b]) + _cross(w_b, _mv(I_w, w_b)))
        c_offs.append(c_off)

    # backward pass: the wrench each body gets from its parent, the torque
    # about the body's frame origin
    children = [[] for _ in range(model.n_bodies)]
    for j in range(model.n_joints):
        children[int(model.parent[j])].append(j + 1)
    f = [None] * model.n_bodies
    n = [None] * model.n_bodies
    for b in reversed(range(model.n_bodies)):
        fb = F_net[b]
        nb = N_net[b] + _cross(c_offs[b], F_net[b])
        for cb in children[b]:
            fb = fb + f[cb]
            nb = nb + n[cb] + _cross(p[..., cb, :] - p[..., b, :], f[cb])
        f[b] = fb
        n[b] = nb

    taus = [torch.sum(a_ws[j + 1] * n[j + 1], dim=-1) for j in range(model.n_joints)]
    R0T = R0.transpose(-1, -2)
    return torch.cat([_mv(R0T, f[0]), _mv(R0T, n[0]), torch.stack(taus, dim=-1)], dim=-1)


def mass_matrix(model: RobotModel, q):
    """Joint-space inertia matrix M(q) (..., nv, nv) from RNEA columns."""
    R, p = fk(model, q)
    return mass_matrix_from_fk(model, R, p)


def mass_matrix_from_fk(model: RobotModel, R, p):
    """``mass_matrix`` from a forward-kinematics pass ``(R, p)``:
    M e_i = ID(q, 0, e_i) - ID(q, 0, 0), the 18 unit columns and the zero
    column as ONE RNEA call over a column axis."""
    nv = model.nv
    batch = p.shape[:-2]
    zeros3 = torch.zeros(batch + (1, model.n_bodies, 3), dtype=p.dtype, device=p.device)
    kin = (zeros3, zeros3, R[..., None, :, :, :], p[..., None, :, :])
    eye = torch.eye(nv + 1, nv, dtype=p.dtype, device=p.device)  # last row: zero column
    v0 = torch.zeros(batch + (1, nv), dtype=p.dtype, device=p.device)
    cols = rnea_from_kin(model, kin, v0, eye.expand(batch + (nv + 1, nv)), gravity=0.0)
    return (cols[..., :nv, :] - cols[..., nv:, :]).transpose(-1, -2)


def nonlinear_effects(model: RobotModel, q, v, gravity: float = _G):
    """Coriolis + centrifugal + gravity bias b(q, v) = ID(q, v, 0)."""
    return rnea(model, q, v, torch.zeros_like(v), gravity=gravity)


def composite_inertia_about_com(model: RobotModel, q):
    """Locked rotational inertia of the whole robot about its CoM (world axes)."""
    R, p = fk(model, q)
    mass = const(model.mass, q)
    c_w = p + (R @ const(model.com, q)[..., None])[..., 0]
    com_w = torch.sum(mass[:, None] * c_w, dim=-2) / model.total_mass
    I_w = R @ const(model.inertia, q) @ R.transpose(-1, -2)
    d = c_w - com_w[..., None, :]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    d2 = torch.sum(d * d, dim=-1)[..., None, None] * eye
    shift = mass[:, None, None] * (d2 - d[..., :, None] * d[..., None, :])
    return torch.sum(I_w + shift, dim=-3)


# --- configuration-space Lie group ops (free-flyer x R^nj) ---


def integrate(model: RobotModel, q, dq):
    """Pinocchio-style ``integrate(q, dq)`` with dq in the local tangent."""
    p_new, q_new = se3_integrate(q[..., 0:3], q[..., 3:7], dq[..., 0:3], dq[..., 3:6])
    return torch.cat([p_new, q_new, q[..., 7:] + dq[..., 6:]], dim=-1)


def difference(model: RobotModel, q1, q2):
    """Tangent vector dq with integrate(q1, dq) == q2."""
    dv, dw = se3_difference(q1[..., 0:3], q1[..., 3:7], q2[..., 0:3], q2[..., 3:7])
    return torch.cat([dv, dw, q2[..., 7:] - q1[..., 7:]], dim=-1)
