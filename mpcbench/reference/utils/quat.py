"""Quaternion / rotation utilities (batched, PyTorch).

Counterpart of ``bunmpc_tpu/utils/quat.py``. Conventions follow Pinocchio's
layout (reference robot_properties_solo config.py:246-256):

* quaternions are stored ``(x, y, z, w)`` (scalar last),
* all functions broadcast over arbitrary leading batch dimensions,
* tangent-space maps use the *local* (body-frame) convention, matching
  Pinocchio's Lie-group integrate/difference (reference
  src/ik/action_model.cpp:43-70).

Everything is functional (no in-place updates), so ``torch.func`` transforms
apply; branches are ``torch.where`` over safe denominators, as in the JAX
package, so forward-mode tangents never see 0/0.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def skew(v):
    """Cross-product matrix: skew(v) @ u == cross(v, u). v: (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """Hamilton product, (x, y, z, w) layout."""
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_to_rot(q):
    """Unit quaternion (x, y, z, w) -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R):
    """Rotation matrix -> quaternion (x, y, z, w), branch-free (Shepperd):
    the four candidate constructions, the one with the largest pivot kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) / 2.0

    qw0 = root(1.0 + tr)
    q0 = torch.stack(
        [(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0), qw0], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack(
        [qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1), (m21 - m12) / (4 * qx1)], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack(
        [(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2), (m02 - m20) / (4 * qy2)], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack(
        [(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3, (m10 - m01) / (4 * qz3)], dim=-1)
    cases = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cases, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def exp3(w):
    """so(3) exponential: rotation vector -> quaternion (x, y, z, w)."""
    sq = torch.sum(w * w, dim=-1, keepdim=True)
    small = sq < 1e-12
    theta = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    s = torch.where(small, 0.5 - sq / 48.0, torch.sin(0.5 * theta) / theta)
    c = torch.where(small, 1.0 - sq / 8.0, torch.cos(0.5 * theta))
    return torch.cat([w * s, c], dim=-1)


def log3_quat(q):
    """Quaternion -> rotation vector (inverse of exp3), safe at identity."""
    q = torch.where(q[..., 3:4] < 0, -q, q)  # take the short path
    sq = torch.sum(q[..., :3] * q[..., :3], dim=-1, keepdim=True)
    w = q[..., 3:4]
    small = sq < 1e-12
    vnorm = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    angle = 2.0 * torch.atan2(vnorm, w)
    w_safe = torch.clamp(w, min=_EPS)
    scale = torch.where(
        small, (2.0 / w_safe) * (1.0 - sq / (3.0 * w_safe * w_safe)), angle / vnorm
    )
    return q[..., :3] * scale


def log3(R):
    """Rotation matrix -> rotation vector (the orientation-correction term,
    reference examples/mpc/abstract_cyclic_gen.py:616-627)."""
    return log3_quat(rot_to_quat(R))


def rot_x(theta):
    """Rotation about x by theta (...,) -> (..., 3, 3)."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([o, z, z], dim=-1),
            torch.stack([z, c, -s], dim=-1),
            torch.stack([z, s, c], dim=-1),
        ],
        dim=-2,
    )


def axis_angle_rot(axis, theta):
    """Rodrigues: rotation about a fixed axis (shape (3,), array or tensor) by
    theta (...,)."""
    axis = torch.as_tensor(axis, dtype=theta.dtype, device=theta.device)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    k = skew(axis)
    eye = torch.eye(3, dtype=theta.dtype, device=theta.device)
    outer = axis[:, None] * axis[None, :]
    return c * eye + s * k + (1 - c) * outer


def rpy_to_rot(rpy):
    """Roll-pitch-yaw (XYZ extrinsic, the URDF convention) -> rotation matrix."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def rot_to_rpy(R):
    """Rotation matrix -> roll-pitch-yaw (..., 3) (pin.rpy.matrixToRpy as
    the reference uses it, abstract_cyclic_gen.py:174)."""
    pitch = -torch.asin(torch.clamp(R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def yaw_quat(q):
    """Yaw-only component (roll = pitch = 0) of a quaternion (reference
    abstract_cyclic_gen.py:173-177)."""
    R = quat_to_rot(q)
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    half = 0.5 * yaw
    zero = torch.zeros_like(half)
    return torch.stack([zero, zero, torch.sin(half), torch.cos(half)], dim=-1)


# --- SE(3) exp/log (local-frame tangent [linear, angular], Pinocchio order) ---


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _so3_left_jacobian(w):
    """V(w) such that exp6 translation = V @ v. (..., 3) -> (..., 3, 3)."""
    sq = torch.sum(w * w, dim=-1)[..., None, None]
    small = sq < 1e-10
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    t = torch.sqrt(sq_safe)
    K = skew(w)
    K2 = K @ K
    a = torch.where(small, 0.5 - sq / 24.0, (1 - torch.cos(t)) / sq_safe)
    b = torch.where(small, 1.0 / 6.0 - sq / 120.0, (t - torch.sin(t)) / (sq_safe * t))
    return _eye3(w) + a * K + b * K2


def se3_integrate(p, q, dv, dw):
    """Integrate a local-frame twist (dv linear, dw angular) on SE(3)
    (Pinocchio's free-flyer ``integrate``)."""
    R = quat_to_rot(q)
    V = _so3_left_jacobian(dw)
    p_new = p + (R @ (V @ dv[..., None]))[..., 0]
    q_new = quat_normalize(quat_mul(q, exp3(dw)))
    return p_new, q_new


def _so3_left_jacobian_inv(w):
    """Closed-form V(w)^-1, safe at w=0."""
    sq = torch.sum(w * w, dim=-1)[..., None, None]
    small = sq < 1e-10
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    t = torch.sqrt(sq_safe)
    K = skew(w)
    K2 = K @ K
    cot_term = (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t))
    b = torch.where(small, 1.0 / 12.0 + sq / 720.0, 1.0 / sq_safe - cot_term)
    return _eye3(w) - 0.5 * K + b * K2


def se3_difference(p1, q1, p2, q2):
    """Local-frame twist (dv, dw) with integrate(x1, (dv, dw)) == x2."""
    q_rel = quat_mul(quat_conj(q1), q2)
    dw = log3_quat(q_rel)
    R1 = quat_to_rot(q1)
    dp_local = (R1.transpose(-1, -2) @ (p2 - p1)[..., None])[..., 0]
    Vinv = _so3_left_jacobian_inv(dw)
    dv = (Vinv @ dp_local[..., None])[..., 0]
    return dv, dw


def _se3_Q(rho, w):
    """Barfoot's Q block of the SE(3) left Jacobian, xi = [rho (linear), w
    (angular)]: Jl6 = [[Jl3(w), Q], [0, Jl3(w)]], with Taylor branches at
    w = 0."""
    sq = torch.sum(w * w, dim=-1)[..., None, None]
    small = sq < 1e-8
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    t = torch.sqrt(sq_safe)
    rx, wx = skew(rho), skew(w)
    wxrx = wx @ rx
    rxwx = rx @ wx
    wxrxwx = wxrx @ wx
    c1 = torch.where(small, 1.0 / 6.0 - sq / 120.0, (t - torch.sin(t)) / (sq_safe * t))
    # (theta^2/2 + cos(theta) - 1)/theta^4 -> 1/24 - theta^2/720
    c2 = torch.where(small, 1.0 / 24.0 - sq / 720.0,
                     (sq / 2.0 + torch.cos(t) - 1.0) / (sq_safe * sq_safe))
    # (theta - sin(theta) - theta^3/6)/theta^5 -> -1/120 + theta^2/5040
    c3 = torch.where(small, -1.0 / 120.0 + sq / 5040.0,
                     (t - torch.sin(t) - t * sq / 6.0) / (sq_safe * sq_safe * t))
    return (
        0.5 * rx
        + c1 * (wxrx + rxwx + wxrxwx)
        + c2 * (wx @ wxrx + rxwx @ wx - 3.0 * wxrxwx)
        + 0.5 * (c2 + 3.0 * c3) * (wxrxwx @ wx + wx @ wxrxwx)
    )


def _blocks(tl, tr, br):
    """[[tl, tr], [0, br]] from (..., 3, 3) blocks."""
    top = torch.cat([tl, tr], dim=-1)
    bot = torch.cat([torch.zeros_like(br), br], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_left_jacobian(rho, w):
    """SE(3) left Jacobian Jl6(xi), xi = [rho, w]: Exp(xi + d) ~ Exp(Jl6 d) Exp(xi)."""
    Jl = _so3_left_jacobian(w)
    return _blocks(Jl, _se3_Q(rho, w), Jl)


def se3_left_jacobian_inv(rho, w):
    """Jl6(xi)^-1 by the block inverse [[Ji, -Ji Q Ji], [0, Ji]]."""
    Ji = _so3_left_jacobian_inv(w)
    return _blocks(Ji, -(Ji @ _se3_Q(rho, w) @ Ji), Ji)


def se3_right_jacobian(rho, w):
    """Jr6(xi) = Jl6(-xi): Exp(xi + d) ~ Exp(xi) Exp(Jr6 d)."""
    return se3_left_jacobian(-rho, -w)


def se3_right_jacobian_inv(rho, w):
    return se3_left_jacobian_inv(-rho, -w)


def se3_adjoint_exp(rho, w):
    """Ad(Exp(xi)) for the twist order [linear, angular]: [[R, t^ R], [0, R]]
    with R = exp(w^), t = V(w) rho."""
    R = quat_to_rot(exp3(w))
    t = (_so3_left_jacobian(w) @ rho[..., None])[..., 0]
    return _blocks(R, skew(t) @ R, R)
