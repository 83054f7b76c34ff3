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
