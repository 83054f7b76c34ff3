"""Batched rigid-body simulator with implicit soft ground contacts.

Counterpart of ``bunmpc_tpu/sim/physics.py``. One 1 ms step
(semi-implicit Euler) of a batch of robots: free dynamics from the mass
matrix and the nonlinear effects, then a velocity-implicit spring-damper
contact solve over the 3*n_eff contact rows,

    (I + dt * D * G) f = k_n * pen - D * u_free,   G = J M^{-1} J^T,

clamped to the unilateral normal and the friction cone. One Cholesky
factorisation of M serves both M^{-1}(tau - bias) and M^{-1} J^T. The ground
is flat at z = 0, or a ``Terrain`` heightfield (contact normals stay
vertical: valid for gentle slopes).

State convention is Pinocchio's (q: base position + quaternion (xyzw) +
joints; v: local-frame base twist + joint rates). Every step is batched
tensor ops with no host synchronisation, so a loop of steps on the card
never waits for the host.

Every field of ``ContactParams`` and ``SimParams`` but ``dt`` is a float for
the whole batch or a (B,) tensor per robot (the JAX package's ``vmap`` over
a batch of parameters: domain randomisation and the stability sweeps).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kin import algorithms as K
from ..robots.model import RobotModel


@dataclasses.dataclass(frozen=True)
class ContactParams:
    foot_radius: float = 0.018  # collision sphere radius (solo12 foot_size)
    kn: float = 4e3  # normal stiffness [N/m]
    dn: float = 300.0  # normal damping [N s/m] (implicit)
    mu: float = 1.0  # Coulomb friction
    kt: float = 300.0  # tangential damping [N s/m] (implicit)


@dataclasses.dataclass(frozen=True)
class Terrain:
    """Uneven ground: a regular grid of heights sampled bilinearly (the JAX
    package's working replacement for the reference's broken Perlin
    generator, pybullet_env.py:154-201). ``heights`` (N, M) is a tensor on
    the device and in the dtype of the states it meets; ``origin`` (the
    world xy of ``heights[0, 0]``) and ``cell`` (the grid spacing, m) are
    floats, so a CUDA graph that reads the ground reads the heights' buffer
    and nothing from the host."""

    heights: torch.Tensor  # (N, M) ground heights
    origin: tuple = (0.0, 0.0)
    cell: float = 0.05

    def to(self, like: torch.Tensor) -> "Terrain":
        """The same ground with its heights in ``like``'s dtype and device."""
        return dataclasses.replace(self, heights=torch.as_tensor(
            self.heights, dtype=like.dtype, device=like.device).contiguous())

    def height_at(self, xy):
        """Bilinear ground height at world xy (..., 2); beyond the grid the
        edge cells extend it (indices clamped, weights clamped to [0, 1])."""
        h = self.heights
        n, m = h.shape
        gx = (xy[..., 0] - float(self.origin[0])) / float(self.cell)
        gy = (xy[..., 1] - float(self.origin[1])) / float(self.cell)
        i0 = torch.clamp(torch.floor(gx).to(torch.int64), 0, n - 2)
        j0 = torch.clamp(torch.floor(gy).to(torch.int64), 0, m - 2)
        fx = torch.clamp(gx - i0, 0.0, 1.0)
        fy = torch.clamp(gy - j0, 0.0, 1.0)
        flat = h.reshape(-1)
        at = i0 * m + j0
        h00, h10, h01, h11 = flat[at], flat[at + m], flat[at + 1], flat[at + m + 1]
        return (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy) + h01 * (1 - fx) * fy
                + h11 * fx * fy)


def random_terrain(generator: torch.Generator, extent: float = 4.0, cell: float = 0.05,
                   amplitude: float = 0.02, smooth: int = 3, dtype=torch.float32) -> Terrain:
    """A random smooth heightfield centred on the origin (terrain fault
    injection; the JAX package's ``random_terrain``, reference
    generate_terrain, pybullet_env.py:154): ``amplitude`` times normal draws
    on a (2 extent / cell)^2 grid, box-blurred ``smooth`` times. The draws
    come from ``generator`` (on its device), where the JAX function takes a
    key: the two packages' heights differ, their recipe does not."""
    n = int(2 * extent / cell)
    h = amplitude * torch.randn((n, n), generator=generator, dtype=dtype,
                                device=generator.device)
    for _ in range(smooth):  # box blur -> gentle slopes
        h = (h + torch.roll(h, 1, 0) + torch.roll(h, -1, 0) + torch.roll(h, 1, 1)
             + torch.roll(h, -1, 1)) / 5.0
    return Terrain(heights=h, origin=(-extent, -extent), cell=cell)


@dataclasses.dataclass(frozen=True)
class SimParams:
    dt: float = 0.001
    contact: ContactParams = ContactParams()
    joint_damping: float = 0.02  # motor/transmission damping
    torque_limit: float = 2.7  # Solo12 actuator limit [N m]


def per_robot(x):
    """A parameter as it broadcasts against (B, n) rows: a float as it is, a
    (B,) tensor as (B, 1)."""
    return x[..., None] if torch.is_tensor(x) else x


class SimState(NamedTuple):
    q: torch.Tensor  # (..., nq)
    v: torch.Tensor  # (..., nv)


class ContactInfo(NamedTuple):
    forces: torch.Tensor  # (..., n_eff, 3) world-frame ground reactions
    positions: torch.Tensor  # (..., n_eff, 3) foot positions
    in_contact: torch.Tensor  # (..., n_eff) bool


def _foot_kinematics(model: RobotModel, eff_frames, q, v, kin=None):
    """Foot world positions, velocities and stacked translation Jacobians
    (..., 3*ne, nv); ``kin`` is ``K.body_velocities(model, q, v)`` where the
    caller has it."""
    omega, vel, R, p = K.body_velocities(model, q, v) if kin is None else kin
    pos, vels, Js = [], [], []
    for name in eff_frames:
        f = model.frames[name]
        off = K._mv(R[..., f.body, :, :], K.const(f.pos, q))
        pos.append(p[..., f.body, :] + off)
        vels.append(vel[..., f.body, :] + K._cross(omega[..., f.body, :], off))
        Js.append(K.frame_jacobian(model, q, name, R=R, p=p))
    return torch.stack(pos, dim=-2), torch.stack(vels, dim=-2), torch.cat(Js, dim=-2)


def step(
    model: RobotModel,
    eff_frames,
    params: SimParams,
    state: SimState,
    tau_joints,  # (..., n_joints) commanded joint torques
    f_ext=None,  # optional (..., 3) external world-frame force at the base origin
    m_ext=None,  # optional (..., 3) external world-frame moment on the base
    terrain: Terrain | None = None,  # optional uneven ground
    kin=None,  # optional K.body_velocities(model, state.q, state.v), to share its FK
):
    """One physics step of a batch: ``(SimState, ContactInfo)``. With
    ``terrain`` a foot's penetration is measured from the ground under it."""
    q, v = state
    cp = params.contact
    ne = len(eff_frames)
    dt = params.dt
    if kin is None:
        kin = K.body_velocities(model, q, v)
    lim = per_robot(params.torque_limit)
    tau_joints = torch.clamp(tau_joints, -lim, lim)
    kn, dn, kt, mu = (per_robot(x) for x in (cp.kn, cp.dn, cp.kt, cp.mu))

    pos, _, J = _foot_kinematics(model, eff_frames, q, v, kin)
    height = pos[..., 2] if terrain is None else pos[..., 2] - terrain.height_at(pos[..., 0:2])
    pen = per_robot(cp.foot_radius) - height  # (..., ne) penetration depth
    active = (pen > 0).to(q.dtype)

    # free dynamics
    zeros6 = torch.zeros(q.shape[:-1] + (6,), dtype=q.dtype, device=q.device)
    tau = torch.cat([zeros6, tau_joints - per_robot(params.joint_damping) * v[..., 6:]], dim=-1)
    R0T = kin[2][..., 0, :, :].transpose(-1, -2)
    if f_ext is not None:
        tau = torch.cat([tau[..., 0:3] + K._mv(R0T, f_ext), tau[..., 3:]], dim=-1)
    if m_ext is not None:
        tau = torch.cat([tau[..., 0:3], tau[..., 3:6] + K._mv(R0T, m_ext), tau[..., 6:]],
                        dim=-1)

    M = K.mass_matrix_from_fk(model, kin[2], kin[3])
    bias = K.rnea_from_kin(model, kin, v, torch.zeros_like(v))
    # M is SPD: one Cholesky factorisation for M^-1 (tau - bias) and M^-1 J^T
    L, _ = torch.linalg.cholesky_ex(M)
    rhs = torch.cat([(tau - bias)[..., None], J.transpose(-1, -2)], dim=-1)  # (..., nv, 1+3ne)
    # two triangular solves (batched cuBLAS on the card: no host sync)
    sol = torch.linalg.solve_triangular(
        L.transpose(-1, -2), torch.linalg.solve_triangular(L, rhs, upper=False), upper=True)
    v_free = v + dt * sol[..., 0]
    u_free = K._mv(J, v_free)  # (..., 3ne)

    # implicit contact solve (I + dt D G) f = k - D u_free, rows masked by activity
    MinvJT = sol[..., 1:]  # (..., nv, 3ne)
    G = J @ MinvJT
    D = torch.stack([kt * active, kt * active, dn * active], dim=-1).flatten(-2)
    zero = torch.zeros_like(pen)
    kvec = torch.stack([zero, zero, kn * pen * active], dim=-1).flatten(-2)
    eye = torch.eye(3 * ne, dtype=q.dtype, device=q.device)
    A = eye + dt * D[..., :, None] * G
    f, _ = torch.linalg.solve_ex(A, (kvec - D * u_free)[..., None])
    f = f[..., 0].unflatten(-1, (ne, 3))

    # unilateral + friction-cone projection
    fn = torch.clamp(f[..., 2], min=0.0) * active
    ft = f[..., 0:2]
    ft_norm = torch.sqrt(torch.sum(ft * ft, dim=-1) + 1e-12)
    scale = torch.clamp(mu * fn / ft_norm, max=1.0)
    f = torch.cat([ft * scale[..., None], fn[..., None]], dim=-1)

    v_next = v_free + dt * K._mv(MinvJT, f.flatten(-2))
    q_next = K.integrate(model, q, v_next * dt)
    return SimState(q=q_next, v=v_next), ContactInfo(forces=f, positions=pos, in_contact=pen > 0)
