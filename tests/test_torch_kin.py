"""The port's quaternion/SE(3) maps and rigid-body kinematics against the JAX
package's, in float64 on random configurations (atol 1e-10: the same
formulas, summed in a slightly different order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bunmpc_tpu.kin import algorithms as JK
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu.utils import quat as JQ
from bunmpc_tpu_torch.kin import algorithms as TK
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TSolo
from bunmpc_tpu_torch.utils import quat as TQ

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)

ATOL = 1e-10
B = 6


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    q = np.tile(JSolo.q0(), (B, 1))
    q[:, 0:3] += rng.normal(size=(B, 3)) * 0.1
    q[:, 3:7] = quat
    q[:, 7:] += rng.normal(size=(B, 12)) * 0.3
    v = rng.normal(size=(B, 18)) * 0.5
    w = rng.normal(size=(B, 3)) * 0.7
    w[0] = 0.0  # the small-angle branches
    w[1] = 1e-7
    rho = rng.normal(size=(B, 3))
    q2 = q.copy()
    q2[:, 0:3] += rng.normal(size=(B, 3)) * 0.05
    q2[:, 3:7] = (quat + rng.normal(size=(B, 4)) * 0.1)
    q2[:, 3:7] /= np.linalg.norm(q2[:, 3:7], axis=-1, keepdims=True)
    q2[:, 7:] += rng.normal(size=(B, 12)) * 0.1
    return dict(q=q, v=v, w=w, rho=rho, quat=quat, q2=q2, dq=rng.normal(size=(B, 18)) * 0.2)


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _j(a):
    return jnp.asarray(a, jnp.float64)


@pytest.mark.parametrize(
    "name, args",
    [
        ("skew", ("w",)), ("quat_to_rot", ("quat",)), ("exp3", ("w",)),
        ("log3_quat", ("quat",)), ("yaw_quat", ("quat",)), ("quat_conj", ("quat",)),
        ("_so3_left_jacobian", ("w",)), ("_so3_left_jacobian_inv", ("w",)),
    ],
)
def test_quat_maps(data, name, args):
    out_t = getattr(TQ, name)(*[_t(data[a]) for a in args])
    out_j = getattr(JQ, name)(*[_j(data[a]) for a in args])
    _close(out_t, out_j)


def test_quat_mul_and_se3_chart(data):
    _close(TQ.quat_mul(_t(data["quat"]), _t(data["q2"][:, 3:7])),
           JQ.quat_mul(_j(data["quat"]), _j(data["q2"][:, 3:7])))
    for (pt, qt), (pj, qj) in [
        (TQ.se3_integrate(_t(data["rho"]), _t(data["quat"]), _t(data["rho"]), _t(data["w"])),
         JQ.se3_integrate(_j(data["rho"]), _j(data["quat"]), _j(data["rho"]), _j(data["w"]))),
        (TQ.se3_difference(_t(data["q"][:, :3]), _t(data["quat"]), _t(data["q2"][:, :3]),
                           _t(data["q2"][:, 3:7])),
         JQ.se3_difference(_j(data["q"][:, :3]), _j(data["quat"]), _j(data["q2"][:, :3]),
                           _j(data["q2"][:, 3:7]))),
    ]:
        _close(pt, pj)
        _close(qt, qj)
    R = TQ.axis_angle_rot(np.array([0.0, 1.0, 0.0]), _t(data["w"][:, 0]))
    _close(R, JQ.axis_angle_rot(jnp.array([0.0, 1.0, 0.0]), _j(data["w"][:, 0])))


@pytest.fixture(scope="module")
def models():
    return TSolo.load_model(), JSolo.load_model()


def test_fk_com_and_frames(models, data):
    tm, jm = models
    q = data["q"]
    Rt, pt = TK.fk(tm, _t(q))
    Rj, pj = JK.fk(jm, _j(q))
    _close(Rt, Rj)
    _close(pt, pj)
    _close(TK.com(tm, _t(q)), JK.com(jm, _j(q)))
    names = ("FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT", "FL_HFE")
    _close(TK.frame_positions(tm, _t(q), names), JK.frame_positions(jm, _j(q), names))
    _close(TK.composite_inertia_about_com(tm, _t(q)), JK.composite_inertia_about_com(jm, _j(q)))


def test_velocities_and_centroidal_state(models, data):
    tm, jm = models
    q, v = data["q"], data["v"]
    for a, b in zip(TK.body_velocities(tm, _t(q), _t(v)), JK.body_velocities(jm, _j(q), _j(v))):
        _close(a, b)
    for a, b in zip(TK.centroidal_momentum(tm, _t(q), _t(v)),
                    JK.centroidal_momentum(jm, _j(q), _j(v))):
        _close(a, b)
    eff = TSolo.eff_names
    for a, b in zip(TK.centroidal_state_and_frames(tm, _t(q), _t(v), eff),
                    JK.centroidal_state_and_frames(jm, _j(q), _j(v), eff)):
        _close(a, b)


@pytest.mark.parametrize("frame", ["FL_FOOT", "FR_FOOT", "HL_FOOT", "HR_FOOT"])
def test_frame_jacobians(models, data, frame):
    tm, jm = models
    _close(TK.frame_jacobian(tm, _t(data["q"]), frame), JK.frame_jacobian(jm, _j(data["q"]), frame))


def test_integrate_and_difference(models, data):
    tm, jm = models
    q, q2, dq = data["q"], data["q2"], data["dq"]
    _close(TK.integrate(tm, _t(q), _t(dq)), JK.integrate(jm, _j(q), _j(dq)))
    d_t = TK.difference(tm, _t(q), _t(q2))
    _close(d_t, JK.difference(jm, _j(q), _j(q2)))
    # round trip: integrate(q, difference(q, q2)) == q2
    _close(TK.integrate(tm, _t(q), d_t), q2, atol=1e-9)


def test_constant_cache_is_bounded(models, data):
    """Model constants are converted once per (array, dtype, device): repeated
    solves do not grow the cache (a per-joint view would add entries on
    every call)."""
    tm, _ = models
    q, v = _t(data["q"]), _t(data["v"])
    TK.centroidal_state_and_frames(tm, q, v, TSolo.eff_names)
    TK.frame_jacobian(tm, q, "FL_FOOT")
    n = len(TK._CONST_CACHE)
    for _ in range(3):
        TK.centroidal_state_and_frames(tm, q, v, TSolo.eff_names)
        TK.frame_jacobian(tm, q, "FL_FOOT")
    assert len(TK._CONST_CACHE) == n
