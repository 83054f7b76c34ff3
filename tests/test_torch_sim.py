"""The closed loop's dynamics against the JAX package, on the same seeded
numpy inputs in float64: RNEA, the mass matrix and the nonlinear effects
(atol 1e-10), one physics step with and without ground contact and with
external force and moment (atol 1e-10), the inverse-dynamics controller
with and without the per-leg force scale (atol 1e-10), roll-pitch-yaw, and
the PD settle (5 steps at atol 1e-10; the settle chatters, so the 500 ms
settled start is held to the JAX package's within 2 mm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
import torch_rollout_reference as REF
from bunmpc_tpu.kin import algorithms as JK
from bunmpc_tpu.robots.solo12 import Solo12Config as JC
from bunmpc_tpu.sim import controllers as JCt
from bunmpc_tpu.sim import physics as JP
from bunmpc_tpu.sim import rollout as JR
from bunmpc_tpu.utils import quat as JQ
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.kin import algorithms as TK
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TC
from bunmpc_tpu_torch.sim import controllers as TCt
from bunmpc_tpu_torch.sim import physics as TP
from bunmpc_tpu_torch.sim import rollout as TR
from bunmpc_tpu_torch.utils import quat as TQ

ATOL = 1e-10
B = 5
EFF = tuple(TC.eff_names)
JSP = JP.SimParams(contact=JP.ContactParams(kn=1e4, dn=500.0, kt=500.0))


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def close(got, ref, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def models():
    return JC.load_model(), TC.load_model()


def _states(seed, z=None):
    """B random configurations around q0 (random base orientation and joint
    offsets) and random velocities and accelerations."""
    rng = np.random.default_rng(seed)
    q = np.tile(JC.q0(), (B, 1))
    q[:, 7:] += rng.normal(size=(B, 12)) * 0.3
    quat = np.array([0.0, 0.0, 0.0, 1.0]) + rng.normal(size=(B, 4)) * 0.1
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    if z is not None:
        q[:, 2] = z
    return q, rng.normal(size=(B, 18)), rng.normal(size=(B, 18))


@pytest.mark.parametrize("fn", ["rnea", "mass_matrix", "nonlinear_effects"])
def test_dynamics_match_jax(models, fn):
    jm, tm = models
    q, v, a = _states(0)
    if fn == "rnea":
        ref, got = JK.rnea(jm, q, v, a), TK.rnea(tm, t64(q), t64(v), t64(a))
    elif fn == "mass_matrix":
        ref, got = JK.mass_matrix(jm, jnp.asarray(q)), TK.mass_matrix(tm, t64(q))
    else:
        ref, got = JK.nonlinear_effects(jm, q, v), TK.nonlinear_effects(tm, t64(q), t64(v))
    close(got, ref)


@pytest.mark.parametrize("case", ["standing", "airborne", "standing+f_ext+m_ext"])
def test_physics_step_matches_jax(models, case):
    jm, tm = models
    rng = np.random.default_rng(1)
    # standing: the feet 0-2 mm into the ground, so some rows are active
    q, v, _ = _states(2, z=0.232 if case.startswith("standing") else 1.0)
    q[:, 3:7] = JC.q0()[3:7]
    q[:, 7:] = JC.q0()[7:] + rng.normal(size=(B, 12)) * 0.05
    v *= 0.2
    tau = rng.normal(size=(B, 12)) * 2.0  # some beyond the 2.7 N m limit
    f_ext = m_ext = None
    if "f_ext" in case:
        f_ext, m_ext = rng.normal(size=(B, 3)) * 5.0, rng.normal(size=(B, 3))
    jstate, jinfo = JP.step(jm, EFF, JSP, JP.SimState(q=q, v=v), tau, f_ext=f_ext, m_ext=m_ext)
    tstate, tinfo = TP.step(
        tm, EFF, convert.sim_params_from(JSP), convert.sim_state_from(JP.SimState(q=q, v=v)),
        t64(tau),
        f_ext=None if f_ext is None else t64(f_ext), m_ext=None if m_ext is None else t64(m_ext))
    active = np.asarray(jinfo.in_contact)
    assert active.any() if case.startswith("standing") else not active.any()
    close(tstate.q, jstate.q)
    close(tstate.v, jstate.v)
    close(tinfo.forces, jinfo.forces)
    close(tinfo.positions, jinfo.positions)
    np.testing.assert_array_equal(tinfo.in_contact.numpy(), active)


@pytest.mark.parametrize("with_f_scale", [False, True])
def test_id_controller_matches_jax(models, with_f_scale):
    jm, tm = models
    q, v, a = _states(3)
    q_des, v_des, _ = _states(4)
    f_ff = np.random.default_rng(5).normal(size=(B, 12)) * 5.0
    f_scale = np.random.default_rng(6).uniform(0.0, 1.0, size=(B, 4)) if with_f_scale else None
    jg = JCt.IdControllerGains(kp=12.0, kd=0.5)
    ref = JCt.id_joint_torques(jm, EFF, jg, q, v, q_des, v_des, a, f_ff, f_scale=f_scale)
    got = TCt.id_joint_torques(tm, EFF, convert.gains_from(jg), t64(q), t64(v), t64(q_des),
                               t64(v_des), t64(a), t64(f_ff),
                               f_scale=None if f_scale is None else t64(f_scale))
    for g, r in zip(got, ref):
        close(g, r)


def test_rot_to_rpy_matches_jax():
    q, _, _ = _states(7)
    R = JQ.quat_to_rot(q[:, 3:7])
    close(TQ.rot_to_rpy(t64(np.asarray(R))), JQ.rot_to_rpy(R), atol=1e-14)


def test_settle_matches_jax(models):
    """The PD settle holds the joints at 6x trot_sim's gains against the
    2.7 N m torque limit, so the airborne legs chatter and a 1e-17
    difference grows ~7.5x a step (1e-16 rounding reaches 4e-9 in v by step
    10): 5 steps agree to 1e-10."""
    jm, tm = models
    ms = 5
    q0 = np.tile(JC.q0(), (2, 1))
    q0[1, 7:] += 0.05
    js = jax.jit(jax.vmap(lambda q: JR.settle_state(
        jm, EFF, JSP, JP.SimState(q=q, v=jnp.zeros(18)), 12.0, 0.5, ms=ms)))(q0)
    ts = TR.settle_state(tm, EFF, convert.sim_params_from(JSP),
                         TP.SimState(q=t64(q0), v=torch.zeros(2, 18, dtype=torch.float64)),
                         12.0, 0.5, ms=ms)
    close(ts.q, js.q)
    close(ts.v, js.v)


def test_settled_start_stands_where_jax_stands(models):
    """After the full 500 ms (``workload.settled_start``) the port stands at
    the JAX package's settled height (its 500 ms settle in f64, stored with
    the closed-loop reference) to 2 mm, every foot within 1 mm of the ground
    and roll and pitch under 1 degree."""
    _, tm = models
    ref_q = np.load(REF.FIXTURE)["q0"]
    s = workload.settled_start(1, device="cpu", dtype=torch.float64)
    close(s.q[0, 2], ref_q[2], atol=2e-3)
    feet = TK.frame_positions(tm, s.q, EFF)[..., 2]
    assert bool(((feet - 0.018).abs() < 1e-3).all())  # every foot on the ground
    rp = TQ.rot_to_rpy(TQ.quat_to_rot(s.q[:, 3:7]))[:, 0:2]
    assert bool((rp.abs() < np.deg2rad(1.0)).all())


def test_terrain_is_left_for_later(models):
    """Terrain, once refused, is ported: a zero heightfield steps exactly as
    flat ground, and a plateau under the feet measures their penetration
    from it (here every foot is above a ground 2 cm below z = 0)."""
    _, tm = models
    q = t64(np.tile(JC.q0(), (2, 1)))
    q[1, 2] -= 0.02
    st = TP.SimState(q=q, v=torch.zeros(2, 18, dtype=torch.float64))
    tau = torch.zeros(2, 12, dtype=torch.float64)

    def ground(h):
        return TP.Terrain(heights=torch.full((10, 10), h, dtype=torch.float64),
                          origin=(-1.0, -1.0), cell=0.2)

    flat = TP.step(tm, EFF, TP.SimParams(), st, tau)
    zero = TP.step(tm, EFF, TP.SimParams(), st, tau, terrain=ground(0.0))
    for a, b in zip(flat, zero):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert bool(flat[1].in_contact[1].all())
    low = TP.step(tm, EFF, TP.SimParams(), st, tau, terrain=ground(-0.02))
    assert not bool(low[1].in_contact.any())
