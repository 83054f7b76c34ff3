"""The last public functions of the JAX package's solver, MPC, kinematics,
rotation and robot modules, against the JAX package on the same seeded
numpy inputs, in float64.

* ``fista.FistaResult`` from ``solve_fixed_step``, ``solve_diag_step`` and
  the backtracking ``solve`` on a batch of box-constrained least squares:
  ``x`` and ``g_norm`` within 1e-12, ``L`` within 1e-12 relative, ``iters``
  equal.
* ``centroidal.ax_dense``/``af_dense`` on a seeded plan: equal within 1e-15.
* ``gait.contact_phase_plan``, ``kin.frame_position``, the rotation and SE(3)
  helpers of ``utils/quat.py``, ``model.compose_inertia``/
  ``transform_inertia``: within 1e-12 (the flags of the phase plan equal).
* ``assets_io.save_model``: the three robot assets round-trip through
  ``load_model`` exactly and the file holds the JAX package's arrays.
* ``kino_dyn.solve_mpc`` and ``acyclic.solve_acyclic_mpc`` on the plain
  backends: bit-equal to a one-row batch call, and within the gait tests'
  1e-6 (ADMM iterations equal) of the JAX package's solve of problem 0 in
  the committed fixtures (tests/fixtures/torch_gaits_solo12.npz,
  tests/fixtures/torch_acyclic_solo12.npz).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_acyclic_reference as AREF
import torch_gaits_reference as GREF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.kin import algorithms as JK
from bunmpc_tpu.mpc import centroidal as JC
from bunmpc_tpu.mpc import gait as JG
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot as jtrot
from bunmpc_tpu.robots import assets_io as JIO
from bunmpc_tpu.robots import model as JM
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu.solvers import fista as JF
from bunmpc_tpu.utils import quat as JQ
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.kin import algorithms as TK
from bunmpc_tpu_torch.mpc import acyclic as TAC
from bunmpc_tpu_torch.mpc import centroidal as TC
from bunmpc_tpu_torch.mpc import gait as TG
from bunmpc_tpu_torch.mpc import kino_dyn as TKD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS
from bunmpc_tpu_torch.robots import assets_io as TIO
from bunmpc_tpu_torch.robots import model as TM
from bunmpc_tpu_torch.robots.go2 import Go2Config
from bunmpc_tpu_torch.robots.solo8 import Solo8Config
from bunmpc_tpu_torch.robots.solo12 import Solo12Config
from bunmpc_tpu_torch.solvers import fista as TF
from bunmpc_tpu_torch.solvers.biconvex import BiconvexConfig
from bunmpc_tpu_torch.utils import quat as TQ

F64 = torch.float64


def t64(a):
    return torch.as_tensor(np.array(a), dtype=F64)


def close(got, ref, tol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol, rtol=0)


# --- FistaResult ---


def lsq(seed=1, B=6, n=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, 8, n)), rng.normal(size=(B, 8)), 0.3 * np.ones(n)


@pytest.mark.parametrize("variant", ["fixed_step", "diag_step", "linesearch"])
def test_fista_result_matches_jax(variant):
    A, b, box = lsq()
    B, n = A.shape[0], A.shape[2]
    cfg_kw = dict(max_iters=80, tol=1e-7)
    Aj, bj, At, bt = jnp.asarray(A), jnp.asarray(b), t64(A), t64(b)

    def grads(A_, b_, swap):
        def res(x):
            return (A_ @ x[..., None])[..., 0] - b_

        return res, lambda x: 2.0 * (swap(A_) @ res(x)[..., None])[..., 0]

    res_j, grad_j = grads(Aj, bj, lambda a: jnp.swapaxes(a, 1, 2))
    res_t, grad_t = grads(At, bt, lambda a: a.transpose(1, 2))
    proj_j, proj_t = JF.box_projector(-box, box), TF.box_projector(t64(-box), t64(box))
    # per-problem Lipschitz constants of the gradient, and a Jacobi metric
    L = 2.0 * np.linalg.norm(A, ord=2, axis=(1, 2)) ** 2 * 1.1
    D = np.maximum(2.0 * np.einsum("bij,bij->bj", A, A), 1e-3) * n
    if variant == "fixed_step":
        ref = JF.solve_fixed_step(jnp.zeros((B, n)), grad_j, proj_j, jnp.asarray(L),
                                  JF.FistaConfig(**cfg_kw))
        got = TF.solve_fixed_step(torch.zeros(B, n, dtype=F64), grad_t, proj_t, t64(L),
                                  TF.FistaConfig(**cfg_kw))
    elif variant == "diag_step":
        ref = JF.solve_diag_step(jnp.zeros((B, n)), grad_j, proj_j, jnp.asarray(D),
                                 JF.FistaConfig(**cfg_kw))
        got = TF.solve_diag_step(torch.zeros(B, n, dtype=F64), grad_t, proj_t, t64(D),
                                 TF.FistaConfig(**cfg_kw))
    else:
        ref = JF.solve(jnp.zeros((B, n)), grad_j,
                       lambda x1, x0: (res_j(x1) ** 2).sum(-1) - (res_j(x0) ** 2).sum(-1),
                       proj_j, 1.0, JF.FistaConfig(**cfg_kw))
        got = TF.solve(torch.zeros(B, n, dtype=F64), grad_t,
                       lambda x1, x0: (res_t(x1) ** 2).sum(-1) - (res_t(x0) ** 2).sum(-1),
                       proj_t, 1.0, TF.FistaConfig(**cfg_kw))
    assert isinstance(got, TF.FistaResult) and got._fields == JF.FistaResult._fields
    close(got.x, ref.x)
    np.testing.assert_allclose(got.L.numpy(), np.asarray(ref.L), rtol=1e-12, atol=0)
    assert got.iters.dtype == torch.int32
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    close(got.g_norm, ref.g_norm)
    # some problems converge before the cap, so the per-problem counts differ
    assert got.iters.min() < got.iters.max() or got.iters.max() < cfg_kw["max_iters"]


# --- dense operators, the phase plan, a frame position ---


def plan_draw(seed=2, H=6, ne=4):
    rng = np.random.default_rng(seed)
    return (rng.random((H, ne)) > 0.4).astype(np.float64), rng.normal(size=(H, ne, 3)) * 0.2, \
        rng.uniform(0.03, 0.06, H), rng.normal(size=(H + 1, 9)), rng.normal(size=(H, ne, 3))


def test_dense_operators_match_jax():
    cnt, r, dt, X, F = plan_draw()
    jp = JC.ContactPlan(cnt=jnp.asarray(cnt), r=jnp.asarray(r), dt=jnp.asarray(dt))
    tp = TC.ContactPlan(cnt=t64(cnt), r=t64(r), dt=t64(dt))
    m = 2.5
    close(TC.ax_dense(tp, m, t64(X)), JC.ax_dense(jp, m, jnp.asarray(X)), 1e-15)
    close(TC.af_dense(tp, m, t64(F)), JC.af_dense(jp, m, jnp.asarray(F)), 1e-15)
    # the dense matrices are the stencils the solver applies
    Ax = TC.ax_dense(tp, m, t64(X))
    close(Ax @ F.reshape(-1), TC.ax_apply(tp, m, t64(X), t64(F)).reshape(-1).numpy(), 1e-12)


def test_contact_phase_plan_matches_jax():
    tspec = TKD.make_cyclic_spec(Solo12Config.load_model(), GAITS["trot"], Solo12Config.q0(),
                                 device="cpu")
    jspec = JKD.make_cyclic_spec(JSolo.load_model(), jtrot, JSolo.q0())
    t = np.random.default_rng(3).uniform(0.0, 1.0, size=(5,))
    ref = np.asarray(JG.contact_phase_plan(jspec.gait, jnp.asarray(t), 12, 0.05))
    got = TG.contact_phase_plan(tspec.gait, t64(t), 12, 0.05).numpy()
    assert got.shape == ref.shape == (5, 12, 4)
    np.testing.assert_array_equal(got, ref)


def test_frame_position_matches_jax():
    model, jmodel = Solo12Config.load_model(), JSolo.load_model()
    rng = np.random.default_rng(4)
    q = np.tile(Solo12Config.q0(), (3, 1))
    q[:, 7:] += rng.normal(size=(3, 12)) * 0.2
    q[:, 3:7] = q[:, 3:7] + rng.normal(size=(3, 4)) * 0.1
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=-1, keepdims=True)
    for name in Solo12Config.eff_names:
        close(TK.frame_position(model, t64(q), name),
              JK.frame_position(jmodel, jnp.asarray(q), name))


# --- rotations and SE(3) ---


def rotation_draws(seed=5, n=16):
    rng = np.random.default_rng(seed)
    rpy = rng.uniform(-np.pi, np.pi, size=(n, 3))
    rpy[:, 1] /= 2.0
    rpy[:4] = [[0, 0, 0], [np.pi, 0, 0], [0, 0, np.pi], [1e-7, -2e-7, 3e-7]]  # the branches
    return rpy


def test_rotation_helpers_match_jax():
    rpy = rotation_draws()
    R_ref = np.asarray(JQ.rpy_to_rot(jnp.asarray(rpy)))
    close(TQ.rpy_to_rot(t64(rpy)), R_ref)
    close(TQ.rot_to_quat(t64(R_ref)), JQ.rot_to_quat(jnp.asarray(R_ref)))
    close(TQ.log3(t64(R_ref)), JQ.log3(jnp.asarray(R_ref)), 1e-10)
    close(TQ.rot_x(t64(rpy[:, 0])), JQ.rot_x(jnp.asarray(rpy[:, 0])))
    # the port's own round trip
    close(TQ.quat_to_rot(TQ.rot_to_quat(t64(R_ref))), R_ref)


@pytest.mark.parametrize("name", ["se3_left_jacobian", "se3_left_jacobian_inv",
                                  "se3_right_jacobian", "se3_right_jacobian_inv",
                                  "se3_adjoint_exp"])
def test_se3_helpers_match_jax(name):
    rng = np.random.default_rng(6)
    rho, w = rng.normal(size=(8, 3)), rng.normal(size=(8, 3))
    w[:2] *= 1e-6  # the small-angle branches
    got = getattr(TQ, name)(t64(rho), t64(w))
    ref = getattr(JQ, name)(jnp.asarray(rho), jnp.asarray(w))
    assert got.shape == (8, 6, 6)
    close(got, ref, 1e-11)


# --- inertia helpers and asset files ---


def test_inertia_helpers_match_jax():
    rng = np.random.default_rng(7)

    def sym():
        a = rng.normal(size=(3, 3))
        return a @ a.T

    m1, m2, c1, c2, I1, I2 = 0.7, 1.3, rng.normal(size=3), rng.normal(size=3), sym(), sym()
    for got, ref in zip(TM.compose_inertia(m1, c1, I1, m2, c2, I2),
                        JM.compose_inertia(m1, c1, I1, m2, c2, I2)):
        close(got, ref, 1e-15)
    assert TM.compose_inertia(0.0, c1, I1, 0.0, c2, I2)[0] == 0.0
    R = np.asarray(JQ.rpy_to_rot(jnp.asarray([0.3, -0.2, 1.1])))
    p = rng.normal(size=3)
    for got, ref in zip(TM.transform_inertia(R, p, m1, c1, I1),
                        JM.transform_inertia(R, p, m1, c1, I1)):
        close(got, ref, 1e-15)


def model_arrays(model):
    return {k: getattr(model, k) for k in ("parent", "joint_rot", "joint_pos", "axis", "mass",
                                           "com", "inertia", "joint_lower", "joint_upper",
                                           "velocity_limit", "effort_limit")}


@pytest.mark.parametrize("config", [Solo12Config, Go2Config, Solo8Config],
                         ids=["solo12", "go2", "solo8"])
def test_save_model_round_trips(config, tmp_path):
    model = config.load_model()
    TIO.save_model(model, str(tmp_path / "port.npz"))
    back = TIO.load_model(str(tmp_path / "port.npz"))
    assert (back.name, back.n_joints, back.joint_names) == \
        (model.name, model.n_joints, model.joint_names)
    for k, a in model_arrays(model).items():
        np.testing.assert_array_equal(getattr(back, k), a, err_msg=k)
    assert list(back.frames) == list(model.frames)
    for n, f in model.frames.items():
        g = back.frames[n]
        assert g.body == f.body
        np.testing.assert_array_equal(g.rot, f.rot)
        np.testing.assert_array_equal(g.pos, f.pos)
    # the same arrays the JAX package writes for the same model
    JIO.save_model(model, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- the single-problem solves ---


def test_solve_mpc_is_a_batch_of_one():
    g = GAITS["trot"]
    spec = TKD.make_cyclic_spec(Solo12Config.load_model(), g, Solo12Config.q0(), device="cpu")
    st = [t64(a) for a in GREF.inputs("trot")]
    cfg = BiconvexConfig(rho=g.rho, x_solver="thomas", fista_max_iters=30)
    one = TKD.solve_mpc(spec, *(a[0] for a in st), admm_cfg=cfg, admm_backend="torch",
                        ik_backend="torch")
    row = TKD.solve_mpc_batch(spec, *(a[:1] for a in st), admm_cfg=cfg, admm_backend="torch",
                              ik_backend="torch")
    for field in TKD.MpcPlan._fields:
        a, b = getattr(one, field), getattr(row, field)
        assert a.shape == b.shape[1:], field
        assert torch.equal(a, b[0]), field
    # the JAX package's solve of the same problem (the gaits fixture's problem 0)
    ref = dict(np.load(GREF.FIXTURE))
    got = convert.plan_to_numpy(one)
    for field in TKD.MpcPlan._fields:
        want = ref[f"trot/{field}"][0]
        if field == "admm_iters":
            np.testing.assert_array_equal(got[field], want)
        else:
            np.testing.assert_allclose(got[field], want, atol=1e-6, rtol=0, err_msg=field)
    # touchdown noise and a warm start reach the batch call alike
    noise = np.random.default_rng(8).normal(size=(spec.horizon, 4, 2)) * 0.01
    warm = (row.X_opt[0], row.F_opt[0], row.P_opt[0])
    a = TKD.solve_mpc(spec, *(x[0] for x in st), admm_cfg=cfg, noise_xy=noise, warm_start=warm,
                      admm_backend="torch", ik_backend="torch")
    b = TKD.solve_mpc_batch(spec, *(x[:1] for x in st), admm_cfg=cfg, noise_xy=noise[None],
                            warm_start=tuple(w[None] for w in warm), admm_backend="torch",
                            ik_backend="torch")
    assert all(torch.equal(x, y[0]) for x, y in zip(a, b))


def test_solve_acyclic_mpc_is_a_batch_of_one():
    name = "jump_fwd"
    spec = workload.acyclic_spec(name, device="cpu", plan_freq=AREF.PLAN_FREQ.get(name))
    q, v, t = (t64(a) for a in AREF.inputs(name))
    one = TAC.solve_acyclic_mpc(spec, q[0], v[0], t[0], admm_backend="torch", ik_backend="torch")
    row = TAC.solve_acyclic_mpc_batch(spec, q[:1], v[:1], t[:1], admm_backend="torch",
                                      ik_backend="torch")
    for field in TKD.MpcPlan._fields:
        assert torch.equal(getattr(one, field), getattr(row, field)[0]), field
    ref = dict(np.load(AREF.FIXTURE))
    got = convert.plan_to_numpy(one)
    assert ref[f"{name}/dyn_violation"][0] < 1e3
    for field in TKD.MpcPlan._fields:
        want = ref[f"{name}/{field}"][0]
        if field == "admm_iters":
            np.testing.assert_array_equal(got[field], want)
        else:
            np.testing.assert_allclose(got[field], want, atol=1e-6, rtol=0, err_msg=field)
