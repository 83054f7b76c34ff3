"""The Solo8 in the port (``robots/solo8.py``, ``mpc/motions/solo8_cyclic.py``,
8 joints through ``mpc/kino_dyn.py`` and K2 built for 8 joints) against the
JAX package's, on the same seeded numpy inputs.

* The robot: ``Solo8Config`` and the model loaded from the byte-identical
  asset equal the JAX package's; ``build_solo8_model()`` reproduces the
  asset; tests/test_solo8.py's invariants hold on the port's dynamics (M
  symmetric and positive definite, RNEA = M a + b, mirrored feet); its
  tree is what K2 is built for (joint j's parent is the base or body j).
* The trot table and its spec ("solo12_hip" offsets on the HFE frames, the
  "tiled" start): equal fields, offsets and composite inertia within 1e-12.
* Problem assembly in float64 against the eager JAX ``_prepare_problem``
  (``tests/fixtures/torch_solo8.npz``), and K3's plain prologue against the
  JAX package's ``prep_values`` in float32 and the port's assembly in
  float64.
* The whole plain path in float64 against the JAX package's ("xla", "xla")
  at B=2 with bench.py's ADMM config: every ``MpcPlan`` field within atol
  1e-6 and equal ADMM iteration counts. Problem 0 (tests/test_solo8.py's
  window) meets its bounds: violation < 1e-3, mean stance Fz within 6 N of
  m g. The ``slow`` test regenerates the fixture.
* The kernels' per-problem math (g++ builds) on Solo8 problems: K2 built
  for 8 joints against its plain version, K1 and K3 against theirs.
* A joint count K2 is not built for raises.
"""

import ctypes
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
import torch_solo8_reference as REF
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions import solo8_cyclic as jsolo8
from bunmpc_tpu.robots.solo8 import Solo8Config as JC
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.kin import algorithms as TK
from bunmpc_tpu_torch.mpc import ik as TIK
from bunmpc_tpu_torch.mpc import kino_dyn as TKD
from bunmpc_tpu_torch.mpc.motions import solo8_cyclic as tsolo8
from bunmpc_tpu_torch.robots.solo8 import Solo8Config as TC
from bunmpc_tpu_torch.robots.solo8 import build_solo8_model
from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused
from bunmpc_tpu_torch.solvers.biconvex import BiconvexConfig
from torch_port_helpers import call_host, host_lib

F64 = torch.float64
ATOL = 1e-9
MG = 2.1154 * 9.81
MODEL_FIELDS = ("parent", "joint_rot", "joint_pos", "axis", "mass", "com", "inertia",
                "joint_lower", "joint_upper", "velocity_limit", "effort_limit")


def test_solo8_config_and_model_match_jax():
    for f in ("name", "eff_names", "hip_names", "n_eff", "foot_size"):
        assert getattr(TC, f) == getattr(JC, f), f
    np.testing.assert_array_equal(TC.q0(), JC.q0())
    tm, jm = TC.load_model(), JC.load_model()
    assert (tm.name, tm.n_joints, tm.joint_names) == (jm.name, jm.n_joints, jm.joint_names)
    for f in MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), err_msg=f)
    assert set(tm.frames) == set(jm.frames)
    for name, fr in tm.frames.items():
        assert fr.body == jm.frames[name].body
        np.testing.assert_array_equal(fr.pos, jm.frames[name].pos)
    # tests/test_solo8.py:32-39
    assert tm.n_joints == 8 and tm.nq == 15 and tm.nv == 14
    assert abs(tm.total_mass - 2.1154) < 1e-3


def test_build_solo8_model_reproduces_the_asset():
    built, asset = build_solo8_model(), TC.load_model()
    assert built.joint_names == asset.joint_names and set(built.frames) == set(asset.frames)
    for f in MODEL_FIELDS:
        np.testing.assert_allclose(getattr(built, f), getattr(asset, f), atol=1e-12, rtol=0,
                                   err_msg=f)
    for name, fr in built.frames.items():
        assert fr.body == asset.frames[name].body
        np.testing.assert_allclose(fr.pos, asset.frames[name].pos, atol=1e-12, rtol=0)


def test_solo8_dynamics_invariants():
    """tests/test_solo8.py:42-55 on the port's dynamics."""
    model = TC.load_model()
    rng = np.random.default_rng(0)
    q = np.concatenate([rng.normal(size=3), [0.1, -0.2, 0.3, 0.9], rng.normal(size=8) * 0.4])
    q[3:7] /= np.linalg.norm(q[3:7])
    q = torch.as_tensor(q, dtype=F64)
    v = torch.as_tensor(rng.normal(size=14) * 0.5, dtype=F64)
    a = torch.as_tensor(rng.normal(size=14), dtype=F64)
    M = TK.mass_matrix(model, q)
    assert float((M - M.T).abs().max()) < 1e-10
    assert float(torch.linalg.eigvalsh(M).min()) > 0
    tau = TK.rnea(model, q, v, a)
    bias = TK.nonlinear_effects(model, q, v)
    np.testing.assert_allclose(tau.numpy(), (M @ a + bias).numpy(), atol=1e-10)


def test_solo8_symmetry():
    """tests/test_solo8.py:58-80 on the port's kinematics: mirrored feet at
    the standing q0, each foot at the same offset from its hip, the feet on
    the ground."""
    model = TC.load_model()
    q0 = torch.as_tensor(workload.solo8_q0(), dtype=F64)
    feet = TK.frame_positions(model, q0, TC.eff_names).numpy()
    for left, right in ((0, 1), (2, 3)):
        np.testing.assert_allclose(feet[left, [0, 2]], feet[right, [0, 2]], atol=1e-9)
        np.testing.assert_allclose(feet[left, 1], -feet[right, 1], atol=1e-9)
    rel = feet - TK.frame_positions(model, q0, TC.hip_names).numpy()
    flip_y = np.array([1.0, -1.0, 1.0])
    np.testing.assert_allclose(rel[0], rel[2], atol=1e-9)
    np.testing.assert_allclose(rel[0], rel[1] * flip_y, atol=1e-9)
    np.testing.assert_allclose(rel[2], rel[3] * flip_y, atol=1e-9)
    np.testing.assert_allclose(feet[:, 2], TC.foot_size, atol=2e-3)


def test_the_kernel_takes_the_solo8_tree():
    """K2 keeps only the base's and the previous body's tangents: every
    joint's parent must be the base or the previous joint's body. The Solo8's
    tree is that (HFE on the base, KFE on the HFE link), and its model buffer
    has the 8-joint layout the kernel reads."""
    model = TC.load_model()
    assert list(model.parent) == [0, 1, 0, 3, 0, 5, 0, 7]
    assert all(int(p) in (0, j) for j, p in enumerate(model.parent))
    buf = cuda_ddp.pack_model(model, tuple(TC.eff_names))
    nj, nb = 8, 9
    assert buf.shape == (16 * nj + 13 * nb + 4 + 12 + 1,)
    assert abs(buf[-1] - model.total_mass) < 1e-15
    np.testing.assert_array_equal(buf[16 * nj + 13 * nb: 16 * nj + 13 * nb + 4], [2, 4, 6, 8])


def test_other_joint_counts_raise():
    """K2 is built for 12 and 8 joints: a model of another count raises in
    ``make_cyclic_spec`` and in the kernel's model packing, naming the
    counts; so does a tree that is not chains off the base."""
    ten = dataclasses.replace(TC.load_model(), name="ten", n_joints=10)
    with pytest.raises(ValueError, match="12 or 8 joints"):
        TKD.make_cyclic_spec(ten, tsolo8.trot, workload.solo8_q0(), device="cpu")
    with pytest.raises(ValueError, match="12 or 8 joints"):
        cuda_ddp.pack_model(ten, tuple(TC.eff_names))
    crossed = dataclasses.replace(TC.load_model(), parent=np.array([0, 1, 0, 3, 0, 5, 0, 2]))
    with pytest.raises(ValueError, match="chains off the base"):
        cuda_ddp.pack_model(crossed, tuple(TC.eff_names))


def jax_spec():
    return REF.jax_spec(jsolo8.trot)


def test_gait_table_and_spec_match_jax():
    assert list(tsolo8.GAITS) == list(jsolo8.GAITS) == ["trot"]
    for f in dataclasses.fields(jsolo8.trot):
        np.testing.assert_array_equal(np.asarray(getattr(tsolo8.trot, f.name)),
                                      np.asarray(getattr(jsolo8.trot, f.name)), err_msg=f.name)
    tspec, jspec = workload.solo8_spec(device="cpu"), jax_spec()
    assert tspec.warm_start_style == jspec.warm_start_style == "tiled"
    np.testing.assert_allclose(tspec.hip_offsets, np.asarray(jspec.hip_offsets), atol=1e-12)
    np.testing.assert_allclose(tspec.I_comp, np.asarray(jspec.I_comp), atol=1e-12)
    assert (tspec.horizon, tspec.ik_hor, tspec.size, tspec.n_int) == (
        jspec.horizon, jspec.ik_hor, jspec.size, jspec.n_int) == (20, 10, 3, 150)
    assert tspec.gait == dataclasses.replace(
        tspec.gait, **{f.name: getattr(jspec.gait, f.name)
                       for f in dataclasses.fields(jspec.gait)})
    np.testing.assert_array_equal(tspec.x_reg, np.asarray(jspec.x_reg))


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


def test_prepare_problem_matches_jax(reference):
    tspec = workload.solo8_spec(device="cpu")
    tp = TKD._prepare_problem(tspec, *[torch.as_tensor(a, dtype=F64)
                                       for a in REF.prep_inputs("trot")])
    got = dict(tp, cnt=tp["plan"].cnt, r=tp["plan"].r, dt=tp["plan"].dt,
               lb=tp["x_bounds"][0], ub=tp["x_bounds"][1])
    for f in REF.PREP_FIELDS:
        a, b = got[f].numpy(), reference[f"trot/prep/{f}"]
        assert a.shape == b.shape, f
        if f in ("cnt", "swing_mask"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f)
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], atol=ATOL, rtol=0, err_msg=f)


def test_prep_values_matches_jax(reference):
    """K3's plain prologue on the Solo8's compact inputs: in float32 against
    the JAX package's ``prep_values`` under tests/test_fused_prep.py:95-116's
    gates; in float64 against the port's ``_prepare_problem`` within 1e-12."""
    tspec = workload.solo8_spec(device="cpu")
    pc = TKD.make_prep_consts(tspec)
    jpc = cuda_fused.PrepConsts(**dataclasses.asdict(JKD.make_prep_consts(jax_spec())))
    np.testing.assert_allclose(pc.as_array(), jpc.as_array(), rtol=1e-12, atol=0)
    m, H, ne = float(tspec.model.total_mass), tspec.horizon, tspec.n_eff
    ci = REF.compact_inputs("trot")
    for f in REF.COMPACT:
        np.testing.assert_array_equal(ci[f], reference[f"trot/compact/{f}"], err_msg=f)
    got = dict(zip(REF.PREP_VALUES, (a.numpy() for a in cuda_fused.prep_values(
        *[torch.as_tensor(ci[f]) for f in REF.COMPACT], pc=pc, m=m, H=H, ne=ne))))
    ref = {f: reference[f"trot/prep_values/{f}"] for f in REF.PREP_VALUES}
    np.testing.assert_array_equal(got["cnt"], ref["cnt"])
    np.testing.assert_array_equal(got["swing"], ref["swing"])
    np.testing.assert_allclose(got["r"], ref["r"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["dt"], ref["dt"], atol=1e-6, rtol=0)
    for f in ("W", "WF"):
        np.testing.assert_allclose(got[f], ref[f], rtol=1e-6)
    np.testing.assert_allclose(got["qlin"], ref["qlin"], rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got["lb"], ref["lb"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got["ub"], ref["ub"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got["X0"], ref["X0"], atol=1e-5, rtol=0)
    assert np.all(got["qF"] == 0.0) and np.all(got["F0"] == 0.0) and np.all(ref["F0"] == 0.0)

    st = [torch.as_tensor(a, dtype=F64) for a in REF.prep_inputs("trot")]
    _, t, vdw, x_init, ee, hip, amom = TKD._compact_inputs(tspec, *st)
    got = cuda_fused.prep_values(t, vdw, st[4], x_init, ee, hip, amom, pc=pc, m=m, H=H, ne=ne)
    pr = TKD._prepare_problem(tspec, *st)
    pairs = {"cnt": pr["plan"].cnt, "r": pr["plan"].r, "dt": pr["plan"].dt,
             "swing": pr["swing_mask"], "W": pr["W"], "qlin": -2.0 * pr["W"] * pr["X_ref"],
             "WF": pr["W_F"], "qF": torch.zeros_like(pr["W_F"]), "lb": pr["x_bounds"][0],
             "ub": pr["x_bounds"][1], "X0": pr["X_wm"], "F0": pr["F_wm"]}
    for key, a in zip(REF.PREP_VALUES, got):
        b = pairs[key].to(F64)
        assert a.shape == b.shape, key
        fin = torch.isfinite(b)  # the prologue's box holds a large sentinel where unbounded
        assert torch.all(a[~fin].abs() > 1e30), key
        torch.testing.assert_close(a.to(F64)[fin], b[fin], atol=1e-12, rtol=0, msg=key)


def test_plain_path_matches_jax(reference):
    tspec = workload.solo8_spec(device="cpu")
    st = [torch.as_tensor(a, dtype=F64) for a in REF.inputs("trot")]
    plan = TKD.solve_mpc_batch(
        tspec, *st, admm_cfg=BiconvexConfig(rho=tsolo8.trot.rho, x_solver="thomas",
                                            fista_max_iters=30),
        admm_backend="torch", ik_backend="torch")
    got = convert.plan_to_numpy(plan)
    for field in TKD.MpcPlan._fields:
        ref = reference[f"trot/{field}"]
        assert got[field].shape == ref.shape, field
        if field == "admm_iters":
            np.testing.assert_array_equal(got[field], ref, err_msg=field)
        else:
            np.testing.assert_allclose(got[field], ref, atol=1e-6, rtol=0, err_msg=field)
    assert got["xs_int"].shape[-1] == 15 + 14
    # problem 0, tests/test_solo8.py:83-102's window: its bounds
    assert got["dyn_violation"][0] < 1e-3
    cnt, F = got["cnt_plan"][0, ..., 0], got["F_opt"][0]
    assert abs((cnt * F[..., 2]).sum(-1).mean() - MG) < 6.0


@pytest.mark.slow
def test_fixture_is_the_jax_solo8_solve():
    """The committed reference is what the JAX package computes today (a few
    minutes: one compile of the JAX solve)."""
    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)


# ---- the kernels' per-problem math (g++ builds) on Solo8 problems ----


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return {name: host_lib(name, tmp_path_factory) for name in ("admm", "ddp", "fused")}


def solo8_problems(n=4, gait_horizon=None):
    """The Solo8 trot's problems at bench.py's draws; with ``gait_horizon``
    the trot over that many gait periods with the IK over the whole horizon
    (ik_hor_ratio 1)."""
    spec = workload.solo8_spec(device="cpu")
    if gait_horizon is not None:
        spec = TKD.make_cyclic_spec(
            spec.model, dataclasses.replace(tsolo8.trot, gait_horizon=gait_horizon),
            workload.solo8_q0(), eff_frames=spec.eff_frames, hip_frames=tuple(TC.hip_names),
            foot_size=TC.foot_size, ik_hor_ratio=1.0, device="cpu")
    st = [torch.as_tensor(a, dtype=F64) for a in workload.solo8_states(n)]
    pr = TKD._prepare_problem(spec, *st)
    args = (pr["plan"], spec.model.total_mass, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"],
            pr["X_wm"], pr["F_wm"], pr["x_bounds"])
    return spec, st, pr, args


def test_k1_kernel_math_on_solo8(libs):
    """K1's g++ build in f64 on Solo8 problems (a 2.1 kg robot) with bench.py's
    config: X, F, P within 1e-7, equal iterations, every problem converged."""
    spec, _, _, args = solo8_problems()
    cfg = cuda_admm.CudaAdmmConfig(rho=tsolo8.trot.rho, fista_max_iters=30)
    kargs, keep, out = cuda_admm.kernel_args(*args, cfg)
    call_host(libs["admm"], "admm_host_f64", cuda_admm.ARGTYPES, kargs)
    ref = cuda_admm.solve_plain(*args, cfg)
    np.testing.assert_array_equal(out[3].numpy(), ref[3].numpy())
    assert bool((ref[2] < cfg.exit_tol).all())
    for i, j in ((0, 0), (1, 1), (5, 4)):
        np.testing.assert_allclose(out[i].numpy(), ref[j].numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("ik_hor", [10, 30])
def test_k2_kernel_math_at_8_joints(libs, ik_hor):
    """K2's g++ build at 8 joints (nv 14, ndx 28) with the Solo8's model
    buffer on the Solo8's own IK problems, built from the plain ADMM's
    solves, at the trot's IK horizon (10) and at the acyclic motions'
    longest (30: the trot over 3 periods, ik_hor_ratio 1): one Gauss-Newton step
    with one alpha in f64 (tests/test_torch_go2.py's gates: xs 1e-9, us 1e-7,
    cost rtol 1e-10) and the full DdpConfig at the plan's f64 gate (xs 1e-6,
    us 1e-6 / dt, cost rtol 1e-10)."""
    spec, st, pr, args = solo8_problems(gait_horizon=None if ik_hor == 10 else 3.0)
    model, eff = spec.model, spec.eff_frames
    X = cuda_admm.solve_plain(*args, cuda_admm.CudaAdmmConfig(rho=tsolo8.trot.rho,
                                                              fista_max_iters=30))[0]
    tasks, x0 = TKD._build_ik_tasks(spec, pr, X)
    w_stage, w_term, ctrl_w, x_reg = TIK.dense_weights(model, eff, tasks)
    dargs = (x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, x_reg, w_stage, w_term, ctrl_w,
             tasks.dts)
    assert dargs[-1].shape[1] == ik_hor and x0.shape[1] == 29
    for cfg_, xs_tol, us_tol, c_tol in (
            (cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,)), 1e-9, 1e-7, 1e-10),
            (cuda_ddp.CudaDdpConfig(), 1e-6, 1e-6 / 0.05, 1e-10)):
        kargs, keep, out = cuda_ddp.kernel_args(model, eff, *dargs, cfg_)
        assert kargs[0] == 8
        call_host(libs["ddp"], "ddp_host_f64", cuda_ddp.ARGTYPES, kargs)
        ref = cuda_ddp.solve_ik_batch_plain(model, eff, *dargs, cfg=cfg_)
        np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=xs_tol, rtol=0)
        np.testing.assert_allclose(out[1].numpy(), ref[1].numpy(), atol=us_tol, rtol=0)
        np.testing.assert_allclose(out[2].numpy(), ref[2].numpy(), rtol=c_tol)


def test_k2_refuses_a_joint_count_it_is_not_built_for(libs):
    """The g++ build's entry point returns the refusal code for a joint
    count it holds no instantiation of, and writes nothing."""
    spec, st, pr, args = solo8_problems(1)
    X = cuda_admm.solve_plain(*args, cuda_admm.CudaAdmmConfig(rho=tsolo8.trot.rho))[0]
    tasks, x0 = TKD._build_ik_tasks(spec, pr, X)
    w = TIK.dense_weights(spec.model, spec.eff_frames, tasks)
    kargs, keep, out = cuda_ddp.kernel_args(
        spec.model, spec.eff_frames, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, w[3],
        w[0], w[1], w[2], tasks.dts, cuda_ddp.CudaDdpConfig())
    fn = libs["ddp"].ddp_host_f64
    fn.argtypes, fn.restype = cuda_ddp.ARGTYPES, ctypes.c_int
    out[2].fill_(7.0)
    assert fn(10, *kargs[1:]) == -2
    assert bool((out[2] == 7.0).all())


def test_k3_kernel_math_on_solo8(libs):
    """K3's g++ build in f64 on the Solo8's compact inputs against its plain
    version: the contact plan exact (flags) and within 1e-12, X and F within
    1e-7, equal iterations, every problem converged."""
    spec, st, _, _ = solo8_problems(6)
    _, t, vdw, x_init, ee, hip, amom = TKD._compact_inputs(spec, *st)
    ins = (t, vdw, st[4], x_init, ee, hip, amom)
    pc, m, H = TKD.make_prep_consts(spec), float(spec.model.total_mass), spec.horizon
    cfg = cuda_admm.CudaAdmmConfig(rho=tsolo8.trot.rho, fista_max_iters=30)
    kargs, keep, out = cuda_fused.kernel_args(*ins, m, pc, cfg, H, spec.n_eff)
    call_host(libs["fused"], "fused_host_f64", cuda_fused.ARGTYPES, kargs)
    X, F, viol, iters, cnt, r, dt, swing, _ = out
    ref = cuda_fused.solve_from_state(*ins, m, pc, cfg, H, spec.n_eff)
    assert torch.equal(cnt, ref[4]) and torch.equal(swing > 0.5, ref[7])
    torch.testing.assert_close(r, ref[5], atol=1e-12, rtol=0)
    torch.testing.assert_close(dt, ref[6], atol=1e-12, rtol=0)
    torch.testing.assert_close(X, ref[0], atol=1e-7, rtol=0)
    torch.testing.assert_close(F, ref[1], atol=1e-7, rtol=0)
    assert torch.equal(iters, ref[3]) and bool((viol < cfg.exit_tol).all())


def test_fused_path_matches_unfused_path_on_solo8():
    """The whole Solo8 solve with fuse_prep=True (K3's plain version) against
    the unfused solve, on the CPU in f64: every plan field within 1e-6,
    equal iterations."""
    spec = workload.solo8_spec(device="cpu")
    st = [torch.as_tensor(a, dtype=F64) for a in workload.solo8_states(4)]
    cfg = cuda_admm.CudaAdmmConfig(rho=tsolo8.trot.rho, fista_max_iters=30)
    fused = TKD.solve_mpc_batch(spec, *st, admm_cfg=cfg, fuse_prep=True)
    plain = TKD.solve_mpc_batch(spec, *st, admm_cfg=cfg)
    for field in TKD.MpcPlan._fields:
        if field == "P_opt":  # K3 keeps no dual
            continue
        a, b = getattr(fused, field), getattr(plain, field)
        if field == "admm_iters":
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=field)
