"""The Go2 in the port (``robots/go2.py``, ``mpc/motions/go2_cyclic.py``, the
generic foot offsets and the "vdes" warm start of ``mpc/kino_dyn.py``)
against the JAX package's, on the same seeded numpy inputs.

* The robot: ``Go2Config`` and the model loaded from the byte-identical
  asset equal the JAX package's; ``build_go2_model()`` reproduces the asset
  (1e-12: the same float operations in another order).
* The four gait tables and their specs (generic offsets, "vdes"): every
  table field equal; hip offsets and composite inertia within 1e-12, the
  horizon math equal; "solo12_hip" offsets on the Go2 as the JAX package
  computes them; a model K2 is not built for (10 joints) raises.
* Problem assembly in float64 against the eager JAX ``_prepare_problem``
  (``tests/fixtures/torch_go2.npz``): flags exact, every other field within
  atol 1e-9, ``F_ref`` of ``f_reg_style="weight"`` included. K3's plain
  prologue on the Go2's compact inputs: against the JAX package's
  ``prep_values`` in float32 under tests/test_fused_prep.py's gates, and
  against ``_prepare_problem`` in float64 within 1e-12.
* The whole plain path in float64 against the JAX package's ("xla", "xla")
  at B=2 with bench.py's ADMM config: every ``MpcPlan`` field within atol
  1e-6 and equal ADMM iteration counts (tests/test_torch_kino_dyn.py's
  gate). Problem 0 (the JAX Go2 tests' window) meets their bounds
  (tests/test_go2.py:156-164): violation < 1e-2, mean stance Fz within 40 N
  of m g. The ``slow`` test regenerates the fixture.
* The kernels' per-problem math (g++ builds) on Go2 problems: K1 in f64
  against its plain version (X, F within 1e-7, equal iterations; with a
  carried dual, P too), K2 with the Go2's model buffer against its plain
  version (one step at 1e-11, the full config at the plan's gate), K3
  against its plain version in f64 (X, F within 1e-7, equal iterations).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_go2_reference as REF
import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.kin import algorithms as JK
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions import go2_cyclic as jgo2
from bunmpc_tpu.robots.go2 import Go2Config as JC
from bunmpc_tpu_torch import convert, workload
from bunmpc_tpu_torch.kin import algorithms as TK
from bunmpc_tpu_torch.mpc import ik as TIK
from bunmpc_tpu_torch.mpc import kino_dyn as TKD
from bunmpc_tpu_torch.mpc.motions import go2_cyclic as tgo2
from bunmpc_tpu_torch.robots.go2 import Go2Config as TC
from bunmpc_tpu_torch.robots.go2 import build_go2_model
from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused
from bunmpc_tpu_torch.solvers.biconvex import BiconvexConfig
from torch_port_helpers import call_host, host_lib

F64 = torch.float64
ATOL = 1e-9
NAMES = list(jgo2.GAITS)
MODEL_FIELDS = ("parent", "joint_rot", "joint_pos", "axis", "mass", "com", "inertia",
                "joint_lower", "joint_upper", "velocity_limit", "effort_limit")


def test_go2_config_and_model_match_jax():
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
    assert abs(tm.total_mass - 15.097) < 0.01  # tests/test_go2.py:22


def test_build_go2_model_reproduces_the_asset():
    built, asset = build_go2_model(), TC.load_model()
    assert built.joint_names == asset.joint_names and set(built.frames) == set(asset.frames)
    for f in MODEL_FIELDS:
        np.testing.assert_allclose(getattr(built, f), getattr(asset, f), atol=1e-12, rtol=0,
                                   err_msg=f)
    for name, fr in built.frames.items():
        assert fr.body == asset.frames[name].body
        np.testing.assert_allclose(fr.pos, asset.frames[name].pos, atol=1e-12, rtol=0)


def test_eff_order_puts_the_first_foot_at_minus_y():
    """FR, FL, RR, RL: the first foot at -y (Solo12's first, FL, at +y), so
    Solo12's +-0.04 lateral nudges would narrow the Go2's stance; the
    generic offsets are the feet relative to the CoM."""
    q0 = torch.as_tensor(TC.q0(), dtype=F64)
    pos = TK.frame_positions(TC.load_model(), q0, TC.eff_names).numpy()
    np.testing.assert_array_equal(np.sign(pos[:, 1]), [-1, 1, -1, 1])
    np.testing.assert_allclose(pos, np.asarray(JK.frame_positions(
        JC.load_model(), np.asarray(TC.q0()), JC.eff_names)), atol=1e-12, rtol=0)


def jax_spec(name, **kw):
    return JKD.make_cyclic_spec(JC.load_model(), jgo2.GAITS[name], JC.q0(),
                                eff_frames=tuple(JC.eff_names), hip_frames=tuple(JC.hip_names),
                                foot_size=JC.foot_size, **kw)


def torch_spec(name, **kw):
    return TKD.make_cyclic_spec(TC.load_model(), tgo2.GAITS[name], TC.q0(),
                                eff_frames=tuple(TC.eff_names), hip_frames=tuple(TC.hip_names),
                                foot_size=TC.foot_size, device="cpu", **kw)


def assert_spec_matches(tspec, jspec):
    np.testing.assert_allclose(tspec.hip_offsets, np.asarray(jspec.hip_offsets), atol=1e-12)
    np.testing.assert_allclose(tspec.I_comp, np.asarray(jspec.I_comp), atol=1e-12)
    assert (tspec.horizon, tspec.ik_hor, tspec.size, tspec.n_int, tspec.warm_start_style) == (
        jspec.horizon, jspec.ik_hor, jspec.size, jspec.n_int, jspec.warm_start_style)
    assert tspec.gait == dataclasses.replace(
        tspec.gait, **{f.name: getattr(jspec.gait, f.name)
                       for f in dataclasses.fields(jspec.gait)})
    np.testing.assert_array_equal(tspec.x_reg, np.asarray(jspec.x_reg))


@pytest.mark.parametrize("name", NAMES)
def test_gait_table_and_spec_match_jax(name):
    assert list(tgo2.GAITS) == NAMES
    g, jg = tgo2.GAITS[name], jgo2.GAITS[name]
    for f in dataclasses.fields(jg):
        np.testing.assert_array_equal(np.asarray(getattr(g, f.name)),
                                      np.asarray(getattr(jg, f.name)), err_msg=f.name)
    tspec = workload.go2_spec(name, device="cpu")
    assert tspec.warm_start_style == "vdes"
    assert_spec_matches(tspec, jax_spec(name))


@pytest.mark.parametrize("kw", [dict(offset_style="solo12_hip"),
                                dict(offset_style="generic", warm_start_style="tiled")])
def test_spec_styles_match_jax(kw):
    """The options the defaults do not take on the Go2: the Solo12 hip
    offsets with their nudges, and the tiled warm start."""
    assert_spec_matches(torch_spec("trot", **kw), jax_spec("trot", **kw))


def test_model_the_kernels_cannot_take_raises():
    """K2 is built for 12 and 8 joints (the Solo8 runs since its port,
    tests/test_torch_solo8.py): a model of another count raises, naming
    them; so do unknown styles."""
    ten = dataclasses.replace(TC.load_model(), name="ten", n_joints=10)
    with pytest.raises(ValueError, match="12 or 8 joints"):
        TKD.make_cyclic_spec(ten, tgo2.trot, TC.q0(), device="cpu")
    with pytest.raises(ValueError, match="warm_start_style"):
        torch_spec("trot", warm_start_style="ramp")
    with pytest.raises(ValueError, match="offset_style"):
        torch_spec("trot", offset_style="hips")


@pytest.fixture(scope="module")
def reference():
    return dict(np.load(REF.FIXTURE))


PREP_CASES = NAMES + ["trot_weight"]


def case_spec(key):
    if key == "trot_weight":
        s = workload.go2_spec("trot", device="cpu")
        return dataclasses.replace(s, params=REF.weighted(s.params)), "trot"
    return workload.go2_spec(key, device="cpu"), key


@pytest.mark.parametrize("key", PREP_CASES)
def test_prepare_problem_matches_jax(reference, key):
    tspec, name = case_spec(key)
    tp = TKD._prepare_problem(tspec, *[torch.as_tensor(a, dtype=F64)
                                       for a in REF.prep_inputs(name)])
    got = dict(tp, cnt=tp["plan"].cnt, r=tp["plan"].r, dt=tp["plan"].dt,
               lb=tp["x_bounds"][0], ub=tp["x_bounds"][1])
    fields = REF.PREP_FIELDS + (("F_ref",) if key == "trot_weight" else ())
    assert (f"{key}/prep/F_ref" in reference) == (key == "trot_weight")
    assert (got["F_ref"] is None) == (key != "trot_weight")
    for f in fields:
        a, b = got[f].numpy(), reference[f"{key}/prep/{f}"]
        assert a.shape == b.shape, f
        if f in ("cnt", "swing_mask"):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f)
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], atol=ATOL, rtol=0, err_msg=f)
    # "vdes": the warm start's xy rides the command, unlike the tiled start
    X = got["X_wm"]
    assert not np.allclose(X[:, -1, 0:2], X[:, 0, 0:2])


@pytest.mark.parametrize("key", PREP_CASES)
def test_prep_values_matches_jax(reference, key):
    """K3's plain prologue on the Go2's compact inputs ("vdes", the generic
    offsets through the hip slots, "weight" for ``trot_weight``): in float32
    against the JAX package's ``prep_values`` under the gates of
    tests/test_fused_prep.py:95-116; in float64 against the port's
    ``_prepare_problem`` within 1e-12."""
    tspec, name = case_spec(key)
    jspec = jax_spec(name)
    if key == "trot_weight":
        jspec = dataclasses.replace(jspec, params=REF.weighted(jspec.params))
    pc = TKD.make_prep_consts(tspec)
    jpc = cuda_fused.PrepConsts(**dataclasses.asdict(JKD.make_prep_consts(jspec)))
    np.testing.assert_allclose(pc.as_array(), jpc.as_array(), rtol=1e-12, atol=0)
    assert pc.warm_start_vdes and pc.f_reg_weight == (key == "trot_weight")
    m, H, ne = float(tspec.model.total_mass), tspec.horizon, tspec.n_eff
    ci = REF.compact_inputs(name)
    for f in REF.COMPACT:
        np.testing.assert_array_equal(ci[f], reference[f"{key}/compact/{f}"], err_msg=f)
    ins = [torch.as_tensor(ci[f]) for f in REF.COMPACT]
    got = dict(zip(REF.PREP_VALUES, (a.numpy() for a in cuda_fused.prep_values(
        *ins, pc=pc, m=m, H=H, ne=ne))))
    ref = {f: reference[f"{key}/prep_values/{f}"] for f in REF.PREP_VALUES}
    np.testing.assert_array_equal(got["cnt"], ref["cnt"])
    np.testing.assert_allclose(got["r"], ref["r"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["dt"], ref["dt"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["swing"], ref["swing"])
    np.testing.assert_allclose(got["W"], ref["W"], rtol=1e-6)
    np.testing.assert_allclose(got["qlin"], ref["qlin"], rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(got["WF"], ref["WF"], rtol=1e-6)
    np.testing.assert_allclose(got["qF"], ref["qF"], rtol=1e-5, atol=1e-4)
    assert np.any(got["qF"] != 0.0) == (key == "trot_weight")
    np.testing.assert_allclose(got["lb"], ref["lb"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got["ub"], ref["ub"], rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got["X0"], ref["X0"], atol=1e-5, rtol=0)
    assert np.all(got["F0"] == 0.0) and np.all(ref["F0"] == 0.0)

    st = [torch.as_tensor(a, dtype=F64) for a in REF.prep_inputs(name)]
    _, t, vdw, x_init, ee, hip, amom = TKD._compact_inputs(tspec, *st)
    got = cuda_fused.prep_values(t, vdw, st[4], x_init, ee, hip, amom, pc=pc, m=m, H=H, ne=ne)
    pr = TKD._prepare_problem(tspec, *st)
    qF = torch.zeros_like(pr["W_F"]) if pr["F_ref"] is None else -2.0 * pr["W_F"] * pr["F_ref"]
    pairs = {"cnt": pr["plan"].cnt, "r": pr["plan"].r, "dt": pr["plan"].dt,
             "swing": pr["swing_mask"], "W": pr["W"], "qlin": -2.0 * pr["W"] * pr["X_ref"],
             "WF": pr["W_F"], "qF": qF, "lb": pr["x_bounds"][0], "ub": pr["x_bounds"][1],
             "X0": pr["X_wm"], "F0": pr["F_wm"]}
    for key_, a in zip(REF.PREP_VALUES, got):
        b = pairs[key_].to(F64)
        assert a.shape == b.shape, key_
        fin = torch.isfinite(b)  # the prologue's box holds a large sentinel where unbounded
        assert torch.all(a[~fin].abs() > 1e30), key_
        torch.testing.assert_close(a.to(F64)[fin], b[fin], atol=1e-12, rtol=0, msg=key_)


@pytest.mark.parametrize("name", NAMES)
def test_plain_path_matches_jax(reference, name):
    tspec = workload.go2_spec(name, device="cpu")
    g = tgo2.GAITS[name]
    st = [torch.as_tensor(a, dtype=F64) for a in REF.inputs(name)]
    plan = TKD.solve_mpc_batch(
        tspec, *st, admm_cfg=BiconvexConfig(rho=g.rho, x_solver="thomas", fista_max_iters=30),
        admm_backend="torch", ik_backend="torch")
    got = convert.plan_to_numpy(plan)
    for field in TKD.MpcPlan._fields:
        ref = reference[f"{name}/{field}"]
        assert got[field].shape == ref.shape, field
        if field == "admm_iters":
            np.testing.assert_array_equal(got[field], ref, err_msg=field)
        else:
            np.testing.assert_allclose(got[field], ref, atol=1e-6, rtol=0, err_msg=field)
    # problem 0, the JAX Go2 tests' window: their mass-scaled bounds
    assert got["dyn_violation"][0] < 1e-2
    cnt, F = got["cnt_plan"][0, ..., 0], got["F_opt"][0]
    assert abs((cnt * F[..., 2]).sum(-1).mean() - 15.097 * 9.81) < 40.0


@pytest.mark.slow
def test_fixture_is_the_jax_go2_solve():
    """The committed reference is what the JAX package computes today
    (several minutes: one compile of the JAX solve per gait)."""
    assert jax.config.jax_enable_x64
    fresh = REF.reference()
    stored = dict(np.load(REF.FIXTURE))
    assert set(fresh) == set(stored)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, stored[k], atol=1e-12, rtol=0, err_msg=k)


# ---- the kernels' per-problem math (g++ builds) on Go2 problems ----


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    return {name: host_lib(name, tmp_path_factory) for name in ("admm", "ddp", "fused")}


def go2_problems(name, n=4):
    spec = workload.go2_spec(name, device="cpu")
    st = [torch.as_tensor(a, dtype=F64) for a in workload.go2_states(name, n)]
    pr = TKD._prepare_problem(spec, *st)
    args = (pr["plan"], spec.model.total_mass, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"],
            pr["X_wm"], pr["F_wm"], pr["x_bounds"])
    return spec, st, pr, args


@pytest.mark.parametrize("name", NAMES)
def test_k1_kernel_math_on_go2(libs, name):
    """K1's g++ build in f64 on Go2 problems (rho 2e5-4e5, forces ~6x
    Solo12's) with bench.py's config: X, F within 1e-7, equal iterations,
    every problem converged; then warm-started from that solve with its
    dual, the returned P within 1e-7 too."""
    spec, _, _, args = go2_problems(name)
    cfg = cuda_admm.CudaAdmmConfig(rho=tgo2.GAITS[name].rho, fista_max_iters=30)
    kargs, keep, out = cuda_admm.kernel_args(*args, cfg)
    call_host(libs["admm"], "admm_host_f64", cuda_admm.ARGTYPES, kargs)
    ref = cuda_admm.solve_plain(*args, cfg)
    np.testing.assert_array_equal(out[3].numpy(), ref[3].numpy())
    assert bool((ref[2] < cfg.exit_tol).all())
    for i in (0, 1):
        np.testing.assert_allclose(out[i].numpy(), ref[i].numpy(), atol=1e-7, rtol=0)
    np.testing.assert_allclose(out[5].numpy(), ref[4].numpy(), atol=1e-7, rtol=0)
    warm = args[:6] + (ref[0], ref[1], args[8])
    kargs, keep, out = cuda_admm.kernel_args(*warm, cfg, P_wm=ref[4])
    call_host(libs["admm"], "admm_host_f64", cuda_admm.ARGTYPES, kargs)
    ref2 = cuda_admm.solve_plain(*warm, cfg, P_wm=ref[4])
    np.testing.assert_array_equal(out[3].numpy(), ref2[3].numpy())
    for i, j in ((0, 0), (1, 1), (5, 4)):
        np.testing.assert_allclose(out[i].numpy(), ref2[j].numpy(), atol=1e-7, rtol=0)


@pytest.mark.parametrize("name", ["trot", "bound", "trot_extended"])
def test_k2_kernel_math_on_go2(libs, name):
    """K2's g++ build with the Go2's model buffer (``pack_model``: its
    masses, inertias and link lengths) on the Go2's own IK problems (IK H 10,
    12, 15), built from the plain ADMM's solves: one Gauss-Newton step with
    one alpha in f64 (xs 1e-9, us 1e-7, cost rtol 1e-10: the two sides'
    orders of operations differ at ~1e-10 relative on these problems, 8e-11
    in xs, where tests/test_torch_ik.py's random Solo12 problems stay under
    1e-11) and the full DdpConfig at the plan's f64 gate (xs 1e-6, us 1e-6 /
    dt, cost rtol 1e-10)."""
    spec, st, pr, args = go2_problems(name)
    model, eff = spec.model, spec.eff_frames
    buf = cuda_ddp.pack_model(model, eff)
    assert abs(buf[-1] - 15.097) < 0.01  # the Go2's total mass, not Solo12's
    cfg = cuda_admm.CudaAdmmConfig(rho=tgo2.GAITS[name].rho, fista_max_iters=30)
    X = cuda_admm.solve_plain(*args, cfg)[0]
    tasks, x0 = TKD._build_ik_tasks(spec, pr, X)
    w_stage, w_term, ctrl_w, x_reg = TIK.dense_weights(model, eff, tasks)
    dargs = (x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, x_reg, w_stage, w_term, ctrl_w,
             tasks.dts)
    assert dargs[-1].shape[1] == spec.ik_hor
    for cfg_, xs_tol, us_tol, c_tol in (
            (cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,)), 1e-9, 1e-7, 1e-10),
            (cuda_ddp.CudaDdpConfig(), 1e-6, 1e-6 / 0.05, 1e-10)):
        kargs, keep, out = cuda_ddp.kernel_args(model, eff, *dargs, cfg_)
        call_host(libs["ddp"], "ddp_host_f64", cuda_ddp.ARGTYPES, kargs)
        ref = cuda_ddp.solve_ik_batch_plain(model, eff, *dargs, cfg=cfg_)
        np.testing.assert_allclose(out[0].numpy(), ref[0].numpy(), atol=xs_tol, rtol=0)
        np.testing.assert_allclose(out[1].numpy(), ref[1].numpy(), atol=us_tol, rtol=0)
        np.testing.assert_allclose(out[2].numpy(), ref[2].numpy(), rtol=c_tol)


@pytest.mark.parametrize("name", ["trot", "bound"])
def test_k3_kernel_math_on_go2(libs, name):
    """K3's g++ build in f64 on the Go2's compact inputs (the prologue's
    "vdes" branch and the generic offsets, then the ADMM) against its plain
    version: the contact plan exact (flags) and within 1e-12, X and F within
    1e-7, equal iterations, every problem converged."""
    spec, st, _, _ = go2_problems(name, n=6)
    _, t, vdw, x_init, ee, hip, amom = TKD._compact_inputs(spec, *st)
    ins = (t, vdw, st[4], x_init, ee, hip, amom)
    pc, m, H = TKD.make_prep_consts(spec), float(spec.model.total_mass), spec.horizon
    cfg = cuda_admm.CudaAdmmConfig(rho=tgo2.GAITS[name].rho, fista_max_iters=30)
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


def test_fused_path_matches_unfused_path_on_go2():
    """The whole Go2 solve with fuse_prep=True (K3's plain version: the
    prologue builds "vdes") against the unfused solve, on the CPU in f64:
    every plan field within 1e-6, equal iterations."""
    spec = workload.go2_spec("trot", device="cpu")
    st = [torch.as_tensor(a, dtype=F64) for a in workload.go2_states("trot", 4)]
    cfg = cuda_admm.CudaAdmmConfig(rho=tgo2.trot.rho, fista_max_iters=30)
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
    assert torch.all(fused.dyn_violation < 1e-3)
