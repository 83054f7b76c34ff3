"""Problem assembly (stage 1 of the main path): the port's contact plan and
``_prepare_problem`` against the JAX package's, at B=8 bench-distribution
states in float64. Contact flags and the swing mask must match exactly,
everything else within atol 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bunmpc_tpu.mpc import gait as JG
from bunmpc_tpu.mpc import kino_dyn as JKD
from bunmpc_tpu.mpc.motions.solo12_cyclic import trot as jtrot
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu_torch.mpc import gait as TG
from bunmpc_tpu_torch.mpc import kino_dyn as TKD
from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TSolo

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)

B = 8
ATOL = 1e-9


def bench_states(n, seed=0):
    """bench.py's input distribution, plus the edge cases of the assembly:
    w_des == 0 (the orientation-correction branch) and gait clocks on knot
    boundaries (the first-knot dt rounding)."""
    rng = np.random.default_rng(seed)
    q = np.tile(TSolo.q0(), (n, 1))
    q[:, 7:] += rng.normal(size=(n, 12)) * 0.05
    q[:, 0:2] += rng.normal(size=(n, 2))  # the origin reset must remove this
    v = rng.normal(size=(n, 18)) * 0.05
    t = rng.uniform(0, 0.5, size=n)
    v_des = np.stack([rng.uniform(-0.3, 0.5, n), rng.uniform(-0.2, 0.2, n), np.zeros(n)], -1)
    w_des = rng.uniform(-0.3, 0.3, size=n)
    w_des[0] = 0.0
    t[1] = 0.35
    t[2] = 0.1
    return q, v, t, v_des, w_des


@pytest.fixture(scope="module")
def specs():
    jspec = JKD.make_cyclic_spec(JSolo.load_model(), jtrot, JSolo.q0())
    tspec = TKD.make_cyclic_spec(TSolo.load_model(), trot, TSolo.q0(), device="cpu")
    return jspec, tspec


@pytest.fixture(scope="module")
def prepared(specs):
    jspec, tspec = specs
    states = bench_states(B)
    # eager, not jitted: under jit XLA rewrites the first-knot dt
    # gait_dt - round(mod(t, gait_dt), 2) so that where mod(t, gait_dt) rounds
    # up to gait_dt (t = 0.35, 0.398, ...) it yields 1.7e-18 instead of 0, and
    # the zero test that restores gait_dt misses; the port, like the eager JAX
    # package, gives gait_dt
    jp = jax.vmap(lambda *a: JKD._prepare_problem(jspec, *a))(
        *[jnp.asarray(a, jnp.float64) for a in states]
    )
    tp = TKD._prepare_problem(tspec, *[torch.as_tensor(a, dtype=torch.float64) for a in states])
    return jp, tp


def test_spec_constants(specs):
    jspec, tspec = specs
    np.testing.assert_allclose(tspec.hip_offsets, np.asarray(jspec.hip_offsets), atol=1e-12)
    np.testing.assert_allclose(tspec.I_comp, np.asarray(jspec.I_comp), atol=1e-12)
    assert (tspec.horizon, tspec.ik_hor, tspec.size, tspec.n_int) == (
        jspec.horizon, jspec.ik_hor, jspec.size, jspec.n_int)


def test_contact_plan(specs):
    jspec, tspec = specs
    q, v, t, v_des, w_des = bench_states(B, seed=1)
    rng = np.random.default_rng(5)
    com = rng.normal(size=(B, 3)) * 0.05 + np.array([0.0, 0.0, 0.2])
    ee = rng.normal(size=(B, 4, 3)) * 0.2
    jplan, jsw = JG.create_cnt_plan(
        jspec.gait, jspec.planner, jspec.horizon, *[jnp.asarray(a) for a in (q, t, v_des, w_des,
                                                                              com, ee)]
    )
    tplan, tsw = TG.create_cnt_plan(
        tspec.gait, tspec.planner, tspec.horizon,
        *[torch.as_tensor(a, dtype=torch.float64) for a in (q, t, v_des, w_des, com, ee)]
    )
    np.testing.assert_array_equal(tplan.cnt.numpy(), np.asarray(jplan.cnt))
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(jsw))
    np.testing.assert_allclose(tplan.r.numpy(), np.asarray(jplan.r), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tplan.dt.numpy(), np.asarray(jplan.dt), atol=ATOL, rtol=0)


def test_first_knot_dt_edges(specs):
    jspec, tspec = specs
    t = np.array([0.0, 0.05, 0.1, 0.149, 0.3, 0.35, 0.449, 0.4999, 1.25])
    np.testing.assert_allclose(
        TG.first_knot_dt(tspec.gait, torch.as_tensor(t)).numpy(),
        np.asarray(JG.first_knot_dt(jspec.gait, jnp.asarray(t))), atol=0, rtol=0,
    )


def test_prepare_problem_plan_is_exact(prepared):
    jp, tp = prepared
    np.testing.assert_array_equal(tp["plan"].cnt.numpy(), np.asarray(jp["plan"].cnt))
    np.testing.assert_array_equal(tp["swing_mask"].numpy(), np.asarray(jp["swing_mask"]))


@pytest.mark.parametrize("key", ["q", "x_init", "W", "X_ref", "W_F", "X_wm", "F_wm"])
def test_prepare_problem_fields(prepared, key):
    jp, tp = prepared
    np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), atol=ATOL, rtol=0)


def test_prepare_problem_plan_and_bounds(prepared):
    jp, tp = prepared
    np.testing.assert_allclose(tp["plan"].r.numpy(), np.asarray(jp["plan"].r), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tp["plan"].dt.numpy(), np.asarray(jp["plan"].dt), atol=ATOL, rtol=0)
    for tb, jb in zip(tp["x_bounds"], jp["x_bounds"]):
        jb = np.asarray(jb)
        tb = tb.numpy()
        np.testing.assert_array_equal(np.isfinite(tb), np.isfinite(jb))
        fin = np.isfinite(jb)
        np.testing.assert_allclose(tb[fin], jb[fin], atol=ATOL, rtol=0)
