"""The divergent line-search case of tests/test_pallas_ddp.py for the port:
three DDP iterations with the full alpha grid on four DISTINCT problems, so
different alphas win on different problems. K2's plain version and K2's
per-problem math (the g++ build of ``csrc/ddp.cu``) against the JAX
package's ``ik.solve_ik`` in f32, with that test's gates (xs atol 5e-4, cost
rtol 5e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bunmpc_tpu.mpc import ik as JIK
from bunmpc_tpu.robots.solo12 import Solo12Config as JSolo
from bunmpc_tpu.solvers import ddp as JDDP
from bunmpc_tpu_torch.mpc import ik as TIK
from bunmpc_tpu_torch.robots.solo12 import Solo12Config as TSolo
from bunmpc_tpu_torch.solvers import cuda_ddp
from bunmpc_tpu_torch.solvers import ddp as TDDP

from test_torch_ik import H, NV, task_data
from torch_port_helpers import call_host, host_lib

NPROB = 4
ALPHAS = (1.0, 0.7, 0.3, 0.1, 0.03)
EFF = tuple(TSolo.eff_names)


@pytest.fixture(scope="module")
def problems():
    """Per-problem targets and start states (the perturbations of
    tests/test_pallas_ddp.py::test_multi_iteration_divergent_linesearch)."""
    d = task_data()
    ee, com = [], []
    for i in range(NPROB):
        r = np.random.default_rng(100 + i)
        ee.append(d["ee_targets"] + r.normal(size=(H, 4, 3)) * 0.05)
        com.append(d["com_ref"] + r.normal(size=(H + 1, 3)) * 0.03)
    rng = np.random.default_rng(11)
    x0 = np.concatenate([TSolo.q0(), np.zeros(NV)])
    x0s = np.stack([
        np.concatenate([x0[:19] + np.concatenate([np.zeros(7), rng.normal(size=12) * 0.05]),
                        rng.normal(size=NV) * 0.1])
        for _ in range(NPROB)
    ])
    return d, np.stack(ee), np.stack(com), x0s


@pytest.fixture(scope="module")
def jax_ref(problems):
    d, ee, com, x0s = problems
    model = JSolo.load_model()
    f32 = jnp.float32
    cfg = JDDP.DdpConfig(n_iters=3, alphas=ALPHAS)

    def one(x0, ee_t, com_r):
        tasks = JIK.IkTasks(
            ee_targets=ee_t, ee_wts=jnp.asarray(d["ee_wts"], f32), com_ref=com_r,
            mom_ref=jnp.asarray(d["mom_ref"], f32), com_wt=jnp.asarray(3.0, f32),
            mom_wt=jnp.asarray(2.0, f32), state_wt=jnp.asarray(d["state_wt"], f32),
            x_reg=jnp.asarray(d["x_reg"], f32), reg_wt_state=0.7, reg_wt_ctrl=1e-4,
            ctrl_wt=jnp.asarray(d["ctrl_wt"], f32), dts=jnp.full(H, 0.05, f32),
        )
        return tuple(JIK.solve_ik(model, EFF, x0, tasks, cfg))

    out = jax.jit(jax.vmap(one))(*[jnp.asarray(a, f32) for a in (x0s, ee, com)])
    return [np.asarray(a) for a in out]


def dense_args(problems):
    d, ee, com, x0s = problems
    f32 = torch.float32
    model = TSolo.load_model()
    rep = lambda a: torch.as_tensor(np.broadcast_to(a, (NPROB,) + np.shape(a)).copy(), dtype=f32)  # noqa: E731,E501
    tasks = TIK.IkTasks(
        ee_targets=torch.as_tensor(ee, dtype=f32), ee_wts=rep(d["ee_wts"]),
        com_ref=torch.as_tensor(com, dtype=f32), mom_ref=rep(d["mom_ref"]),
        com_wt=3.0, mom_wt=2.0, state_wt=torch.as_tensor(d["state_wt"], dtype=f32),
        x_reg=torch.as_tensor(d["x_reg"], dtype=f32), reg_wt_state=0.7, reg_wt_ctrl=1e-4,
        ctrl_wt=torch.as_tensor(d["ctrl_wt"], dtype=f32), dts=rep(np.full(H, 0.05)),
    )
    w_stage, w_term, ctrl_w, x_reg = TIK.dense_weights(model, EFF, tasks)
    return (model, EFF, torch.as_tensor(x0s, dtype=f32), tasks.ee_targets, tasks.com_ref,
            tasks.mom_ref, x_reg, w_stage, w_term, ctrl_w, tasks.dts)


def check(xs, cost, ref):
    for i in range(NPROB):
        np.testing.assert_allclose(xs[i], ref[0][i], atol=5e-4, err_msg=f"problem {i}")
        np.testing.assert_allclose(cost[i], ref[2][i], rtol=5e-4, err_msg=f"problem {i}")


def test_plain_divergent_linesearch(problems, jax_ref):
    res = TIK.solve_dense(*dense_args(problems), TDDP.DdpConfig(n_iters=3, alphas=ALPHAS))
    check(res.xs.numpy(), res.cost.numpy(), jax_ref)


def test_kernel_math_divergent_linesearch(problems, jax_ref, tmp_path_factory):
    lib = host_lib("ddp", tmp_path_factory)
    args, keep, out = cuda_ddp.kernel_args(
        *dense_args(problems), cuda_ddp.CudaDdpConfig(n_iters=3, alphas=ALPHAS)
    )
    call_host(lib, "ddp_host_f32", cuda_ddp.ARGTYPES, args)
    check(out[0].numpy(), out[2].numpy(), jax_ref)
