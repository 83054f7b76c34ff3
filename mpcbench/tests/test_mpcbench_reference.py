"""The frozen reference against the port's plain path, on the CPU in
float64 at a small size, and the benchmark's inputs and configuration
files against the recipes and tables they were copied from. (Only these
tests import both packages; the reference imports neither.)"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from mpcbench import inputs, system  # noqa: E402

torch.set_num_threads(2)
F64 = torch.float64


def config(name):
    with open(os.path.join(ROOT, "mpcbench", "configs", f"{name}.json")) as fh:
        return json.load(fh)


def port_states(name, B, seed):
    from bunmpc_tpu_torch import workload

    return workload.trot_states(B, seed) if name == "solo12_trot" else \
        workload.go2_states("trot", B, seed)


@pytest.mark.parametrize("name", ["solo12_trot", "go2_trot"])
def test_solve_matches_the_port_plain_path(name):
    cfg = config(name)
    table = cfg["gait"]
    args = [torch.as_tensor(a, dtype=F64) for a in port_states(name, 3, 5)]
    plans = {}
    for pkg in (system.PROGRAM, system.REFERENCE):
        KD = system.module(pkg, "mpc.kino_dyn")
        spec = system.spec(pkg, cfg, table, "cpu")
        admm = system.admm_config(system.REFERENCE, table["rho"], cfg["admm"])
        ddp = system.ddp_config(pkg, cfg["ddp"])
        kw = dict(admm_backend="torch", ik_backend="torch") if pkg == system.PROGRAM else {}
        plans[pkg] = KD.solve_mpc_batch(spec, *args, admm_cfg=admm, ddp_cfg=ddp, **kw)
    p, r = plans[system.PROGRAM], plans[system.REFERENCE]
    for f in r._fields:
        a, b = getattr(p, f).double(), getattr(r, f).double()
        assert a.shape == b.shape, f
        assert float((a - b).abs().max()) <= 1e-9 * max(1.0, float(b.abs().max())), f


def test_closed_loop_matches_the_port_plain_path():
    cfg = config("solo12_trot")
    cl, g = cfg["closed_loop"], cfg["closed_loop"]["gait"]
    B = 2
    v_des = torch.tensor([[0.2, 0.0, 0.0], [0.1, 0.0, 0.0]], dtype=F64)
    w_des = torch.zeros(B, dtype=F64)
    admm = system.admm_config(system.REFERENCE, g["rho"], cl["admm"])
    out = {}
    for pkg in (system.PROGRAM, system.REFERENCE):
        R = system.module(pkg, "sim.rollout")
        physics = system.module(pkg, "sim.physics")
        spec = system.spec(pkg, cfg, g, "cpu")
        sp = system.sim_params(pkg, cl["contact"])
        ddp = system.ddp_config(pkg, cfg["ddp"])
        q0 = torch.as_tensor(system.robot(pkg, cfg).q0()[None], dtype=F64)
        v0 = torch.zeros((1, spec.model.nv), dtype=F64)
        if pkg == system.PROGRAM:
            s = R.settle_state(spec.model, tuple(spec.eff_frames), sp, physics.SimState(q0, v0),
                               g["kp"], g["kd"], ms=30)
            q, v = s.q.expand(B, -1).contiguous(), s.v.expand(B, -1).contiguous()
            rc = R.RolloutConfig(episode_length=60, kp=g["kp"], kd=g["kd"],
                                 gait_period=g["gait_period"])
            res = R.rollout_mpc(spec, sp, rc, physics.SimState(q, v), v_des, w_des,
                                admm_cfg=admm, ddp_cfg=ddp, admm_backend="torch",
                                ik_backend="torch")
            out[pkg] = (s.q, res.states, res.actions, res.base, res.final_state.q)
        else:
            ctl = system.module(pkg, "sim.controllers")
            qs, vs = R.settle_state(spec.model, tuple(spec.eff_frames), sp, q0, v0, g["kp"],
                                    g["kd"], ms=30)
            rc = R.RolloutConfig(episode_length=60, kp=g["kp"], kd=g["kd"],
                                 gait_period=g["gait_period"])
            rec = R.rollout_mpc(spec, sp, rc, qs.expand(B, -1).contiguous(),
                                vs.expand(B, -1).contiguous(), v_des, w_des, admm, ddp,
                                ctl.IdControllerGains(kp=g["kp"], kd=g["kd"]))
            out[pkg] = (qs, rec.states, rec.actions, rec.base, rec.final_q)
    for a, b in zip(out[system.PROGRAM], out[system.REFERENCE]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-9 * max(1.0, float(b.abs().max()))


def test_inputs_are_the_port_recipes():
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.robots.go2 import Go2Config

    for a, b in zip(inputs.trot_states(16, np.random.default_rng(9),
                                       system.robot(system.REFERENCE, config("solo12_trot")).q0()),
                    workload.trot_states(16, 9)):
        np.testing.assert_array_equal(a, b)
    traffic = {"batch": 16, "lead": {"v_des": [0.3, 0.0, 0.0], "w_des": 0.0}}
    mine = inputs.trot_states(16, np.random.default_rng(4), Go2Config.q0())
    lead = inputs.solve_batch(traffic, Go2Config.q0(), 0, 0)
    for a, b, c in zip(mine, workload.go2_states("trot", 16, 4), lead):
        np.testing.assert_array_equal(a[1:], b[1:])
        np.testing.assert_array_equal(c[0], b[0])
    for a, b in zip(inputs.command_draw(16, np.random.default_rng(2)),
                    workload.command_draw(16, 2)):
        np.testing.assert_array_equal(a, b)


def table_of(p):
    d = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        d[f.name] = v.tolist() if isinstance(v, np.ndarray) else list(v) if isinstance(v, tuple) \
            else v
    return d


@pytest.mark.parametrize("pkg", [system.PROGRAM, system.REFERENCE])
def test_configuration_tables_are_the_gaits(pkg):
    solo = system.module(pkg, "mpc.motions.solo12_cyclic")
    go2 = system.module(pkg, "mpc.motions.go2_cyclic")
    assert config("solo12_trot")["gait"] == table_of(solo.trot)
    assert config("solo12_trot")["closed_loop"]["gait"] == table_of(solo.trot_sim)
    assert config("go2_trot")["gait"] == table_of(go2.trot)


def test_reference_assets_are_the_ports():
    for name in ("solo12_model.npz", "go2_model.npz"):
        with open(os.path.join(ROOT, "bunmpc_tpu_torch", "robots", "assets", name), "rb") as a, \
                open(os.path.join(ROOT, "mpcbench", "reference", "robots", "assets", name),
                     "rb") as b:
            assert a.read() == b.read()


def test_the_cells_settle_is_the_references_in_float32():
    # the closed loop's stand, as the cell makes it (its settle, in float32): the reference
    # starts from the program's stand, so the settle is held here, where both run one
    # arithmetic (on the CPU); float32 and float64 settles part by ~1e-2, so no
    # comparison across precisions or devices can hold it
    cfg = config("solo12_trot")
    cl, g = cfg["closed_loop"], cfg["closed_loop"]["gait"]
    out = {}
    for pkg in (system.PROGRAM, system.REFERENCE):
        R = system.module(pkg, "sim.rollout")
        physics = system.module(pkg, "sim.physics")
        spec = system.spec(pkg, cfg, g, "cpu")
        sp = system.sim_params(pkg, cl["contact"])
        q0 = torch.as_tensor(system.robot(pkg, cfg).q0()[None], dtype=torch.float32)
        v0 = torch.zeros((1, spec.model.nv), dtype=torch.float32)
        args = (spec.model, tuple(spec.eff_frames), sp)
        if pkg == system.PROGRAM:
            s = R.settle_state(*args, physics.SimState(q0, v0), g["kp"], g["kd"],
                               ms=int(cl["settle_ms"]))
            out[pkg] = (s.q, s.v)
        else:
            out[pkg] = R.settle_state(*args, q0, v0, g["kp"], g["kd"], ms=int(cl["settle_ms"]))
    for a, b in zip(out[system.PROGRAM], out[system.REFERENCE]):
        assert torch.equal(a, b)
