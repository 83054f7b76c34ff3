"""The port's experiment utilities (``bunmpc_tpu_torch/utils``) against the
JAX package's (``bunmpc_tpu/utils``):

* the port's own YAML reader (no PyYAML) on its copies of the configs
  (byte-identical: tests/test_torch_imports.py) gives what the JAX
  ``load_config`` gives, for all five configs
  and a set of overrides, and PyYAML's ``safe_load`` on the scalars and flow
  collections it reads;
* ``jsonio``'s output equals the JAX copy's;
* ``MetricsLogger`` writes one JSON line per call with ``_time``/``_step``;
* ``SolveTimer.summary`` aggregates phases; ``device_trace`` writes a
  Chrome trace of the CPU activities, with a recording's spans as a track
  over the operations they wrap; ``solve_times_sweep`` times a call per
  horizon;
* ``span`` and ``count`` outside a recording do nothing (no clock, no
  allocation, no sync, no read of the value); inside one, spans nest by
  parent and root id, a counted tensor is reduced only when the recording
  ends, and spans share the profiler's clock;
* a policy checkpoint written by the JAX ``save_policy`` at 2 x 64 loads in
  the port with actions within 1e-6 (f32) of the JAX policy on 64 seeded
  inputs, and one written by the port loads in JAX to the same tolerance;
* the training state round-trips through ``torch.save``;
* ``setup_torch`` picks the CPU on request and refuses a missing card.
"""

import json
import math
import time
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
from bunmpc_tpu.learning import networks as JN
from bunmpc_tpu.utils import checkpoint as JCK
from bunmpc_tpu.utils import config as JCFG
from bunmpc_tpu.utils import jsonio as JIO
from bunmpc_tpu_torch.learning import bc as BC
from bunmpc_tpu_torch.learning import networks as TN
from bunmpc_tpu_torch.utils import checkpoint as CK
from bunmpc_tpu_torch.utils import config as CFG
from bunmpc_tpu_torch.utils import jsonio as IO
from bunmpc_tpu_torch.utils import logging as LOG
from bunmpc_tpu_torch.utils import profiling as PROF
from bunmpc_tpu_torch.utils import runtime as RT

NAMES = ("bc", "dagger", "data_collection", "locosafedagger", "safedagger")
OVERRIDES = ["n_epoch=2", "vx_range=[0.0,0.3]", "sigma_vel.trot=0.5", "device=cpu",
             "save_path=/tmp/x", "resume=true", "resume2=True", "lr=2.0e-3", "gaits=['trot_sim']",
             "new.nested.key={'a': 1}"]


@pytest.mark.parametrize("name", NAMES)
def test_load_config_equals_jax(name):
    assert CFG.load_config(name) == JCFG.load_config(name)
    assert CFG.load_config(name, list(OVERRIDES)) == JCFG.load_config(name, list(OVERRIDES))


def test_yaml_reader_types_scalars_as_pyyaml():
    text = "\n".join([
        "# a comment", "a: 1e5  # a string in YAML 1.1", "b: 2.0e-3", "c: -0.5", "d: 'x # y'",
        "e: 'it''s'", "f: [1, 'a, b', {x: 1, y: [2, 3]}, true, ~, .inf, -.inf]", "g: yes",
        "h:", "i: 1_000", "j: .5", "k: -.5", "l: +3", "m: {}", "n: []", "o: hello world",
        'p: "tab\\tq"', "q: 3.", "r: a#b", "s: Off", "t: null", "u: \"a: b\"",
    ])
    assert CFG.parse_yaml(text) == yaml.safe_load(text)
    assert math.isnan(CFG.parse_yaml("x: .nan")["x"])


@pytest.mark.parametrize("text", ["a:\n  b: 1", "- 1", "a: 0x1f", "a: [1, 2", "a: {b: 1} c",
                                  "a: 1:30", "  a: 1\nb: 2"])
def test_yaml_reader_refuses_what_it_does_not_read(text):
    with pytest.raises(ValueError, match="config YAML"):
        CFG.parse_yaml(text)


def test_hydrate_ignores_unknown_keys():
    cfg = CFG.load_config("bc", ["n_epoch=3", "unknown=1"])
    assert CFG.hydrate(BC.BcConfig, cfg) == JCFG.hydrate(BC.BcConfig, cfg) == BC.BcConfig(
        n_epoch=3)
    with pytest.raises(ValueError, match="key=value"):
        CFG.apply_overrides({}, ["novalue"])


def test_jsonio_equals_jax(tmp_path):
    obj = {"a": float("nan"), "b": [1.0, float("inf"), np.float32(2.5), np.int64(3)],
           "c": {"d": (np.float64(-np.inf), "s")}, "e": None}
    assert IO.dumps(obj) == JIO.dumps(obj)
    assert IO.dumps(obj, indent=1) == JIO.dumps(obj, indent=1)
    IO.write_jsonl(str(tmp_path / "a.jsonl"), [obj, {"x": 1}])
    JIO.write_jsonl(str(tmp_path / "b.jsonl"), [obj, {"x": 1}])
    IO.write_json(str(tmp_path / "a.json"), obj)
    JIO.write_json(str(tmp_path / "b.json"), obj)
    for ext in ("jsonl", "json"):
        assert (tmp_path / f"a.{ext}").read_text() == (tmp_path / f"b.{ext}").read_text()


def test_metrics_logger_lines(tmp_path):
    log = LOG.MetricsLogger(str(tmp_path / "run"))
    log.log({"loss": 0.5, "epoch": 0})
    log.log({"loss": 0.25}, step=7)
    log.close()
    lines = [json.loads(s) for s in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [{k: v for k, v in e.items() if k != "_time"} for e in lines] == [
        {"loss": 0.5, "epoch": 0}, {"loss": 0.25, "_step": 7}]
    assert all(isinstance(e["_time"], float) for e in lines)
    again = LOG.MetricsLogger(str(tmp_path / "run"), use_wandb=False)  # appends
    again.log({"x": 1})
    again.close()
    assert len((tmp_path / "run" / "metrics.jsonl").read_text().splitlines()) == 3


def test_solve_timer_summary():
    timer = PROF.SolveTimer()
    for _ in range(3):
        with timer.phase("dyn", block_on=(torch.zeros(2), {"x": [torch.ones(1)]})):
            pass
    with timer.phase("ik"):
        pass
    s = timer.summary()
    assert set(s) == {"dyn", "ik"} and s["dyn"]["count"] == 3 and s["ik"]["count"] == 1
    assert 0 <= s["dyn"]["min"] <= s["dyn"]["mean"] <= s["dyn"]["max"]
    assert timer.report().count("\n") == 1 and "dyn" in timer.report()


def test_device_trace_and_sweep(tmp_path):
    with PROF.device_trace(str(tmp_path / "trace")) as prof:
        with PROF.recording(), PROF.span("product"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    [mm] = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    [sp] = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    assert sp["name"] == "product" and sp["pid"] != mm["pid"]
    assert sp["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= sp["ts"] + sp["dur"]
    calls = []
    out = PROF.solve_times_sweep(lambda h: (lambda x: calls.append(h) or x * h),
                                 lambda h: (torch.ones(h),), [2, 4], n_rep=2)
    assert set(out) == {2, 4} and all(t >= 0 for t in out.values())
    assert calls == [2, 2, 2, 4, 4, 4]  # one untimed call, then n_rep


class _Untouchable:
    """A value that fails on any use: ``count`` outside a recording must
    not read it."""

    def __getattribute__(self, name):
        raise AssertionError(f"read {name}")


def test_span_and_count_outside_a_recording_do_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a clock reading or a sync outside a recording")

    monkeypatch.setattr(PROF.time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    shared = PROF.span("a")
    for _ in range(3):  # one shared object, nothing made per call
        span = PROF.span("mpc.solve")
        with span:
            PROF.count("mpc.admm_iters_max", _Untouchable())
        assert span is shared
    monkeypatch.undo()
    with PROF.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}


def test_spans_nest_and_counters_reduce_when_the_recording_ends():
    iters = torch.tensor([3, 5, 4])
    with PROF.recording() as rec:
        with PROF.span("mpc.solve"):
            with PROF.span("mpc.prep"):
                pass
            with PROF.span("mpc.k1"):
                PROF.count("mpc.admm_iters_max", iters)
                PROF.count("calls", 1)
        with PROF.span("rollout.substeps"):
            pass
        iters[0] = 9  # kept, not yet reduced: the recording reads this
        with pytest.raises(RuntimeError, match="in progress"):
            with PROF.recording():
                pass
    assert [s.name for s in rec.spans] == ["mpc.solve", "mpc.prep", "mpc.k1", "rollout.substeps"]
    solve, prep, k1, sub = rec.spans
    assert [s.id for s in rec.spans] == [0, 1, 2, 3]
    assert solve.parent is None and prep.parent == k1.parent == solve.id
    assert solve.root == prep.root == k1.root == solve.id  # a solve's spans share one id
    assert sub.parent is None and sub.root == sub.id
    assert solve.start <= prep.start <= prep.end <= k1.start <= k1.end <= solve.end <= sub.start
    assert rec.counters == {"mpc.admm_iters_max": [9.0], "calls": [1.0]}
    assert PROF.span("x") is PROF.span("y")  # the recording is over


def test_spans_share_the_profilers_clock():
    a = torch.ones(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with PROF.recording() as rec:
            time.sleep(0.005)
            with PROF.span("inside"):
                a @ a
            time.sleep(0.005)
            a @ a
            time.sleep(0.005)
            with PROF.span("after"):
                time.sleep(0.005)
    mms = sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                 for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm")
    inside, after = rec.spans
    assert len(mms) == 2
    assert inside.start <= mms[0][0] <= mms[0][1] <= inside.end
    assert inside.end < mms[1][0] <= mms[1][1] < after.start


def test_setup_torch():
    assert RT.setup_torch("cpu", seed=3) == torch.device("cpu")
    a = torch.rand(3)
    RT.setup_torch("cpu", seed=3)
    assert torch.equal(a, torch.rand(3))
    assert torch.backends.cuda.matmul.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            RT.setup_torch()


# ---- policy checkpoints, both ways ----

IN = 43 + 5  # state features and a vc goal


def _inputs():
    rng = np.random.default_rng(11)
    return (rng.normal(size=(64, 43)).astype(np.float32),
            rng.normal(size=(64, 5)).astype(np.float32))


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    module, params = JN.init_policy(jax.random.PRNGKey(4), IN, num_hidden_layer=2, hidden_dim=64)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), params)
    rng = np.random.default_rng(5)
    bundle = JN.PolicyBundle(module, params, rng.normal(size=43).astype(np.float32),
                             (1.0 + rng.random(43)).astype(np.float32), 0.0, 1.0)
    JCK.save_policy(bundle, str(tmp_path / "jax"))
    ours = CK.load_policy(str(tmp_path / "jax"), device="cpu")
    assert len(ours.module.dense) == 3 and ours.module.dense[0].out_features == 64
    assert ours.module.dense[0].weight.dtype == torch.float32
    s, g = _inputs()
    ref = np.asarray(bundle(jnp.asarray(s), jnp.asarray(g)))
    with torch.no_grad():
        got = ours(torch.as_tensor(s), torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_port_checkpoint_loads_in_jax(tmp_path):
    gen = torch.Generator().manual_seed(4)
    module = TN.init_policy(gen, IN, num_hidden_layer=2, hidden_dim=64).eval()
    rng = np.random.default_rng(6)
    bundle = TN.PolicyBundle(module, *(torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.normal(size=43), 1.0 + rng.random(43), rng.normal(size=5), 1.0 + rng.random(5))))
    CK.save_policy(bundle, str(tmp_path / "port"))
    with open(tmp_path / "port" / "meta.json") as fh:
        assert json.load(fh) == {"output_size": 12, "num_hidden_layer": 2, "hidden_dim": 64,
                                 "batch_norm": False}
    with np.load(tmp_path / "port" / "payload.npz") as z:
        assert sorted(z.files) == sorted(
            ["state_mean", "state_std", "goal_mean", "goal_std"] +
            [f"param::['Dense_{i}']/['{p}']" for i in range(3) for p in ("bias", "kernel")])
        assert z["param::['Dense_0']/['kernel']"].shape == (IN, 64)
        assert all(z[k].dtype == np.float32 for k in z.files)
    theirs = JCK.load_policy(str(tmp_path / "port"))
    s, g = _inputs()
    ref = np.asarray(theirs(jnp.asarray(s), jnp.asarray(g)))
    with torch.no_grad():
        got = bundle(torch.as_tensor(s), torch.as_tensor(g)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # and back into the port bit for bit
    again = CK.load_policy(str(tmp_path / "port"), device="cpu")
    with torch.no_grad():
        assert torch.equal(again(torch.as_tensor(s), torch.as_tensor(g)),
                           bundle(torch.as_tensor(s), torch.as_tensor(g)))


def test_batch_norm_policies_are_refused(tmp_path):
    module = TN.GoalConditionedPolicyNet(IN, batch_norm=True)
    bundle = TN.PolicyBundle(module, *(torch.zeros(1),) * 4)
    with pytest.raises(ValueError, match="BatchNorm"):
        CK.save_policy(bundle, str(tmp_path / "bn"))


def test_train_state_round_trip(tmp_path):
    module = TN.GoalConditionedPolicyNet(IN, num_hidden_layer=1, hidden_dim=8)
    opt = BC.make_optimizer(module, 1e-3)
    BC.train_step(module, opt, torch.ones(4, IN), torch.zeros(4, 12))
    path = str(tmp_path / "ts" / "state.pt")
    CK.save_train_state(path, module.state_dict(), opt.state_dict(), 5, {"epoch": 2})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CK.load_train_state(path)
    got = CK.load_train_state(path, device="cpu")
    assert got["step"] == 5 and got["extra"] == {"epoch": 2}
    for k, v in module.state_dict().items():
        assert torch.equal(got["params"][k], v)
    fresh = TN.GoalConditionedPolicyNet(IN, num_hidden_layer=1, hidden_dim=8)
    fresh.load_state_dict(got["params"])
    opt2 = BC.make_optimizer(fresh, 1e-3)
    opt2.load_state_dict(got["opt_state"])
    BC.train_step(fresh, opt2, torch.ones(4, IN), torch.zeros(4, 12))
    BC.train_step(module, opt, torch.ones(4, IN), torch.zeros(4, 12))
    for a, b in zip(fresh.parameters(), module.parameters()):
        assert torch.equal(a, b)
