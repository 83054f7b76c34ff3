"""The port's analysis scripts (``bunmpc_tpu_torch/scripts/``: the sweeps,
the gait diagnostics, the contact calibration, the W_F validation and the
three learning demos) against the JAX package's ``scripts/``.

* **The tables** (combinations, grids, the calibration grid, the cases,
  ``CONTACT``, the demos' ``DaggerConfig``s) against the JAX scripts' own
  literals, read with ``ast`` from ``scripts/*.py`` (those scripts set JAX's
  platform and compile cache when imported, so no test worker imports them).
* **The post-processing**: each script's ``main(argv)`` with ``device=cpu``
  and its rollouts (or its learning driver and policy evaluation) replaced
  by the seeded stubs of ``tests/torch_scripts_reference.py``, against what
  the JAX script's ``main`` printed and wrote on the same stubs (the
  fixture ``tests/fixtures/torch_scripts.json``; the ``slow`` test
  regenerates it): the documents' keys equal and their numbers within
  1e-5 relative (float32 attitude on both sides), the demos' lines equal
  within 1e-12, the printed reports equal to the last printed digit.
* **The sweep_contact loop** (its own window loop, batched over the
  combinations) on the plain backends in float64, 2 combinations x 2
  windows, against the JAX script's loop in float64 (the fixture's
  records): heights, attitude and speed within 1e-8, contact flags equal.
* ``sweep_contact`` and ``diagnose_gait`` also run for real at 100 ms.
  Where the JAX package committed an artifact of a script, the port's
  document has its keys.
"""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one PyTorch thread per test worker)
import torch_scripts_reference as REF
from bunmpc_tpu_torch.eval import velocity_grid as TVG
from bunmpc_tpu_torch.eval import visualize as TV
from bunmpc_tpu_torch.learning import dagger as TDG
from bunmpc_tpu_torch.scripts import (calibrate_contact, diagnose_gait, run_learning_demo,
                                      run_locodemo, run_locosafedagger_demo, sweep_contact,
                                      sweep_stability, validate_wf_norm)
from bunmpc_tpu_torch.sim import physics as TP
from bunmpc_tpu_torch.sim import rollout as TR

SCRIPTS = os.path.join(REF.ROOT, "scripts")
ARTIFACTS = os.path.join(REF.ROOT, "artifacts")


@pytest.fixture(scope="module")
def fixture():
    with open(REF.FIXTURE_JSON) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def arrays():
    return dict(np.load(REF.FIXTURE_NPZ))


# --- the JAX scripts' literals ---


def script_tree(name):
    with open(os.path.join(SCRIPTS, f"{name}.py")) as fh:
        return ast.parse(fh.read())


def literal(node):
    """A literal, or a ``dict(key=literal, ...)`` call."""
    if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "dict":
        return {k.arg: ast.literal_eval(k.value) for k in node.keywords}
    return ast.literal_eval(node)


def assigned(tree, name):
    """Every literal assigned to ``name`` in the script, in source order."""
    nodes = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and any(isinstance(t, ast.Name) and t.id == name for t in n.targets)]
    return [literal(n.value) for n in sorted(nodes, key=lambda n: n.lineno)]


def call_keywords(tree, func):
    """The literal keywords of the first call of ``func``."""
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "id", None) == func:
            out = {}
            for k in n.keywords:
                try:
                    out[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    if isinstance(k.value, ast.Call) and k.value.keywords:  # BcConfig(n_epoch=20)
                        out[k.arg] = {kk.arg: ast.literal_eval(kk.value)
                                      for kk in k.value.keywords}
            return out
    raise AssertionError(f"no call of {func}")


def test_sweep_tables_match_the_jax_scripts():
    assert assigned(script_tree("sweep_contact"), "combos") == [sweep_contact.COMBOS["solo12"],
                                                                sweep_contact.COMBOS["go2"]]
    got = assigned(script_tree("sweep_stability"), "gains_grid")
    got = list(zip(got, assigned(script_tree("sweep_stability"), "contact_grid"),
                   assigned(script_tree("sweep_stability"), "blend_grid")))
    want = [sweep_stability.GRIDS[k] for k in (("solo12", "default"), ("solo12", "calibrate"),
                                                ("go2", "default"))]
    assert [tuple(g) for g in got] == want
    assert len(sweep_stability.combos("go2", "default")) == 40
    assert len(sweep_stability.combos("solo12", "calibrate")) == 16
    tree = script_tree("calibrate_contact")
    assert (assigned(tree, "kns"), assigned(tree, "dns"), assigned(tree, "kts")) == \
        ([calibrate_contact.KNS], [calibrate_contact.DNS], [calibrate_contact.KTS])
    for name, mod in (("calibrate_contact", calibrate_contact),
                      ("validate_wf_norm", validate_wf_norm)):
        assert assigned(script_tree(name), "VX") == [mod.VX]


def test_wf_cases_match_the_jax_script():
    tree = script_tree("validate_wf_norm")
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "run_case"]
    want = [(ast.literal_eval(c.args[0]), {k.arg: ast.literal_eval(k.value) for k in c.keywords})
            for c in calls]
    got = [(name, {} if sb is None else {"sb": sb, "fg": fg})
           for name, _, _, _, sb, fg in validate_wf_norm.cases()]
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("name,mod,make", [
    ("run_learning_demo", run_learning_demo, lambda m: m.make_cfg(3, 8, 2000, False)),
    ("run_locodemo", run_locodemo, lambda m: m.make_cfg(3, 8)),
    ("run_locosafedagger_demo", run_locosafedagger_demo, lambda m: m.make_cfg(3, 8, 2000)),
])
def test_demo_configs_match_the_jax_scripts(name, mod, make):
    tree = script_tree(name)
    assert assigned(tree, "CONTACT") == [mod.CONTACT]
    cfg = make(mod)
    kw = call_keywords(tree, "DaggerConfig")
    assert kw, name
    for k, v in kw.items():
        if k == "bc":
            assert cfg.bc.n_epoch == v["n_epoch"]
        else:
            got = getattr(cfg, k)
            assert (tuple(got) if isinstance(got, tuple) else got) == v, k


# --- the stubbed mains against the JAX scripts' ---


def close_doc(got, want, rtol=1e-5, atol=1e-6, path="doc"):
    """Same structure and keys; numbers within the tolerance."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            close_doc(got[k], want[k], rtol, atol, f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            close_doc(a, b, rtol, atol, f"{path}[{i}]")
    elif isinstance(want, bool) or want is None or isinstance(want, str):
        assert got == want, (path, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)


def port_rollout(calls):
    """The port's ``rollout_mpc`` stand-in: call k returns
    ``stub_records(B, T, 100 + k)`` (the JAX side's stand-ins alike)."""
    def fn(spec, sp, cfg, state0, *a, **k):
        rec = REF.stub_records(state0.q.shape[0], cfg.episode_length, 100 + len(calls),
                               nv=spec.model.nv)
        calls.append(k)
        return REF.rollout_result(TR.RolloutResult, TP.SimState, rec, torch.as_tensor)

    return fn


@pytest.fixture
def stubbed(monkeypatch):
    calls = []
    monkeypatch.setattr(TR, "rollout_mpc", port_rollout(calls))
    monkeypatch.setattr(TR, "settle_state", lambda model, eff, sp, s0, *a, **k: s0)
    monkeypatch.setattr(TV, "rollout_strip", lambda *a, **k: None)
    monkeypatch.setattr(TV, "render_rollout_video", lambda *a, **k: None)
    return calls


def strict(path):
    with open(path) as fh:
        text = fh.read()
    return json.loads(text, parse_constant=lambda c: pytest.fail(f"non-strict JSON {c}"))


def test_calibrate_contact_matches_jax(stubbed, fixture, tmp_path):
    out = tmp_path / "c.json"
    assert calibrate_contact.main([str(out), str(REF.STUB_T), "device=cpu"]) == 0
    doc = strict(out)
    close_doc(REF.strip(doc), fixture["calibrate_contact"]["doc"])
    assert len(stubbed) == 2
    with open(os.path.join(ARTIFACTS, "contact_calibration_solo12.json")) as fh:
        art = json.load(fh)
    assert set(doc) == set(art) and set(doc["meta"]) == set(art["meta"])
    assert set(doc["grid_rows"][0]) == set(art["grid_rows"][0])
    assert set(doc["trot_sim_baseline"]) == set(art["trot_sim_baseline"])


def test_validate_wf_norm_matches_jax(stubbed, fixture, tmp_path):
    out = tmp_path / "wf.json"
    assert validate_wf_norm.main([str(out), str(REF.STUB_T), "device=cpu"]) == 0
    doc = strict(out)
    close_doc(REF.strip(doc), fixture["validate_wf_norm"]["doc"])
    # the Go2's cases pass swing_blend 0.5 and force_gate 1.0, Solo12's neither
    assert [(k.get("swing_blend"), k.get("force_gate")) for k in stubbed] == \
        [(None, None)] * 2 + [(0.5, 1.0)] * 2
    with open(os.path.join(ARTIFACTS, "wf_normalization.json")) as fh:
        art = json.load(fh)
    assert set(doc) == set(art) and set(doc["results"][0]) == set(art["results"][0])


@pytest.mark.parametrize("robot,grid", [("go2", "default"), ("solo12", "calibrate")])
def test_sweep_stability_matches_jax(stubbed, fixture, tmp_path, robot, grid, monkeypatch):
    for k in ("BUNMPC_SWEEP_WS", "BUNMPC_SWEEP_CARRY", "BUNMPC_SWEEP_WF"):
        monkeypatch.delenv(k, raising=False)
    out = tmp_path / "ss.json"
    argv = [robot, "0.3", str(REF.STUB_T), "500", grid, str(out), "device=cpu"]
    assert sweep_stability.main(argv) == 0
    doc = strict(out)
    close_doc(REF.strip(doc), fixture["sweep_stability"][f"{robot}_{grid}"]["doc"])
    # one rollout call with every per-episode option
    (kw,) = stubbed
    assert {"gains", "swing_blend", "force_gate", "warm_start_carry"} <= set(kw)
    if robot == "go2":
        with open(os.path.join(ARTIFACTS, "stability_sweep_go2.json")) as fh:
            art = json.load(fh)
        assert set(doc) == set(art) and set(doc["rows"][0]) == set(art["rows"][0])
        assert [[r[k] for k in ("kp", "kd", "kn", "dn", "kt", "swing_blend", "force_gate")]
                for r in doc["rows"]] == \
            [[r[k] for k in ("kp", "kd", "kn", "dn", "kt", "swing_blend", "force_gate")]
             for r in art["rows"]]


def test_sweep_carry_reads_the_environment(stubbed, tmp_path, monkeypatch):
    monkeypatch.setenv("BUNMPC_SWEEP_CARRY", "0")
    out = tmp_path / "ss.json"
    assert sweep_stability.main(["go2", "0.3", str(REF.STUB_T), "0", "default", str(out),
                                 "device=cpu"]) == 0
    assert stubbed[0]["warm_start_carry"] is False


@pytest.mark.parametrize("robot", ["solo12", "go2"])
def test_diagnose_gait_report_matches_jax(stubbed, fixture, tmp_path, capsys, robot):
    assert diagnose_gait.main([robot, "0.3", str(REF.STUB_T), str(tmp_path / "d"),
                               "device=cpu"]) == 0
    got = REF.report_lines(capsys.readouterr().out.splitlines())
    REF.same_report(got, REF.report_lines(fixture["diagnose_gait"][robot]["stdout"]))


@pytest.mark.parametrize("name,mod", [("run_learning_demo", run_learning_demo),
                                      ("run_locodemo", run_locodemo),
                                      ("run_locosafedagger_demo", run_locosafedagger_demo)])
def test_demo_lines_match_jax(fixture, tmp_path, monkeypatch, name, mod):
    REF.StubDriver.calls = []
    monkeypatch.setattr(TDG, "SafeDagger", REF.StubDriver)
    monkeypatch.setattr(TDG, "LocoSafeDagger", REF.StubDriver)
    monkeypatch.setattr(TVG, "eval_policy_grid", REF.stub_eval(TVG.GridEvalResult))
    out = tmp_path / f"torch_{name}.jsonl"
    assert mod.main([str(out)] + REF.DEMO_ARGS[name] + ["device=cpu"]) == 0
    with open(out) as fh:
        entries = [json.loads(ln, parse_constant=lambda c: pytest.fail(c)) for ln in fh]
    close_doc(REF.strip(entries), fixture[name]["entries"], rtol=1e-12, atol=0.0)
    assert entries[0]["meta"]["device"] == "cpu"
    if name != "run_locosafedagger_demo":  # the two resumable demos checkpoint apart from JAX's
        (call,) = REF.StubDriver.calls
        assert call["resume"] is True
        assert call["checkpoint_dir"] == os.path.join(REF.ROOT, f".ckpt_torch_{name}")
    if name == "run_learning_demo":
        with open(os.path.join(ARTIFACTS, "learning_demo_safedagger.jsonl")) as fh:
            art = [json.loads(ln) for ln in fh]
        # the committed run was finalized from its checkpoint by a script the
        # port does not keep (it records no device)
        want = set(art[0]["meta"]) - {"finalized_from_checkpoint"} | {"device"}
        assert set(entries[0]["meta"]) == want
        assert set(entries[1]["eval"]) == set(art[1]["eval"])
        assert set(entries[-1]) == set(art[-1])


def test_default_outputs_are_the_ports_own():
    """Every output file a script names (its defaults) starts with torch_,
    so that no default overwrites a file of the JAX package's."""
    from bunmpc_tpu_torch.scripts import diagnose_admm, solve_times_sweep

    for mod in (sweep_stability, calibrate_contact, validate_wf_norm, run_learning_demo,
                run_locodemo, run_locosafedagger_demo, solve_times_sweep, diagnose_gait,
                diagnose_admm, sweep_contact):
        with open(mod.__file__) as fh:
            tree = ast.parse(fh.read())
        parts = {id(v) for n in ast.walk(tree) if isinstance(n, ast.JoinedStr) for v in n.values}
        names = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
                 and id(n) not in parts and isinstance(n.value, str)
                 and re.search(r"\.(json|jsonl)$", n.value)]
        names += [n.values[0].value for n in ast.walk(tree) if isinstance(n, ast.JoinedStr)
                  and isinstance(n.values[0], ast.Constant)
                  and any(isinstance(v, ast.Constant) and re.search(r"\.(json|jsonl)$", v.value)
                          for v in n.values)]
        for name in names:
            base = os.path.basename(name)
            assert base.startswith("torch_"), (mod.__name__, name)


# --- the sweep_contact loop ---


def test_sweep_contact_loop_matches_jax(arrays):
    """Two combinations x two windows of the JAX script's own loop (float64)
    against the port's, batched over the combinations, on the CPU (the
    plain versions of the kernels) in float64."""
    from bunmpc_tpu_torch.scripts._common import trot_spec

    spec, C, _ = trot_spec("solo12", "cpu")
    combos = sweep_contact.COMBOS["solo12"][:2]
    z, rpy, vx, incnt = sweep_contact.run_combos(
        spec, C.q0(), combos, 0.3, REF.SWEEP_CONTACT_T, 0.018, 2.5, dtype=torch.float64)
    for name, got in (("z", z), ("rpy", rpy), ("vx", vx)):
        np.testing.assert_allclose(got, arrays[f"sweep_contact/{name}"][:2], atol=1e-8, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(incnt, arrays["sweep_contact/in_contact"][:2])


def test_sweep_contact_report_matches_jax(fixture, arrays):
    from bunmpc_tpu_torch.scripts._common import trot_spec

    spec, _, _ = trot_spec("solo12", "cpu")
    T = REF.SWEEP_CONTACT_T
    lines = sweep_contact.report(
        "solo12", 0.3, T, sweep_contact.COMBOS["solo12"], arrays["sweep_contact/z"],
        arrays["sweep_contact/rpy"], arrays["sweep_contact/vx"],
        arrays["sweep_contact/in_contact"], sweep_contact.planned_stance(spec, T),
        spec.params.nom_ht)
    REF.same_report(lines, fixture["sweep_contact"]["stdout"])


def test_sweep_contact_and_diagnose_gait_run(capsys, tmp_path):
    """Both mains for real on the CPU at 100 ms (two windows)."""
    assert sweep_contact.main(["go2", "0.2", "100", "device=cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "robot=go2 vx=0.2 T=100ms  (metrics over the 2nd half)"
    assert len(out) == 2 + 8 + 1 and "nan" not in " ".join(out)
    assert diagnose_gait.main(["solo12", "0.3", "100", str(tmp_path / "d"), "device=cpu"]) == 0
    out = capsys.readouterr().out
    assert "contact duty (planned vs measured)" in out and "HR: duty plan=" in out


@pytest.mark.slow
def test_fixture_is_the_jax_scripts(tmp_path, fixture, arrays):
    """The committed fixture is what the JAX scripts compute today (~15 min;
    the generator runs in its own process, which alone imports them)."""
    npz, doc = tmp_path / "s.npz", tmp_path / "s.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REF.ROOT)
    subprocess.run([sys.executable, REF.__file__, str(npz), str(doc)], check=True, env=env,
                   cwd=REF.ROOT)
    with open(doc) as fh:
        close_doc(json.load(fh), fixture, rtol=1e-9, atol=1e-12)
    fresh = dict(np.load(npz))
    assert set(fresh) == set(arrays)
    for k, a in fresh.items():
        np.testing.assert_allclose(a, arrays[k], atol=1e-12, rtol=0, err_msg=k)
