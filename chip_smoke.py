#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bunmpc_tpu_torch``) on one NVIDIA GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``bunmpc_tpu_torch/csrc/`` (K1 the
ADMM, K2 the GN-DDP, K3 the fused problem assembly + ADMM), holds each kernel
and each of K1's branches against its plain PyTorch version on the card,
holds K1 against the committed native fixture, holds K1 and K2 at twice the
trot's horizons (the trot with ``gait_horizon=4.0``: ADMM H=40, IK H=20)
against their plain versions, and drives two paths of the
batched Solo12 trot MPC solve of ``bench.py`` (B=512, f32): the main path
``solve_mpc_batch(admm_backend="cuda", ik_backend="cuda")`` (K1, K2) and the
fused path with ``fuse_prep=True`` (K3, K2); phase 3c holds K1 with a
carried scaled dual against the plain version in f64. Then it drives the
closed loop (``sim.rollout.rollout_mpc``, the walking trot ``trot_sim`` from
a settled start, (X, F, P) carried from window to window): two windows
against the plain path in f64 (phase 7a), and 512 episodes of 3000 steps, K1
and K2 once per window, gated on survival and the survivors' median roll
and height, beside the same loop cold (phase 7b). Then the learning loop
(phase 8): one data-collection iteration (``learning.data_collection``,
K1 and K2 once per window of each expert rollout), BC at the bc.yaml
widths on its database (``learning.bc``), and the trained policy with cc
goals at 512 episodes of 1500 steps (``sim.rollout.rollout_policy_cc``, no
MPC). Then the DAgger family (phase 9): ``SafeDagger.run`` with one
iteration, one ``rollout_dagger`` call, one ``LocoSafeDagger`` iteration (K1
and K2 once per window of every MPC and gated call), gated on the gate's
rule, the aggregation rule and the policy's weights on the records, and
one gated window at B=64 against the plain path in f64. Then phase 10: the
main and the fused path on every Solo12 gait of ``GAITS`` (K1, K2 and K3 at
horizons 6..30), and the eval suite (``bunmpc_tpu_torch.eval``: the MPC
velocity grid, the policy comparison, the cc-replanning ablation, the
max-force search with its exactness against an unpushed run, the past-goals
matrix), K1 and K2 once per window of every MPC eval call. Then phase 11,
the Go2: its four gaits on both paths (11a), one window with every
per-episode option (gains, contact, swing_blend, force_gate, sensor biases)
against the plain path in f64 (11b), 512 episodes of 3000 steps of its
walking trot gated on survival, roll, height and speed (11c), and the JAX
package's 40-row stability sweep as one rollout (11d). Then phase 12, the
Solo8 (8 joints: K2's 8-joint build) on the main and the fused path. Then
phase 13, terrain: two windows on a zero heightfield equal to flat ground
bit for bit (13a), two windows on a 10% slope against the plain path in f64
(13b), and 512 episodes of 3000 steps on a random heightfield (13c). Then
phase 14, the six Solo12 acyclic motions through K1 and K2. Then phase
15, the experiment drivers: the five CLI drivers' ``main(argv)``
(``bunmpc_tpu_torch.scripts``) in-process, data collection with its ``.npz``
snapshot, BC with its checkpoint, the MPC and policy grids, SafeDAgger with
a checkpoint and a resumed call, and a ``torch.profiler`` trace of one
main-path solve. Then phase 16, the analysis scripts and the learning
demos (``bunmpc_tpu_torch.scripts``): the solve-time sweep, the ADMM
diagnostics, the gait diagnostics, the contact sweep and calibration, the
W_F validation, the Go2's stability sweep and the three demos, each
``main(argv)`` in-process and cut small, its launches, outputs and output
file checked. The plain references of phases 3-6, 7a, 9d, 10a, 11a, 12,
13b and 14 run in worker processes on the host's CPU while the card works,
and every phase's seconds are printed on one line beside the total. It
checks every
path's outputs, counts each kernel's launches in each path's run, times
them, and prints one ``kernels`` JSON line, the card's name and power limit,
and last
``{"ok": true, "device": {...}}``. Every phase fails the run (non-zero exit)
on a miss; without CUDA, or without the repository next to it, it exits
non-zero and prints no result.
"""

import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 512
SECONDS = {}  # wall seconds of each phase and subphase, printed beside the total
H100_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (data sheet)
H100_HBM_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s (data sheet)
# Phase 7a: one window of the closed loop on the card against the plain path
# in f64, end-of-window q and v. The plain path's own f32-vs-f64 spread over
# that window is WINDOW_SPREAD (tests/test_torch_rollout.py measures it on a
# CPU: 8 episodes, max |d|); the gates are 10x it, and that test fails where
# they fall under 3x.
WINDOW_SPREAD = (9.96e-7, 4.27e-5)
WINDOW_Q_TOL = 1e-5
WINDOW_V_TOL = 5e-4
# Phase 8c: the first 50 steps of the cc policy rollout on the card against
# the same rollout in f64 on the CPU, end q and v. POLICY_SPREAD is the f32
# spread of that check (tests/test_torch_policy_rollout.py measures it on a
# CPU: 8 episodes, a policy trained at the BC widths on expert records); the
# gates are 10x it, and that test fails where they fall under 3x. How far
# f32 drifts in 50 steps depends on the policy (1.6e-5..3.3e-3 in q over ten
# policies trained on the CPU), so where the CPU's own f32 run of this
# check's policy drifts further, the gates are 10x that.
POLICY_SPREAD = (2.63e-5, 2.35e-3)
POLICY_Q_TOL = 2.6e-4
POLICY_V_TOL = 2.4e-2
# Phase 8b: one Adam step of the BC policy on the card against the same step
# on the CPU (f32 both), |d| of the parameters: its 0.999-quantile and its
# max. ADAM_SPREAD is one step's f32-vs-f64 spread at the BC widths on a
# trained net, (quantile, max) over three batches (tests/test_torch_learning.py
# measures it on a CPU); the gates are 10x it, and that test fails where
# they fall under 3x. The max has a heavy tail (5.5e-6..1.1e-4 over six
# datasets), so where the CPU's own f32 step of this check drifts further,
# the gates are 10x that.
ADAM_SPREAD = (1.4e-8, 8.9e-5)
ADAM_Q_TOL = 1.4e-7
ADAM_MAX_TOL = 9e-4
# Phase 9d: one window of rollout_safedagger on the card against the plain
# path in f64, end-of-window q and v of the episodes whose gate agrees.
# Phase 7a's gates proved too tight there: GATED_SPREAD is the plain path's
# f32-vs-f64 spread of such a window (tests/test_torch_dagger.py measures it
# on a CPU: 8 perturbed starts with the drivers' sigmas, a policy trained at
# the BC widths; every episode switches from the policy to the MPC within
# the window, and the takeover runs a plan made for the window's start from
# a state the policy has moved, so the spread is heavy-tailed, q 1e-6 ..
# 2.7e-2 over the episodes); the gates are 10x it, and that test fails where
# they fall under 3x. Where the card's own plain f32 run drifts further,
# the gates are 10x that. The window's plan (K1, K2 at the starts) is held to
# phase 7a's quantile gates.
GATED_SPREAD = (2.75e-2, 1.63e1)
GATED_Q_TOL = 2.8e-1
GATED_V_TOL = 1.7e2
# Phase 7a: two windows of the closed loop (the second solve takes the first
# one's carried X, F and dual P) on the card against the plain path in f64,
# end q and v; TWO_WINDOW_SPREAD is the plain path's f32-vs-f64 spread over
# the two windows (tests/test_torch_rollout.py measures it on a CPU: 8
# episodes, max |d|); the gates are 10x it, and that test fails where they
# fall under 3x.
TWO_WINDOW_SPREAD = (1.56e-6, 3.96e-5)
TWO_WINDOW_Q_TOL = 1.6e-5
TWO_WINDOW_V_TOL = 4e-4
# Phase 11b: one window of the Go2 loop with every per-episode option on the
# card against the plain path in f64, end q and v; GO2_WINDOW_SPREAD is the
# plain path's f32-vs-f64 spread of that window (tests/test_torch_go2_rollout.py
# measures it on a CPU: 8 episodes of the same configuration); the gates
# are 10x it, and that test fails where they fall under 3x. Phase 11d holds
# the sweep's row 31 to the same gates against 11c's episode 0.
GO2_WINDOW_SPREAD = (3.84e-5, 1.55e-3)
GO2_WINDOW_Q_TOL = 3.8e-4
GO2_WINDOW_V_TOL = 1.5e-2
# Phase 11d: episode steps of the sweep (the JAX package's sweep runs 3000)
SWEEP_STEPS = 3000
# Phase 7b: windows of the cold run compared with the carried run's first
COLD_WINDOWS = 20


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def quantile_gate(name, a, b, q_tol=5e-3, max_tol=5e-2):
    d = (a - b).abs().flatten().double()
    q = float(np.quantile(d.cpu().numpy(), 0.999))
    mx = float(d.max())
    log(f"  {name}: |d| q0.999 {q:.3e} (< {q_tol}), max {mx:.3e} (< {max_tol})")
    check(q < q_tol and mx < max_tol, f"{name}: quantile gate missed (q {q:.3e}, max {mx:.3e})")
    return mx


def admm_ops(iters, fista_iters, H, cfg):
    """Arithmetic (f32 operations) the ADMM kernel performs on these inputs,
    counted from csrc/admm_core.cuh per problem: per ADMM iteration
    (power_iters+1) applications of the F operator (~260 ops per knot) with a
    norm, one Thomas sweep (~3,400 ops per knot: the 9x9 Cholesky on the
    lower triangle ~500, the 9x10 block solve ~1,800, the Schur update of the
    next block's lower triangle and right-hand side ~1,100) and the dual
    update (~150 ops per knot); per FISTA iteration one operator application,
    the step, the cone projection and the momentum update (~400 ops per
    knot)."""
    f_op = 260.0 * H
    per_admm = (cfg.power_iters + 1) * (f_op + 36.0 * H) + 3400.0 * (H + 1) + 150.0 * (H + 1)
    per_fista = f_op + 140.0 * H
    return float(iters.double().sum()) * per_admm + float(fista_iters.double().sum()) * per_fista


def ddp_ops(n_problems, H, cfg, nj=12):
    """Arithmetic the DDP kernel performs (fixed work, no data dependence),
    counted from csrc/ddp.cu per problem and iteration, at 12 joints (nb 13
    bodies, nv 18, ndx 36): per knot of the backward sweep the kinematics
    (~3.5k ops), the 36-direction tangent pass (~60k), the Gauss-Newton
    products (~27k) and the block-structured Riccati step (~100k, most of it
    the 18x37 solve and the Kfb'Qux update); per knot of each alpha's rollout
    ~7k ops. At another joint count each term scales with what it loops
    over: the kinematics with nb, the tangent pass with ndx directions of nb
    bodies, the products with ndx^2 entries, the Riccati step with nv ndx^2,
    a rollout knot with its nv x ndx feedback."""
    nb, nv = nj + 1, nj + 6
    ndx = 2 * nv
    kin, tan, gn = 3.5e3 * nb / 13, 60e3 * (ndx / 36) * (nb / 13), 27e3 * (ndx / 36) ** 2
    ric = 100e3 * (nv / 18) * (ndx / 36) ** 2
    knot = 7e3 * (nv * ndx) / (18 * 36)
    backward = (H + 1) * (kin + tan + gn) + H * ric
    rollouts = len(cfg.alphas) * H * knot
    first = H * knot
    return n_problems * (first + cfg.n_iters * (backward + rollouts))


def ddp_bytes(n_problems, H, nj=12):
    """Bytes K2 must move: each input read once (x0, the feet targets, the
    CoM and momentum references, the reference states, the stage and
    terminal weights, the control weights, the knot durations) and each
    output written once (xs, us, cost), f32."""
    nv = nj + 6
    nx, ndx = nv + nj + 7, 2 * nv
    nr, nrt = 12 + 9 + ndx, 9 + ndx
    return 4.0 * n_problems * (nx + H * 12 + (H + 1) * (3 + 6 + nx) + H * nr + nrt + H * nv
                               + H + (H + 1) * nx + H * nv + 1)


def prep_ops(n_problems, H):
    """Arithmetic of K3's prologue (csrc/fused.cu), counted per problem: per
    knot-foot pair the phase, contact flag, touchdown and swing point (~40
    ops), per knot and foot of the location carry ~10, per knot the costs,
    the box over the feet and the warm start (~100)."""
    return n_problems * (H * 4 * 40.0 + H * 4 * 10.0 + (H + 1) * 100.0)


def rows(a, n):
    """The first n problems of a tensor, a tuple of them or a ContactPlan."""
    if isinstance(a, tuple):
        return tuple(rows(x, n) for x in a)
    if hasattr(a, "cnt"):
        return type(a)(cnt=rows(a.cnt, n), r=rows(a.r, n), dt=rows(a.dt, n))
    return a[:n].contiguous() if hasattr(a, "contiguous") else a


def as_f64(a):
    """A tensor, a tuple of them or a ContactPlan in float64."""
    if isinstance(a, tuple):
        return tuple(as_f64(x) for x in a)
    if hasattr(a, "cnt"):
        return type(a)(cnt=as_f64(a.cnt), r=as_f64(a.r), dt=as_f64(a.dt))
    return a.double() if hasattr(a, "double") else a


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / H100_HBM_BYTES * 1e3
    t_ops = n_ops / H100_F32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def finite_and_frozen(torch, res):
    """Whether every record of a live episode of a rollout is finite, and
    whether every failed episode's state records stay at their value of the
    failing step."""
    T = res.states.shape[1]
    steps = torch.arange(T, device=res.states.device)
    after = steps[None] >= res.fail_step[:, None].long()  # (B, T): at or after the failure
    frozen = True
    for rec in (res.states, res.base):
        at_fail = rec.gather(1, res.fail_step.long().clamp(max=T - 1)[:, None, None].expand(
            -1, 1, rec.shape[-1]))
        frozen &= bool(((rec == at_fail) | ~after[..., None]).all())
    alive = ~res.failed
    finite = all(bool(torch.isfinite(getattr(res, f)[alive]).all())
                 for f in ("states", "actions", "vc_goals", "base", "com", "contact_forces",
                           "contact_pos"))
    return finite, frozen


def cc_rows(in_contact):
    """Rows a live episode adds to the database (numpy ``in_contact`` (T,
    n_eff)): its cc goal ends at the earliest of the feet's last touchdowns
    (0 where a foot never touches down)."""
    td = in_contact[1:] & ~in_contact[:-1]
    return min(int(np.nonzero(td[:, ee])[0].max()) + 1 if td[:, ee].any() else 0
               for ee in range(td.shape[1]))


# Phase 8: steps of 8a's and 8c's episodes (cut from 3000 to make room for
# phase 16: the checks count rows and compare 50 steps whatever the length)
LOOP8_STEPS = 1500


def learning_loop(torch, spec, sim, start, cmd, zero_counts, counts, card):
    """Phase 8: the learning loop's first half on the port's entry points.
    8a one data-collection iteration (the data-collection config: a B=1
    benchmark rollout, then 10 replanning points x 2 perturbations in one
    batch, K1 and K2 once per window), 8b BC at the bc.yaml widths on its
    database for 5 of its 150 epochs, 8c the trained policy with cc goals at
    the batch of ``start`` (no MPC), its first 50 steps against the CPU in
    f64 on 64 episodes. 8a's and 8c's episodes are LOOP8_STEPS long.
    Returns the launch counts of 8a and the cc policy of 8b."""
    from bunmpc_tpu_torch.learning import bc as BC
    from bunmpc_tpu_torch.learning import data_collection as DCM
    from bunmpc_tpu_torch.learning import networks
    from bunmpc_tpu_torch.learning.contact_planner import ContactPlanner
    from bunmpc_tpu_torch.sim import physics, rollout

    dev = start.q.device
    B = start.q.shape[0]
    T, epochs, n_check = LOOP8_STEPS, 5, 64
    dc_cfg = DCM.DataCollectionConfig(  # scripts/run_data_collection.py on data_collection.yaml
        episode_length=T, num_perturbations_per_replanning=2, goal_horizon=1,
        vx_range=(0.0, 0.3), vy_range=(0.0, 0.0), w_range=(0.0, 0.0), action_type="pd_target",
        database_size=10_000_000)

    # ---- 8a. data collection: one iteration ----
    dc = DCM.DataCollection(spec, dc_cfg, sim_params=sim, seed=0)
    calls = []
    rollout_mpc = rollout.rollout_mpc

    def timed_rollout(*a, **k):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout_mpc(*a, **k)
        torch.cuda.synchronize()
        after = counts()
        calls.append((time.perf_counter() - t0, {n: after[n] - before[n] for n in after}, res))
        return res

    rollout.rollout_mpc = timed_rollout
    try:
        zero_counts()
        t0 = time.perf_counter()
        log_dc = dc.run_iteration(start.q[0], start.v[0])
        it_s = time.perf_counter() - t0
        launches = counts()
    finally:
        rollout.rollout_mpc = rollout_mpc
    nw = dc.rcfg.n_windows
    expected_rows, rows, ok_records = 0, [], True
    for i, (wall, ln, res) in enumerate(calls):
        finite, _ = finite_and_frozen(torch, res)
        failed = res.failed.cpu().numpy()
        inc, states = res.in_contact.cpu().numpy(), res.states.cpu().numpy()
        n_rows = [cc_rows(inc[b]) for b in range(len(failed)) if not failed[b]]
        expected_rows += sum(n_rows)
        rows += [states[b, :cc_rows(inc[b])] for b in range(len(failed)) if not failed[b]]
        log(f"[8a] rollout call {i}: {len(failed)} episodes x {T} steps in {wall:.2f} s "
            f"({len(failed) * T / wall:.1f} env-steps/s); survival {1 - failed.mean():.4f}; "
            f"launches {ln}; live records finite {finite}; rows of the live episodes {n_rows}")
        ok_records &= finite and ln == {"admm": nw, "ddp": nw, "fused": 0}
    db = dc.database
    db_equal = len(db) == expected_rows and bool(
        rows and np.array_equal(db.states, np.concatenate(rows)))
    log(f"[8a] iteration {it_s:.2f} s (host append and perturbation included); v_des "
        f"{np.round(log_dc['v_des'], 4).tolist()}; rows added {log_dc['datapoints_added']}, "
        f"expected {expected_rows}; database {len(db)} rows, equal to the live episodes' "
        f"records {db_equal}; launches {launches} (K1 and K2 {nw} per call)")
    log(json.dumps({"metric": "data_collection_iteration", "wall_s": round(it_s, 3),
                    "rollout_wall_s": [round(c[0], 3) for c in calls],
                    "rollout_batch": [int(c[2].failed.shape[0]) for c in calls],
                    "survival": [float(1 - c[2].failed.float().mean()) for c in calls],
                    "rows": log_dc["datapoints_added"], "card": card}))
    check(len(calls) == 2 and [int(c[2].failed.shape[0]) for c in calls] == [1, 20],
          "data collection must run the benchmark rollout and one batch of 20")
    check(ok_records, f"each rollout call must launch K1 and K2 {nw} times with finite records")
    check(launches == {"admm": 2 * nw, "ddp": 2 * nw, "fused": 0},
          f"data collection must launch K1 and K2 {2 * nw} times in all")
    check(log_dc["datapoints_added"] == expected_rows and db_equal,
          "rows added disagree with the appended episodes' lengths")
    check(expected_rows > 0, "data collection added no row")

    # ---- 8b. BC at the bc.yaml widths (3 x 512, batch 256, lr 2e-3, L1) ----
    bc_cfg = BC.BcConfig(n_epoch=epochs)
    stamps = [time.perf_counter()]
    bundle, rep = BC.train_policy(db, bc_cfg, rng_seed=0,
                                  log_fn=lambda d: stamps.append(time.perf_counter()))
    epoch_s = np.diff(stamps)
    n_steps = int(bc_cfg.n_train_frac * len(db)) // bc_cfg.batch_size
    log(f"[8b] BC {epochs} epochs x {n_steps} steps: epoch s {np.round(epoch_s, 3).tolist()} "
        f"(the first moves the set to the card), {n_steps / np.median(epoch_s):.1f} steps/s; "
        f"train loss {np.round(rep.train_losses, 5).tolist()}, valid "
        f"{np.round(rep.valid_losses, 5).tolist()}")
    # one Adam step from the trained parameters on the first batch: on the
    # card, and on the CPU in f32 and f64
    x, y = db.xy()
    sd = {k: v.detach().cpu().clone() for k, v in bundle.module.state_dict().items()}
    stepped = []
    for d, dt in ((dev, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        net = networks.GoalConditionedPolicyNet(x.shape[1], y.shape[1], bc_cfg.num_hidden_layer,
                                                bc_cfg.hidden_dim).to(d, dt)
        net.load_state_dict(sd)
        BC.train_step(net, BC.make_optimizer(net, bc_cfg.learning_rate),
                      torch.as_tensor(x[:256], dtype=dt, device=d),
                      torch.as_tensor(y[:256], dtype=dt, device=d))
        stepped.append({k: v.detach().cpu().double() for k, v in net.state_dict().items()})

    def param_diff(a, b):
        d = torch.cat([(a[k] - b[k]).abs().flatten() for k in sd])
        return float(np.quantile(d.numpy(), 0.999)), float(d.max())

    (adam_q, adam_max), spread = param_diff(*stepped[:2]), param_diff(*stepped[1:])
    q_tol, max_tol = max(ADAM_Q_TOL, 10 * spread[0]), max(ADAM_MAX_TOL, 10 * spread[1])
    moved = max(float((stepped[1][k] - sd[k].double()).abs().max()) for k in sd)
    log(f"[8b] one Adam step, card vs CPU (f32): params |d| q0.999 {adam_q:.3e} (< {q_tol:.1e}), "
        f"max {adam_max:.3e} (< {max_tol:.1e}); the CPU's f32-vs-f64 spread here "
        f"{spread[0]:.3e}, {spread[1]:.3e} (CPU test: {ADAM_SPREAD[0]:.1e}, "
        f"{ADAM_SPREAD[1]:.1e}); the step moved params by up to {moved:.3e}")
    log(json.dumps({"metric": "bc_steps_per_sec", "value": round(n_steps / np.median(epoch_s), 1),
                    "epoch_s": np.round(epoch_s, 4).tolist(), "steps_per_epoch": n_steps,
                    "rows": len(db), "train_losses": rep.train_losses, "card": card}))
    check(all(np.isfinite(rep.train_losses)) and all(np.isfinite(rep.valid_losses)),
          "BC losses not finite")
    check(rep.train_losses[-1] < rep.train_losses[0], "BC train loss did not fall")
    check(adam_q < q_tol and adam_max < max_tol, "the card's Adam step disagrees with the CPU's")

    # ---- 8c. the trained policy with cc goals: B episodes x T steps, no MPC ----
    planner = ContactPlanner(spec)
    v_np, w_np = (c.cpu().double().numpy() for c in cmd)
    sched, _ = planner.get_contact_schedule(start.q, start.v, v_np, w_np, T, 0.0)
    pcfg = dc.rcfg
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rollout.rollout_policy_cc(spec, sim, pcfg, start, *cmd, bundle, sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pol_launches = counts()
    finite, frozen = finite_and_frozen(torch, res)
    survival = float(1 - res.failed.float().mean())
    # the first 50 steps against the same rollout in f64 on the CPU
    cfg50 = dataclasses.replace(pcfg, episode_length=50)
    card50 = rollout.rollout_policy_cc(spec, sim, cfg50, start, *cmd, bundle, sched)
    torch.cuda.synchronize()
    ref = {}
    for dt in (torch.float64, torch.float32):
        net = networks.GoalConditionedPolicyNet(x.shape[1], y.shape[1], bc_cfg.num_hidden_layer,
                                                bc_cfg.hidden_dim).to(dtype=dt)
        net.load_state_dict(sd)
        cpu_bundle = networks.PolicyBundle(net.eval(), *(
            t.detach().cpu().to(dt) for t in (bundle.state_mean, bundle.state_std,
                                              bundle.goal_mean, bundle.goal_std)))
        ref[dt] = rollout.rollout_policy_cc(
            spec, sim, cfg50,
            physics.SimState(*(a[:n_check].cpu().to(dt) for a in start)),
            *(c[:n_check].cpu().to(dt) for c in cmd), cpu_bundle, sched[:n_check]).final_state

    def end_diff(a, b):
        return (float((a.q[:n_check].cpu().double() - b.q.double()).abs().max()),
                float((a.v[:n_check].cpu().double() - b.v.double()).abs().max()))

    dq, dv = end_diff(card50.final_state, ref[torch.float64])
    sq, sv = end_diff(ref[torch.float32], ref[torch.float64])
    q_tol, v_tol = max(POLICY_Q_TOL, 10 * sq), max(POLICY_V_TOL, 10 * sv)
    log(f"[8c] policy rollout: {B} episodes x {T} steps in {wall:.2f} s, "
        f"{B * T / wall:.1f} env-steps/s, {1e3 * wall / T:.3f} ms a substep; survival "
        f"{survival:.4f} (not gated); launches {pol_launches}; records of live episodes finite "
        f"{finite}, failed episodes frozen {frozen}")
    log(f"[8c] first 50 steps against the CPU in f64 ({n_check} episodes): end q |d| {dq:.3e} "
        f"(< {q_tol:.1e}), v |d| {dv:.3e} (< {v_tol:.1e}); the CPU's own f32 spread here q "
        f"{sq:.3e}, v {sv:.3e} (CPU test: q {POLICY_SPREAD[0]:.3e}, v {POLICY_SPREAD[1]:.3e})")
    log(json.dumps({"metric": "policy_rollout_env_steps_per_sec", "value": round(B * T / wall, 1),
                    "batch": B, "steps": T, "wall_s": round(wall, 3),
                    "substep_ms": round(1e3 * wall / T, 4), "survival": survival, "card": card}))
    check(pol_launches == {"admm": 0, "ddp": 0, "fused": 0}, "the policy rollout launched MPC")
    check(finite, "policy rollout records of live episodes not finite")
    check(frozen, "failed policy episodes were not frozen")
    check(dq < q_tol and dv < v_tol, "the first 50 policy steps disagree")
    return launches, bundle


def aggregate_rows(res, expert_only, keep, skip_failed, margin):
    """The (episode, steps) pairs the drivers' aggregation rule keeps of
    host records: an episode dropped by ``keep`` gives nothing; a failed one
    nothing with ``skip_failed``, else its steps before ``fail_step -
    margin`` where there are at least 100; a live one every step; of a gated
    rollout (``expert_only``) only the MPC's steps."""
    out = []
    for b in range(res.states.shape[0]):
        if keep is not None and not keep[b]:
            continue
        n = res.states.shape[1]
        if res.failed[b]:
            if skip_failed:
                continue
            n = int(res.fail_step[b]) - margin
            if n < 100:
                continue
        steps = np.arange(n)
        if expert_only:
            steps = steps[res.mpc_usage[b, :n] > 0]
        if len(steps):
            out.append((b, steps))
    return out


def safedagger_rule(torch, rollout, res, n_block):
    """SafeDAgger's rule on a gated call's records, over each episode's live
    steps (up to its failing step): a dangerous recorded state (q rebuilt
    from the features, xy = 0) is an MPC step; the MPC hands back only after
    at least ``n_block`` steps in control; it takes over only on a dangerous
    step. Returns (rule holds, takeovers, releases)."""
    feat = res.states
    q = torch.cat([torch.zeros_like(feat[..., :2]), feat[..., 26:]], -1)
    danger = rollout.state_is_dangerous(q).cpu().numpy()
    usage = res.mpc_usage.cpu().numpy() > 0
    fail_step = res.fail_step.cpu().numpy()
    ok, takeovers, releases = True, 0, 0
    for b in range(usage.shape[0]):
        n = min(int(fail_step[b]) + 1, usage.shape[1])
        u, d = usage[b, :n], danger[b, :n]
        ok &= bool(u[d].all())
        prev = np.concatenate([[False], u[:-1]])
        on = np.nonzero(u & ~prev)[0]
        off = np.nonzero(~u & prev)[0]
        ok &= bool(d[on].all())
        for t in off:  # the run of MPC steps that ends at t
            start = on[on < t].max()
            ok &= bool(t - start >= n_block)
        takeovers, releases = takeovers + len(on), releases + len(off)
    return ok, takeovers, releases


def policy_rows_diff(torch, res, current, other):
    """Largest |action - policy(features, goal)| over the live steps on
    which the policy acted, for the policy ``current`` and for ``other``;
    and the number of such steps."""
    steps = torch.arange(res.states.shape[1], device=res.states.device)
    sel = (steps[None] < res.fail_step[:, None]) & (res.mpc_usage == 0)
    s, g, a = res.states[sel], res.vc_goals[sel], res.actions[sel]
    if not len(s):
        return 0.0, 0.0, 0
    with torch.no_grad():
        return (float((current(s, g) - a).abs().max()), float((other(s, g) - a).abs().max()),
                int(len(s)))


def dagger_family(torch, spec, sim, start, zero_counts, counts, card, pool):
    """Phase 9: the DAgger family on the port's entry points, on the closed
    loop of phases 7b and 8. 9a ``SafeDagger.run`` (the warmup: 8 benchmark
    and 80 perturbed expert episodes and BC; one iteration: 8 benchmark, 16
    gated and 16 ending episodes and BC), 9b one ``rollout_dagger`` call of
    9a's policy on 9a's gated starts and its aggregation by a ``Dagger``
    driver on 9a's database, 9c one ``LocoSafeDagger`` iteration on 9a's
    database and policy, 9d the first window of ``rollout_safedagger`` at
    B=64 from 9a's perturbed starts, the kernels against the plain path in
    f64 (run on the host CPU's workers, ``pool``). Every driver starts from
    ``start``'s first episode, phase 7a's 500 ms settled start
    (``settle_ms=0``: the drivers' own settle is the same PD hold). Returns
    each call's launch counts (9a-9c), 9a's policies, ``{"warmup": (policy,
    rows), "final": (policy, rows)}`` with the rows of the database each was
    trained on, and ``finish_9d()``, which waits for 9d's plain references
    and holds the card's window to them."""
    from bunmpc_tpu_torch.learning import bc as BC
    from bunmpc_tpu_torch.learning import dagger as D
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.sim import physics, rollout

    # the drivers' defaults (8 rollouts an iteration, 2 perturbations, 1 a
    # warmup replanning point, 1000 ms ending rollouts, the velocity ranges
    # and sigmas), safedagger.yaml's 150 blocked steps, bc.yaml's widths;
    # cut: 1 of 10 iterations, 600 of 5000 steps, 5 of 150 and 50 epochs
    cfg = D.DaggerConfig(episode_length=600, n_iterations=1, num_steps_to_block=150,
                         warmup_bc_epochs=5, bc=BC.BcConfig(n_epoch=5), settle_ms=0)
    q0, v0 = start.q[0], start.v[0]
    calls, solves, aggs = [], [], []
    names = ("rollout_mpc", "rollout_safedagger", "rollout_dagger", "rollout_policy")
    originals = {n: getattr(rollout, n) for n in names}
    solve_batch = KD.solve_mpc_batch
    phase = ["9a"]

    def spy(name):
        def fn(*a, **k):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = originals[name](*a, **k)
            torch.cuda.synchronize()
            after = counts()
            calls.append(dict(name=name, phase=phase[0], wall=time.perf_counter() - t0,
                              launches={n: after[n] - before[n] for n in after}, res=res,
                              args=a, kwargs=k))
            return res
        return fn

    def timed_solve(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        plan = solve_batch(*a, **k)
        e1.record()
        solves.append((len(calls), e0, e1))
        return plan

    def spy_aggregate(drv):
        inner = drv._aggregate

        def fn(res, expert_only=True, keep=None, skip_failed=None):
            before = len(drv.database)
            added = inner(res, expert_only=expert_only, keep=keep, skip_failed=skip_failed)
            aggs.append(dict(phase=phase[0], res=res, expert_only=expert_only, keep=keep,
                             skip_failed=drv.cfg.skip_failed_episodes if skip_failed is None
                             else skip_failed, added=added, before=before, db=drv.database))
            return added
        drv._aggregate = fn

    for n in names:
        setattr(rollout, n, spy(n))
    KD.solve_mpc_batch = timed_solve
    try:
        zero_counts()
        t9 = time.perf_counter()
        # ---- 9a. SafeDagger.run: warmup and one iteration ----
        drv = D.SafeDagger(spec, cfg, sim_params=sim, seed=0)
        spy_aggregate(drv)
        warm, warm_rows = [], []
        logs = drv.run(q0, v0, eval_hook=lambda d: warm.append(d.policy)
                       or warm_rows.append(len(d.database)) or {})
        t9a = time.perf_counter() - t9
        # ---- 9b. rollout_dagger of 9a's policy on 9a's gated starts ----
        phase[0] = "9b"
        gated = next(c for c in calls if c["name"] == "rollout_safedagger")
        a, k = gated["args"], gated["kwargs"]
        starts = D.Starts(a[3].q, a[3].v, k["start_time"], a[4], a[5])
        dag = D.Dagger(spec, cfg, sim_params=sim, seed=1)
        dag.database, dag.policy = drv.database, drv.policy
        spy_aggregate(dag)
        g_state = dag.generator.get_state()
        dag_added = dag._aggregate(dag._gated(starts))
        # ---- 9c. one LocoSafeDagger iteration on 9a's database and policy ----
        phase[0] = "9c"
        loco = D.LocoSafeDagger(spec, cfg, sim_params=sim, seed=2, grid_n=30)
        loco.database, loco.policy, loco._params = drv.database, drv.policy, drv._params
        spy_aggregate(loco)
        entry = loco.iteration(0, drv._settle(q0, v0))
        t9c = time.perf_counter() - t9
        launches = counts()
    finally:
        for n in names:
            setattr(rollout, n, originals[n])
        KD.solve_mpc_batch = solve_batch

    # ---- per call: launches, records, times ----
    ok_launch, ok_records = True, True
    for i, c in enumerate(calls):
        res = c["res"]
        B_, T_ = res.states.shape[:2]
        nw = T_ // 50
        mpc = c["name"] != "rollout_policy"
        want = {"admm": nw if mpc else 0, "ddp": nw if mpc else 0, "fused": 0}
        finite, frozen = finite_and_frozen(torch, res)
        ev = [(e0, e1) for j, e0, e1 in solves if j == i]
        solve_ms = [e0.elapsed_time(e1) for e0, e1 in ev]
        window_ms = [ev[w][0].elapsed_time(ev[w + 1][0]) for w in range(len(ev) - 1)]
        sub_ms = [w - s_ for w, s_ in zip(window_ms, solve_ms)]
        times = (f"window / solve / substeps ms {np.mean(window_ms):.1f} / {np.mean(solve_ms):.1f}"
                 f" / {np.mean(sub_ms):.1f}" if len(ev) > 1 else
                 f"substep ms {1e3 * c['wall'] / T_:.3f}")
        c["summary"] = dict(call=c["name"], phase=c["phase"], batch=B_, steps=T_,
                            wall_s=round(c["wall"], 3),
                            env_steps_per_sec=round(B_ * T_ / c["wall"], 1),
                            survival=float(1 - res.failed.float().mean()),
                            mpc_usage=float(res.mpc_usage.float().mean()),
                            launches=c["launches"])
        log(f"[{c['phase']}] {c['name']}: {B_} episodes x {T_} steps in {c['wall']:.2f} s "
            f"({B_ * T_ / c['wall']:.1f} env-steps/s), {times}; survival "
            f"{c['summary']['survival']:.4f}, mpc_usage {c['summary']['mpc_usage']:.4f}; "
            f"launches {c['launches']} (expected {want}); live records finite {finite}, "
            f"failed episodes frozen {frozen}")
        ok_launch &= c["launches"] == want
        ok_records &= finite and frozen

    # ---- aggregation: rows added and the database against the rule ----
    db = drv.database
    ok_agg, expected_total = True, 0
    for g in aggs:
        rows_ = aggregate_rows(g["res"], g["expert_only"], g["keep"], g["skip_failed"],
                               D._IterativeDriver.PREFIX_MARGIN)
        n_rows = sum(len(s) for _, s in rows_)
        expected_total += n_rows
        span = slice(g["before"], g["before"] + n_rows)
        same = all(np.array_equal(
            getattr(g["db"], f)[span],
            np.concatenate([getattr(g["res"], f)[b][s] for b, s in rows_]) if rows_ else
            np.zeros((0, getattr(g["res"], f).shape[-1]), np.float32))
            for f in ("states", "actions", "vc_goals"))
        ok_agg &= g["added"] == n_rows and same
        log(f"[{g['phase']}] aggregate (expert_only {g['expert_only']}, keep "
            f"{'all' if g['keep'] is None else int(np.sum(g['keep']))}, skip_failed "
            f"{g['skip_failed']}): rows added {g['added']}, by the rule {n_rows}; the database's "
            f"rows are the rule's {same}")
    ok_agg &= len(db) == expected_total
    log(f"[9] database {len(db)} rows, the rule's total {expected_total}")

    # ---- SafeDAgger's rule, DAgger's coins, the policy's weights ----
    rule_ok, takeovers, releases = safedagger_rule(torch, rollout, gated["res"],
                                                   cfg.num_steps_to_block)
    log(f"[9a] SafeDAgger rule on the gated records: holds {rule_ok} ({takeovers} takeovers, "
        f"{releases} releases, num_steps_to_block {cfg.num_steps_to_block})")
    res_dag = next(c for c in calls if c["name"] == "rollout_dagger")["res"]
    gen = torch.Generator(device=dag.device)
    gen.set_state(g_state)
    coins = rollout.dagger_coins(gen, res_dag.states.shape[0], res_dag.states.shape[1] // 50,
                                 cfg.mpc_usage_percentage)
    usage = res_dag.mpc_usage.reshape(coins.shape + (50,))
    coins_ok = bool((usage == coins[..., None].to(usage.dtype)).all())
    log(f"[9b] DAgger: usage constant within each window and equal to the coins {coins_ok} "
        f"(coins mean {float(coins.float().mean()):.3f}); rows added {dag_added}")
    d9a = policy_rows_diff(torch, gated["res"], gated["args"][6], warm[0])
    d9b = policy_rows_diff(torch, res_dag, drv.policy, warm[0])
    pol_call = next(c for c in calls if c["name"] == "rollout_policy")
    d9c = policy_rows_diff(torch, pol_call["res"], pol_call["args"][6], warm[0])
    stale_tol = 1e-4
    log(f"[9] policy steps: recorded action vs the current policy |d| max 9a {d9a[0]:.3e} "
        f"({d9a[2]} steps), 9b {d9b[0]:.3e} ({d9b[2]}), 9c {d9c[0]:.3e} ({d9c[2]}) (< "
        f"{stale_tol:.0e}); vs the warmup policy 9b {d9b[1]:.3e}, 9c {d9c[1]:.3e} (> "
        f"{100 * stale_tol:.0e})")

    # ---- 9c: the posterior and the choice ----
    post = loco.posterior
    v_des, w_des = np.array([entry["goal"][0], entry["goal"][1], 0.0]), entry["goal"][2]
    mpc_call = [c for c in calls if c["phase"] == "9c" and c["name"] == "rollout_mpc"][0]
    errs = [D.weighted_vc_error(c["res"].states.cpu().numpy(), c["res"].fail_step.cpu().numpy(),
                                c["res"].failed.cpu().numpy(), v_des, w_des)
            for c in (mpc_call, pol_call)]
    choice = "mpc" if errs[0] < errs[1] else "policy"
    log(f"[9c] goal {np.round(entry['goal'], 4).tolist()}: e_mpc {entry['e_mpc']:.6g}, e_policy "
        f"{entry['e_policy']:.6g} (recomputed {errs[0]:.6g}, {errs[1]:.6g}); aggregated "
        f"{entry['aggregated']} (the smaller: {choice}); posterior sum {post.sum():.12f}, "
        f"entropy {entry['posterior_entropy']:.4f} (< log(30^3) = {np.log(30 ** 3):.4f})")
    losses = [v for e in logs[1:] + [entry] for key, v in e.items() if "loss" in key]
    log(f"[9a] logs {json.dumps(logs[1:], default=float)}")
    log(f"[9c] log {json.dumps(entry, default=float)}")
    log(f"[9] 9a {t9a:.1f} s, 9a-9c {t9c:.1f} s; launches {launches}")

    # ---- 9d. the first gated window at B=64: the kernels on the card, the plain
    # path in f64 and f32 on the host CPU's workers (gated in finish_9d) ----
    pert = [c for c in calls if c["phase"] == "9a" and c["name"] == "rollout_mpc"][1]
    n = 64
    a, k = pert["args"], pert["kwargs"]
    sub = (a[3].q[:n], a[3].v[:n], a[4][:n], a[5][:n], k["start_time"][:n])
    wcfg = dataclasses.replace(drv.rcfg, episode_length=50)
    pol = drv.policy
    pol_np = ({name: t.detach().cpu().numpy() for name, t in pol.module.state_dict().items()},
              [t.detach().cpu().numpy() for t in (pol.state_mean, pol.state_std, pol.goal_mean,
                                                  pol.goal_std)])
    sub_np = [t.cpu().numpy() for t in sub]
    plain_refs = {dt: pool.submit(gated_window_reference, *sub_np, wcfg, pol_np, dt)
                  for dt in ("float64", "float32")}
    t0 = time.perf_counter()
    plans = []
    solve_batch = capture_solves(KD, plans)
    try:
        zero_counts()
        win = rollout.rollout_safedagger(spec, sim, wcfg, physics.SimState(*sub[:2]), sub[2],
                                         sub[3], pol, num_steps_to_block=150, start_time=sub[4])
        torch.cuda.synchronize()
        win_launches = counts()
    finally:
        KD.solve_mpc_batch = solve_batch
    card_s = time.perf_counter() - t0

    def finish_9d():
        t1 = time.perf_counter()
        out = {dt: f.result() for dt, f in plain_refs.items()}
        wait_s = time.perf_counter() - t1
        dev = win.mpc_usage.device

        def on_card(o):
            return types.SimpleNamespace(
                final_state=physics.SimState(*(torch.as_tensor(o[f], device=dev).double()
                                               for f in ("final_q", "final_v"))),
                mpc_usage=torch.as_tensor(o["mpc_usage"], device=dev),
                xs_int=torch.as_tensor(o["xs_int"], device=dev).double())

        ref, ref32 = on_card(out["float64"]), on_card(out["float32"])
        agree = (win.mpc_usage == ref.mpc_usage).all(1)
        agree32 = (ref32.mpc_usage == ref.mpc_usage).all(1)

        def end_diff(res, mask):
            if not bool(mask.any()):
                return 0.0, 0.0
            return (float((res.final_state.q.double() - ref.final_state.q)[mask].abs().max()),
                    float((res.final_state.v.double() - ref.final_state.v)[mask].abs().max()))

        dq, dv = end_diff(win, agree)
        sq, sv = end_diff(ref32, agree32)
        q_tol, v_tol = max(GATED_Q_TOL, 10 * sq), max(GATED_V_TOL, 10 * sv)
        u = ref.mpc_usage > 0
        classes = {"MPC": u.all(1), "policy": (~u).all(1), "switching": u.any(1) & (~u).any(1)}
        by_class = {name: end_diff(win, agree & m) + (int((agree & m).sum()),)
                    for name, m in classes.items()}
        n_dis = int((~agree).sum())
        log(f"[9d] one gated window at B={n} (the card {card_s:.1f} s; the plain references on "
            f"the host CPU's workers, waited {wait_s:.1f} s): launches {win_launches}; usage "
            f"sequences agree with f64 in {int(agree.sum())} episodes, disagree in {n_dis} (<= "
            f"{int(0.05 * n)}); end-of-window q |d| {dq:.3e} (< {q_tol:.1e}), v |d| {dv:.3e} (< "
            f"{v_tol:.1e}) against the plain path in f64; by class (q, v, episodes) {by_class}; "
            f"the plain path's own f32 spread here q {sq:.3e}, v {sv:.3e} (CPU test: q "
            f"{GATED_SPREAD[0]:.3e}, v {GATED_SPREAD[1]:.3e})")
        # the window's plan (K1, K2 at the starts) against the plain path in f64,
        # per episode the largest |d| of xs_int over the window: at these
        # perturbed starts a third of the problems are so ill-conditioned that
        # f32 alone moves the plan past phase 7a's max gate, so the kernels are
        # held to the plain path's own f32 run beside them: a median within 10x
        # its median, and no more than 5% more episodes past 5e-2
        per_ep = {name: (xs[:, :50].double() - ref.xs_int).abs().flatten(1).amax(1).cpu().numpy()
                  for name, xs in (("kernels", plans[0].xs_int), ("plain f32", ref32.xs_int))}
        log("[9d] the window's plan vs the plain path in f64, per-episode max |d xs_int| "
            "(median / q0.9 / max; episodes over 7a's max gate 5e-2): " + "; ".join(
                f"{name} {np.median(d):.3e} / {np.quantile(d, 0.9):.3e} / {d.max():.3e}; "
                f"{int((d > 5e-2).sum())}" for name, d in per_ep.items()))
        plan_med_tol = max(5e-3, 10 * float(np.median(per_ep["plain f32"])))
        plan_far = [int((d > 5e-2).sum()) for d in per_ep.values()]
        log(f"[9d] gates: the kernels' median < {plan_med_tol:.1e}, episodes past 5e-2 <= "
            f"{plan_far[1]} + {int(0.05 * n)}")
        check(win_launches == {"admm": 1, "ddp": 1, "fused": 0}, "9d: one window, K1 and K2 once")
        check(n_dis <= 0.05 * n, f"9d: {n_dis} usage sequences disagree with f64")
        check(dq < q_tol and dv < v_tol, "9d: end-of-window state disagrees with the plain path")
        check(float(np.median(per_ep["kernels"])) < plan_med_tol and
              plan_far[0] <= plan_far[1] + 0.05 * n, "9d: the window's plan disagrees")

    log(json.dumps({"metric": "dagger_family", "calls": [c["summary"] for c in calls],
                    "phase_9a_s": round(t9a, 3), "phase_9a_to_9c_s": round(t9c, 3),
                    "database_rows": len(db), "goal": entry["goal"], "e_mpc": entry["e_mpc"],
                    "e_policy": entry["e_policy"], "card": card}, default=float))

    # ---- gates ----
    check(ok_launch, "a phase-9 call did not launch K1 and K2 once per window (K3 never; "
                     "none in the policy rollout)")
    check(launches == {n_: sum(c["launches"][n_] for c in calls) for n_ in launches},
          "phase-9 launch counts do not add up")
    check(ok_records, "phase-9 records of live episodes not finite, or failed ones not frozen")
    check(ok_agg, "phase-9 aggregation disagrees with the rule")
    check(rule_ok, "the gated records break SafeDAgger's rule")
    check(coins_ok, "DAgger's usage is not its coins")
    check(max(d9a[0], d9b[0], d9c[0]) < stale_tol, "a rollout did not run the current policy")
    check(d9b[2] > 0 and d9b[1] > 100 * stale_tol,
          "the check cannot tell the warmup policy from the current one")
    check(abs(post.sum() - 1.0) < 1e-9 and entry["posterior_entropy"] < np.log(30 ** 3),
          "the posterior is not normalised or did not concentrate")
    check(entry["aggregated"] == choice and errs == [entry["e_mpc"], entry["e_policy"]],
          "LocoSafeDagger did not aggregate the rollout with the smaller error")
    check(all(np.isfinite(losses)), "phase-9 losses not finite")
    return [c["launches"] for c in calls], {"warmup": (warm[0], warm_rows[0]),
                                            "final": (drv.policy, len(db))}, finish_9d


def per_problem_max(a, b):
    """Per-problem largest |a - b| over every other axis (numpy); inf where
    either is not finite."""
    d = (a.double() - b.double()).abs().flatten(1)
    return d.nan_to_num(nan=float("inf")).amax(1).cpu().numpy()


PLAN_FIELDS = ("xs_int", "us_int", "f_int", "X_opt", "F_opt", "xs", "us")


def diverged(plan):
    """The problems whose ADMM diverged: dyn_violation above 1e3 or not
    finite (jump from mid-trot states, ROADMAP "Faults found")."""
    return ~(plan.dyn_violation <= 1e3)


def iteration_stats(iters):
    """The ADMM iterations of a batch: the slowest problem's, which sets
    K1's time, and the mean."""
    it = iters.float()
    return {"max": int(it.max()), "mean": round(float(it.mean()), 2)}


def finite_rows(torch, plan):
    """Per problem, whether every plan field is finite."""
    return torch.stack([torch.isfinite(getattr(plan, f)).flatten(1).all(1)
                        for f in PLAN_FIELDS]).all(0)


def gait_case(robot, name, device):
    """A gait of phase 10a (``robot`` "solo12"), 11a ("go2") or 12
    ("solo8"): its spec on ``device``, its draws ``states_of(name, n)`` and
    its rho."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions import go2_cyclic, solo8_cyclic
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config

    if robot == "go2":
        return (workload.go2_spec(name, device=device), workload.go2_states,
                go2_cyclic.GAITS[name].rho)
    if robot == "solo8":
        return (workload.solo8_spec(name, device=device),
                lambda name, n: workload.solo8_states(n), solo8_cyclic.GAITS[name].rho)
    spec = KD.make_cyclic_spec(Solo12Config.load_model(), GAITS[name], Solo12Config.q0(),
                               device=device)
    return spec, workload.gait_states, GAITS[name].rho


PARITY_N = 64  # problems of phases 10a, 11a, 12 and 14 held against the plain path


def plain_reference(robot, name, dtype_name, batch):
    """The plain path ("torch", "torch") of a phase 10a/11a/12 gait on the host
    CPU in ``dtype_name`` on the first PARITY_N problems of its ``batch``
    draws (the card's float32 inputs, as ``gait_table`` passes them): ``xs``, ``X_opt``
    and ``dyn_violation`` as numpy arrays. Run in worker processes while the
    card works (the plain versions' time is their launches and host
    dispatch, seconds a gait whatever the batch)."""
    sys.path.insert(0, REPO)
    import torch

    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.solvers import cuda_admm
    from bunmpc_tpu_torch.solvers.ddp import DdpConfig

    torch.set_num_threads(1)
    spec, states_of, rho = gait_case(robot, name, "cpu")
    dtype = getattr(torch, dtype_name)
    sub = [torch.as_tensor(a, dtype=torch.float32)[:PARITY_N].double().to(dtype)
           for a in states_of(name, batch)]
    cfg = cuda_admm.CudaAdmmConfig(rho=rho, x_solver="thomas", fista_max_iters=30)
    plan = KD.solve_mpc_batch(spec, *sub, admm_cfg=cuda_admm.plain_config(cfg),
                              ddp_cfg=DdpConfig(), admm_backend="torch", ik_backend="torch")
    return {f: getattr(plan, f).numpy() for f in ("xs", "X_opt", "dyn_violation")}


def acyclic_reference(name, dtype_name, batch):
    """The plain path of a phase 14 motion on the host CPU in ``dtype_name``
    on the first PARITY_N problems of its ``batch`` draws (the card's float32
    inputs): ``xs``, ``X_opt`` and ``dyn_violation`` as numpy arrays."""
    sys.path.insert(0, REPO)
    import torch

    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import acyclic as AC

    torch.set_num_threads(1)
    spec = workload.acyclic_spec(name, device="cpu")
    dtype = getattr(torch, dtype_name)
    sub = [torch.as_tensor(a, dtype=torch.float32)[:PARITY_N].double().to(dtype)
           for a in workload.acyclic_states(name, batch)]
    plan = AC.solve_acyclic_mpc_batch(spec, *sub, admm_backend="torch", ik_backend="torch")
    return {f: getattr(plan, f).numpy() for f in ("xs", "X_opt", "dyn_violation")}


def submit_references(pool):
    """Every phase 10a, 11a, 12 and 14 plain reference (float64 and
    float32), queued on the worker pool: ``{(robot, name, dtype_name):
    future}`` (robot "acyclic" for phase 14's motions)."""
    from bunmpc_tpu_torch.mpc.motions import go2_cyclic, solo8_cyclic
    from bunmpc_tpu_torch.mpc.motions.solo12_acyclic import MOTIONS
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS

    jobs = [(robot, name, dt) for dt in ("float64", "float32")
            for robot, names in (("solo12", GAITS), ("go2", go2_cyclic.GAITS),
                                 ("solo8", solo8_cyclic.GAITS)) for name in names]
    refs = {job: pool.submit(plain_reference, *job, B) for job in jobs}
    refs.update({("acyclic", name, dt): pool.submit(acyclic_reference, name, dt, B)
                 for dt in ("float64", "float32") for name in MOTIONS})
    return refs


def gait_table(torch, tag, robot, names, refs, problem0, zero_counts, counts, card):
    """The main path and the fused path on each gait of ``names`` at B=512
    (``spec_of(name)``, ``states_of(name, B)``: problem 0 the gait's own
    check). Per gait: H and IK H, problems a block, both paths' solves/s,
    K1, K2 and K3 ms, converged_frac (at 1e-3 and, for a heavier robot's
    mass-scaled residuals, 1e-2); gates: launches per path, finite plans, K3's
    contact plan against its plain prologue (phase 5b's plan gates), both
    paths against the plain path in f64 on 64 problems (phase 6's quantile
    gate, or where f32 alone moves the plan past it, phase 9d's rule against
    the plain f32 run beside them; K3's ADMM is held to the plain one there;
    the plain runs come from ``refs``, computed on the host CPU by
    ``plain_reference``), and ``problem0(name, plan)`` -> (printed values,
    misses) on problem 0.
    Where the ADMM diverges (jump from mid-trot draws, in the JAX package
    too), f32 overflows: plans must be finite on every problem that did not
    diverge, and the problems that diverged on the kernels must be those that
    diverge on the plain path in f64 (of the 64, within 5%). Returns each
    gait's launches per path and the table."""
    from bunmpc_tpu_torch.mpc import ik as IK
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused
    from bunmpc_tpu_torch.solvers.ddp import DdpConfig

    n, ddp_cfg = PARITY_N, DdpConfig()
    launches, table, failures, fallback = {}, [], [], []
    for name in names:
        t_gait = time.perf_counter()
        spec, states_of, rho = gait_case(robot, name, "cuda")
        model, m = spec.model, spec.model.total_mass
        H, Hik = spec.horizon, spec.ik_hor
        inputs = tuple(torch.as_tensor(a, dtype=torch.float32, device=spec.device)
                       for a in states_of(name, B))
        cfg = cuda_admm.CudaAdmmConfig(rho=rho, x_solver="thomas", fista_max_iters=30)
        row = {"gait": name, "H": H, "ik_H": Hik, "joints": model.n_joints,
               "per_block": {"k1_k3": cuda_admm.launch_per_block(H),
                             "k2": cuda_ddp.launch_per_block(Hik, model.nq, model.nv)}}
        plans, launches[name], row["k2_launches_at_joints"] = {}, {}, {}
        for path, fuse in (("main", False), ("fused", True)):
            def solve():
                return KD.solve_mpc_batch(spec, *inputs, admm_cfg=cfg, ddp_cfg=ddp_cfg,
                                          admm_backend="cuda", ik_backend="cuda", fuse_prep=fuse)

            zero_counts()
            plans[path] = solve()
            torch.cuda.synchronize()
            launches[name][path] = counts()
            row["k2_launches_at_joints"][path] = cuda_ddp.KERNELS[model.n_joints].launches
            reps = []
            for _ in range(3):
                t0 = time.perf_counter()
                solve()
                torch.cuda.synchronize()
                reps.append(time.perf_counter() - t0)
            row[f"{path}_solves_per_sec"] = round(B / float(np.median(reps)), 1)
            p = plans[path]
            row[f"{path}_converged_frac"] = float((p.dyn_violation < 1e-3).float().mean())
            row[f"{path}_converged_frac_1e-2"] = float((p.dyn_violation < 1e-2).float().mean())
            row[f"{path}_diverged"] = int(diverged(p).sum())
            row[f"{path}_finite"] = bool((finite_rows(torch, p) | diverged(p)).all())
            row[f"{path}_admm_iters"] = iteration_stats(p.admm_iters)
        # the kernels alone, by CUDA events, on this gait's inputs
        prob = KD._prepare_problem(spec, *inputs)
        admm_in = (prob["plan"], m, prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"],
                   prob["X_wm"], prob["F_wm"], prob["x_bounds"])
        X = cuda_admm.solve(*admm_in, cfg)[0]
        tk, x0 = KD._build_ik_tasks(spec, prob, X)
        ws, wt, cw, xr = IK.dense_weights(model, spec.eff_frames, tk)
        ddp_in = (model, spec.eff_frames, x0, tk.ee_targets, tk.com_ref, tk.mom_ref, xr, ws, wt,
                  cw, tk.dts)
        ci = KD._compact_inputs(spec, *inputs)
        k3_in = (ci[1], ci[2], inputs[4], ci[3], ci[4], ci[5], ci[6], m, KD.make_prep_consts(spec))
        row["ms"] = {k: round(cuda_ms(torch, fn, 3), 4) for k, fn in (
            ("k1", lambda: cuda_admm.solve(*admm_in, cfg)),
            ("k2", lambda: cuda_ddp.solve_ik_batch(*ddp_in)),
            ("k3", lambda: cuda_fused.solve_from_state(*k3_in, cfg, H, spec.n_eff)))}
        # K3's contact plan against its plain prologue (phase 5b's plan gates)
        K = cuda_fused.solve_from_state(*k3_in, cfg, H, spec.n_eff)
        pv = cuda_fused.prep_values(*k3_in[:7], pc=k3_in[8], m=m, H=H, ne=spec.n_eff)
        flags = torch.equal(K[4], pv[0]) and torch.equal(K[7], pv[3] > 0.5)
        dr, ddt = float((K[5] - pv[1]).abs().max()), float((K[6] - pv[2]).abs().max())
        row["k3_plan"] = {"flags_equal": flags, "dr": dr, "ddt": ddt}
        # both paths against the plain path in f64 on n problems: phase 6's
        # quantile gate, or where f32 alone misses it, phase 9d's rule
        # against the plain f32 run beside them
        def plain_path(dtype):
            t0 = time.perf_counter()
            out = refs[(robot, name, str(dtype).split(".")[-1])].result()
            row["reference_wait_s"] = row.get("reference_wait_s", 0.0) + round(
                time.perf_counter() - t0, 3)
            return types.SimpleNamespace(**{f: torch.as_tensor(a, device=spec.device)
                                            for f, a in out.items()})

        ref = plain_path(torch.float64)
        div_p = diverged(ref).cpu()
        row["parity"], row["parity_gate"], quant = {}, {}, True
        row["parity_diverged"] = {"plain_f64": div_p.nonzero().flatten().tolist()}
        div_same = True
        for path, plan in plans.items():
            dk = {f: per_problem_max(getattr(plan, f)[:n], getattr(ref, f))
                  for f in ("xs", "X_opt")}
            allk = {f: np.nan_to_num((getattr(plan, f)[:n].double() - getattr(ref, f)).abs()
                                     .flatten().cpu().numpy(), nan=np.inf) for f in dk}
            div_k = diverged(plan)[:n].cpu()
            row["parity_diverged"][path] = div_k.nonzero().flatten().tolist()
            div_same &= int((div_k ^ div_p).sum()) <= int(0.05 * n)
            ok = all(float(np.quantile(d, 0.999)) < 5e-3 and float(d.max()) < 5e-2
                     for d in allk.values())
            row["parity"][path] = {f: {"q999": float(np.quantile(allk[f], 0.999)),
                                       "max": float(allk[f].max())} for f in allk}
            row["parity_gate"][path] = "f64 quantile" if ok else "plain f32"
            if not ok:
                fallback.append(f"{name} {path}")
                ref32 = plain_path(torch.float32)
                dp = {f: per_problem_max(getattr(ref32, f), getattr(ref, f)) for f in dk}
                row["parity"][path]["plain_f32_rule"] = {
                    f: {"median_kernels": float(np.median(dk[f])),
                        "median_plain_f32": float(np.median(dp[f])),
                        "far_kernels": int((dk[f] > 5e-2).sum()),
                        "far_plain_f32": int((dp[f] > 5e-2).sum())} for f in dk}
                ok = all(np.median(dk[f]) < max(5e-3, 10 * float(np.median(dp[f]))) and
                         (dk[f] > 5e-2).sum() <= (dp[f] > 5e-2).sum() + int(0.05 * n)
                         for f in dk)
            quant &= ok
        row["problem0"], miss = problem0(name, plans["main"])
        row["wall_s"] = round(time.perf_counter() - t_gait, 2)
        log(f"[{tag}] {name}: H {H}, IK H {Hik}; problems a block K1/K3 "
            f"{row['per_block']['k1_k3']}, K2 {row['per_block']['k2']}; solves/s main "
            f"{row['main_solves_per_sec']}, fused {row['fused_solves_per_sec']}; ms {row['ms']}; "
            f"ADMM iterations main {row['main_admm_iters']}, fused {row['fused_admm_iters']}; "
            f"converged_frac main {row['main_converged_frac']:.4f} (1e-2: "
            f"{row['main_converged_frac_1e-2']:.4f}), fused {row['fused_converged_frac']:.4f} "
            f"(1e-2: {row['fused_converged_frac_1e-2']:.4f}); diverged {row['main_diverged']}/"
            f"{row['fused_diverged']}; launches {launches[name]}; finite where not diverged "
            f"{row['main_finite']}/{row['fused_finite']}; K3's plan vs its plain prologue "
            f"{row['k3_plan']}; parity ({n} problems, "
            f"{row['parity_gate']}) {row['parity']}; diverged of the {n} "
            f"{row['parity_diverged']}; problem 0 {row['problem0']}; {row['wall_s']} s (waiting "
            f"for the plain references {row['reference_wait_s']} s)")
        table.append(row)
        if launches[name] != {"main": {"admm": 1, "ddp": 1, "fused": 0},
                              "fused": {"admm": 0, "ddp": 1, "fused": 1}}:
            miss.append("launches")
        if row["k2_launches_at_joints"] != {"main": 1, "fused": 1}:
            miss.append(f"K2 at {model.n_joints} joints")
        if not (row["main_finite"] and row["fused_finite"]):
            miss.append("finite")
        if not (flags and dr < 1e-5 and ddt < 1e-5):
            miss.append("K3's plan")
        if not quant:
            miss.append("parity")
        if not div_same:
            miss.append("diverged set")
        if miss:
            failures.append(f"{name}: {', '.join(miss)}")
    log(json.dumps({"metric": "gaits", "phase": tag, "batch": B, "gaits": table,
                    "parity_against_plain_f32": fallback, "card": card}))
    check(not failures, f"{tag}: {failures}")
    return launches, table


def every_gait(torch, refs, zero_counts, counts, card):
    """Phase 10a: ``gait_table`` on every Solo12 gait of ``GAITS`` on
    bench.py's draws, problem 0 the gait's own check
    (``workload.gait_states``), its dyn_violation under the JAX package's
    bound where the JAX package gates it."""
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import GAITS

    bound0 = {"bound_turn": 1e-3, "air_bound": 1e-3, "walk": 1e-2}  # tests/test_mpc.py:177-221

    def problem0(name, plan):
        v0 = float(plan.dyn_violation[0])
        miss = ["problem 0 dyn_violation"] if name in bound0 and not v0 < bound0[name] else []
        return {"dyn_violation": v0, "bound": bound0.get(name, "not gated")}, miss

    return gait_table(torch, "10a", "solo12", list(GAITS), refs, problem0, zero_counts, counts,
                      card)[0]


def go2_gaits(torch, refs, zero_counts, counts, card):
    """Phase 11a: ``gait_table`` on the Go2's four gaits (``go2_cyclic.GAITS``:
    generic foot offsets, the "vdes" warm start, rho 2e5-4e5, a 15.1 kg
    robot) on bench.py's recipe on the Go2's q0 (``workload.go2_states``).
    Problem 0 is the JAX Go2 tests' window (q0 at rest, t=0, v_des (0.3, 0,
    0)) and must meet their bounds (tests/test_go2.py:156-164): dyn_violation
    < 1e-2 (residuals scale with the mass) and a mean stance Fz a knot
    within 40 N of m g."""
    from bunmpc_tpu_torch.mpc.motions import go2_cyclic

    def problem0(name, plan):
        v0 = float(plan.dyn_violation[0])
        cnt, F = plan.cnt_plan[0, :, :, 0], plan.F_opt[0]
        fz = float((cnt * F[..., 2]).sum(-1).mean())
        mg = 15.097 * 9.81
        miss = []
        if not v0 < 1e-2:
            miss.append("problem 0 dyn_violation")
        if not abs(fz - mg) < 40.0:
            miss.append("problem 0 stance Fz")
        return {"dyn_violation": v0, "bound": 1e-2, "stance_fz_mean": fz,
                "mg": round(mg, 3)}, miss

    return gait_table(torch, "11a", "go2", list(go2_cyclic.GAITS), refs, problem0, zero_counts,
                      counts, card)


class Spy:
    """Records every call of the named functions of ``module`` (their
    arguments, result, wall seconds and the launches made inside) while in
    a ``with`` block; a call made inside another recorded call is recorded
    too."""

    def __init__(self, torch, module, names, counts):
        self.torch, self.module, self.counts = torch, module, counts
        self.originals = {n: getattr(module, n) for n in names}
        self.calls = []

    def _wrap(self, name):
        inner, torch = self.originals[name], self.torch

        def fn(*a, **k):
            before = self.counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = inner(*a, **k)
            torch.cuda.synchronize()
            after = self.counts()
            self.calls.append(dict(name=name, args=a, kwargs=k, res=res,
                                   wall=time.perf_counter() - t0,
                                   launches={n: after[n] - before[n] for n in after}))
            return res
        return fn

    def __enter__(self):
        for n in self.originals:
            setattr(self.module, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.originals.items():
            setattr(self.module, n, f)


def grid_on_host(res, v_des, w_des, skip):
    """A grid's metrics computed on the host from a rollout's records (in
    their dtype), independently of ``eval.velocity_grid``."""
    st = res.states[..., 0:2].cpu().numpy()
    vd = v_des.cpu().numpy()
    failed = res.failed.cpu().numpy()
    return {"vx_mse": ((st[:, skip:, 0] - vd[:, None, 0]) ** 2).mean(1),
            "vy_mse": ((st[:, skip:, 1] - vd[:, None, 1]) ** 2).mean(1),
            "survived": ~failed, "mean_speed": st[:, skip:, 0].mean(1),
            "fail_step": np.where(failed, res.fail_step.cpu().numpy(), st.shape[1])}


def eval_suite(torch, spec, sim, start, zero_counts, counts, card, vc_policies, cc_policy):
    """Phase 10b-10f: the eval suite on the port's entry points, on the
    closed loop of phase 7b (trot_sim from the 500 ms settled start, the
    "cuda" backends), 600-step episodes (``scripts/run_eval.py`` runs 2000;
    failures count after the first 500). 10b ``eval_mpc_grid`` over 16 vx x
    32 w; 10c ``compare_policies`` of 9a's warmup and final policies on that
    grid; 10d ``compare_cc_replanning`` of 9a's vc policy and 8b's cc policy
    over ``workload.command_draw(512)``; 10e ``max_force_search`` over 64
    directions (3 bisections) and its exactness against an unpushed call;
    10f ``run_past_goals_eval`` over 4 goals (BC 5 epochs at bc.yaml's
    widths). Returns each call's launches."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.eval import cc_replanning as CCR
    from bunmpc_tpu_torch.eval import max_force as MF
    from bunmpc_tpu_torch.eval import multi_database as MDB
    from bunmpc_tpu_torch.eval import past_goals as PG
    from bunmpc_tpu_torch.eval import velocity_grid as VG
    from bunmpc_tpu_torch.learning import bc as BC
    from bunmpc_tpu_torch.sim import physics, rollout

    p = spec.params
    cfg = rollout.RolloutConfig(episode_length=600, kp=p.kp, kd=p.kd, gait_period=p.gait_period)
    T, nw = cfg.episode_length, cfg.n_windows
    skip = int(0.2 * T)
    state0 = physics.SimState(start.q[0], start.v[0])
    names = ("rollout_mpc", "rollout_policy")
    mpc_once = {"admm": nw, "ddp": nw, "fused": 0}
    none = {"admm": 0, "ddp": 0, "fused": 0}
    out, fails = {}, []

    def record(tag, calls, launches):
        out[tag] = launches
        for c in calls:
            B_, T_ = c["res"].states.shape[:2]
            log(f"  [{tag}] {c['name']}: {B_} episodes x {T_} steps in {c['wall']:.2f} s "
                f"({B_ * T_ / c['wall']:.1f} env-steps/s), survival "
                f"{float(1 - c['res'].failed.float().mean()):.4f}; launches {c['launches']}")

    # ---- 10b. eval_mpc_grid: 16 vx x 32 w = 512 episodes ----
    vx, w = np.linspace(-0.3, 0.5, 16), np.linspace(-0.3, 0.3, 32)
    t0 = time.perf_counter()
    with Spy(torch, rollout, names, counts) as spy:
        zero_counts()
        grid = VG.eval_mpc_grid(spec, sim, cfg, state0, vx, w)
        launches = counts()
    record("10b", spy.calls, launches)
    (c,) = spy.calls
    finite, frozen = finite_and_frozen(torch, c["res"])
    host = grid_on_host(c["res"], c["args"][4], c["args"][5], skip)
    same = all(np.array_equal(getattr(grid, k), v) for k, v in host.items())
    surv = grid.survived.reshape(16, 32)
    speed = [float(grid.mean_speed.reshape(16, 32)[i][surv[i]].mean()) if surv[i].any()
             else float("nan") for i in range(16)]
    log(f"[10b] eval_mpc_grid {time.perf_counter() - t0:.1f} s: {grid.summary()}; survival by vx "
        f"{np.round(surv.mean(1), 3).tolist()}; survivors' mean speed by vx "
        f"{np.round(speed, 4).tolist()} (vx {np.round(vx, 3).tolist()}); launches {launches} "
        f"(expected {mpc_once}); records finite {finite}, frozen {frozen}; the result equals the "
        f"host's recomputation from the records {same}")
    if not (launches == mpc_once and c["launches"] == mpc_once and finite and frozen and same):
        fails.append("10b")

    # ---- 10c. compare_policies: 9a's warmup and final vc policies ----
    t0 = time.perf_counter()
    entries = [MDB.PolicyEntry(label=k, bundle=pol, db_size=rows, final_train_loss=float("nan"),
                               final_valid_loss=float("nan"))
               for k, (pol, rows) in vc_policies.items()]
    with Spy(torch, rollout, names, counts) as spy:
        zero_counts()
        cmp = MDB.compare_policies(spec, sim, cfg, state0, entries, vx, w)
        launches = counts()
    record("10c", spy.calls, launches)
    alone = {e.label: VG.eval_policy_grid(spec, sim, cfg, state0, e.bundle, vx, w)
             for e in entries}
    same = all(np.array_equal(getattr(cmp.grids[k], f.name), getattr(g, f.name))
               for k, g in alone.items() for f in dataclasses.fields(g))
    log(f"[10c] compare_policies {time.perf_counter() - t0:.1f} s: {json.dumps(cmp.summary())}; "
        f"launches {launches} (expected {none}); each grid equals eval_policy_grid alone {same}")
    if not (launches == none and same and len(spy.calls) == 2):
        fails.append("10c")

    # ---- 10d. compare_cc_replanning: 512 commands ----
    t0 = time.perf_counter()
    v_np, w_np = workload.command_draw(B, seed=0)
    with Spy(torch, rollout, names, counts) as spy:
        zero_counts()
        ccr = CCR.compare_cc_replanning(spec, sim, cfg, state0, vc_policies["final"][0], cc_policy,
                                        v_np, w_np)
        launches = counts()
    record("10d", spy.calls, launches)
    static_res, replan_res = spy.calls[1]["res"], spy.calls[2]["res"]
    q0h, v0h = start.q[0].cpu().double().numpy(), start.v[0].cpu().double().numpy()
    sched = CCR.desired_schedules(spec, q0h, v0h, v_np, w_np, T)
    goals = torch.as_tensor(CCR.static_cc_goals(spec, sched, q0h, v_np, T),
                            dtype=torch.float32, device=start.q.device)
    static_ok = torch.equal(static_res.vc_goals, goals)
    gfn = rollout.cc_goal_fn(spec.model, spec.eff_frames,
                             torch.as_tensor(sched, dtype=torch.float32, device=start.q.device))
    q_rec = torch.cat([replan_res.base[..., 0:2], replan_res.states[..., 26:43]], -1)
    d_replan = max(float((gfn(torch.tensor(k, device=q_rec.device), q_rec[:, k])
                          - replan_res.vc_goals[:, k]).abs().max()) for k in range(T))
    log(f"[10d] compare_cc_replanning {time.perf_counter() - t0:.1f} s: "
        f"{json.dumps(ccr.summary())}; launches {launches} (expected {none}); cc_static's "
        f"recorded goals equal static_cc_goals {static_ok}; cc_replanned's against cc_goal_fn "
        f"on the recorded q |d| max {d_replan:.3e} (< 1e-5)")
    if not (launches == none and len(spy.calls) == 3 and static_ok and d_replan < 1e-5):
        fails.append("10d")

    # ---- 10e. max_force_search: 64 directions, push at step 333 for 100 ms ----
    t0 = time.perf_counter()
    ang = np.linspace(0, 2 * np.pi, 64, endpoint=False)
    dirs = np.stack([np.cos(ang), np.sin(ang), np.zeros(64)], -1).astype(np.float32)
    ps, pd, v_des = T // 3, 100, np.zeros(3)  # max_force_search's default push start
    with Spy(torch, rollout, names, counts) as spy:
        zero_counts()
        f_max, hist = MF.max_force_search(spec, sim, cfg, state0, v_des, 0.0, n_bisect=3,
                                          directions=dirs, push_start=ps, push_duration=pd)
        launches = counts()
        frac0 = MF.survival_fraction(spec, sim, cfg, state0, v_des, 0.0, 0.0, dirs, ps, pd)
    record("10e", spy.calls, launches)
    lo, hi, rule = 0.0, 30.0, True
    for mid, frac in hist:
        rule &= mid == 0.5 * (lo + hi)
        lo, hi = (mid, hi) if frac >= 0.5 else (lo, mid)
    rule &= f_max == lo
    first, zero = spy.calls[0]["res"], spy.calls[-1]["res"]
    before = all(torch.equal(getattr(first, f)[:, :ps + 1], getattr(zero, f)[:, :ps + 1])
                 for f in ("states", "actions", "base"))
    after = int((first.states[:, ps + 1:] != zero.states[:, ps + 1:]).flatten(1).any(1).sum())
    per_call = [c["launches"] for c in spy.calls]
    log(f"[10e] max_force_search {time.perf_counter() - t0:.1f} s: f_max {f_max}, history "
        f"{hist}, unpushed survival {frac0}; launches per call {per_call} (expected {mpc_once} "
        f"each); the history follows the bisection rule {rule}; records before step {ps} equal "
        f"to the unpushed call's bit for bit {before}, episodes that differ after it {after}")
    if not (rule and before and after > 0 and all(x == mpc_once for x in per_call)
            and len(per_call) == 4):
        fails.append("10e")
    out["10e"] = per_call[:3]

    # ---- 10f. run_past_goals_eval: 4 goals, BC 5 epochs ----
    t0 = time.perf_counter()
    goal_list = np.stack([np.linspace(0.0, 0.4, 4), np.zeros(4), np.zeros(4), np.zeros(4)], 1)
    dbs, train = [], PG.train_policy

    def train_spy(db, *a, **k):
        dbs.append(db)
        return train(db, *a, **k)

    PG.train_policy = train_spy
    try:
        with Spy(torch, rollout, names, counts) as spy:
            zero_counts()
            pg = PG.run_past_goals_eval(spec, sim, cfg, start.q[0], start.v[0], goal_list,
                                        bc_cfg=BC.BcConfig(n_epoch=5))
            launches = counts()
    finally:
        PG.train_policy = train
    record("10f", spy.calls, launches)
    mpc = spy.calls[0]["res"]
    fs, failed = mpc.fail_step.cpu().numpy(), mpc.failed.cpu().numpy()
    keep = [(i, int(fs[i]) if failed[i] else T) for i in range(4)]
    keep = [(i, n_) for i, n_ in keep if n_ > 50]
    db = dbs[-1]
    rows_ok = len(db) == sum(n_ for _, n_ in keep) and all(
        np.array_equal(getattr(db, f), np.concatenate([getattr(mpc, f)[i, :n_].cpu().numpy()
                                                       for i, n_ in keep]))
        for f in ("states", "actions", "vc_goals")) if keep else len(db) == 0
    upper = np.triu(np.ones((4, 4), bool), 1)
    tri = bool((np.isnan(pg.error_vx) == upper).all() and (np.isnan(pg.error_vy) == upper).all()
               and not pg.survived[upper].any())
    names_ = [c["name"] for c in spy.calls]
    log(f"[10f] run_past_goals_eval {time.perf_counter() - t0:.1f} s: error_vx "
        f"{np.round(pg.error_vx, 5).tolist()}, survived {pg.survived.astype(int).tolist()}, "
        f"forgetting {pg.forgetting():.5g}; calls {names_}; launches {launches} (K1, K2 {nw} "
        f"in the one MPC call); the matrices lower-triangular with NaN exactly above the "
        f"diagonal {tri}; the database's {len(db)} rows are the T > 50 rule's {rows_ok}")
    if not (names_ == ["rollout_mpc"] + ["rollout_policy"] * 4 and spy.calls[0]["launches"]
            == mpc_once and launches == mpc_once and tri and rows_ok):
        fails.append("10f")
    log(json.dumps({"metric": "eval_suite", "grid": grid.summary(), "compare_policies":
                    cmp.summary(), "cc_replanning": ccr.summary(), "f_max": f_max,
                    "history": hist, "forgetting": pg.forgetting(), "launches": out,
                    "card": card}, default=float))
    check(not fails, f"phase-10 gates missed: {fails}")
    return out


def end_diff_at(a, b):
    """Largest |d| of the end q and v of two rollouts' first episodes (of
    ``b``'s batch)."""
    n = b.final_state.q.shape[0]
    return (float((a.final_state.q[:n].double() - b.final_state.q.double()).abs().max()),
            float((a.final_state.v[:n].double() - b.final_state.v.double()).abs().max()))


def capture_solves(KD, plans):
    """Replace ``KD.solve_mpc_batch`` by a wrapper that appends every plan to
    ``plans``; returns the original, which the caller puts back."""
    solve_batch = KD.solve_mpc_batch

    def fn(*a, **k):
        plans.append(solve_batch(*a, **k))
        return plans[-1]

    KD.solve_mpc_batch = fn
    return solve_batch


def plan_rule(name, kernels, plain64, plain32, n):
    """Per-episode largest |d| of a window's plan (xs_int over the window)
    against the plain path in f64: phase 6's quantile gate, or where f32 alone
    misses it, phase 9d's rule against the plain f32 run beside them (a
    median within 10x its median, no more than 5% more episodes past 5e-2).
    Prints and returns whether it holds."""
    ref = plain64.xs_int[:, :50]
    d = {k: (p.xs_int[:n, :50].double() - ref).abs() for k, p in (("kernels", kernels),
                                                                  ("plain f32", plain32))}
    flat = d["kernels"].flatten().cpu().numpy()
    q, mx = float(np.quantile(flat, 0.999)), float(flat.max())
    per_ep = {k: v.flatten(1).amax(1).cpu().numpy() for k, v in d.items()}
    ok = q < 5e-3 and mx < 5e-2
    rule = "f64 quantile"
    if not ok:
        rule = "plain f32"
        ok = (float(np.median(per_ep["kernels"])) < max(5e-3, 10 * float(np.median(
            per_ep["plain f32"]))) and int((per_ep["kernels"] > 5e-2).sum())
            <= int((per_ep["plain f32"] > 5e-2).sum()) + int(0.05 * n))
    log(f"  {name}: xs_int |d| q0.999 {q:.3e} (< 5e-3), max {mx:.3e} (< 5e-2); per-episode "
        f"median kernels {np.median(per_ep['kernels']):.3e}, plain f32 "
        f"{np.median(per_ep['plain f32']):.3e}; episodes past 5e-2 kernels "
        f"{int((per_ep['kernels'] > 5e-2).sum())}, plain f32 "
        f"{int((per_ep['plain f32'] > 5e-2).sum())}; gate: {rule} -> {ok}")
    return ok


def tree_map(fn, x):
    """``fn`` on every tensor inside ``x`` (a tensor, a dataclass such as
    ``SimParams`` or ``IdControllerGains``, or a NamedTuple such as
    ``SimState``); everything else as it is."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: tree_map(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, a) for a in x))
    return fn(x) if hasattr(x, "dim") else x


SWEEP_ARTIFACT = os.path.join(REPO, "artifacts", "stability_sweep_go2.json")
SWEEP_ROW_11C = 31  # kp 60, kd 3, kn 6e4, dn 3000, kt 3000, swing_blend 0.5, force_gate 1


def go2_loop(torch, zero_counts, counts, card, pool):
    """Phase 11b-11d: the Go2's closed loop (``trot_sim``, the JAX package's
    walking configuration: kp 60 / kd 3, contact kn 6e4 / dn 3000 / kt 3000,
    swing_blend 0.5, force_gate 1.0, the "vdes" warm start and no carry).
    The starts are the stability sweep's settle (every row of
    ``workload.go2_sweep_grid()`` PD-held 500 ms at its own gains on its own
    contact, one batched ``settle_state``); row 31 is ``trot_sim`` on
    ``go2_sim_params()``, i.e. ``workload.go2_settled_start``, and 11c starts
    from it.

    11b one window (50 steps) at B=64, the sweep's rows as per-episode gains
    and contact, swing_blend 0.5, force_gate 1.0 and seeded sensor biases,
    against the plain path in f64 (end state within GO2_WINDOW_*_TOL, 10x
    the CPU test's f32 spread; the plan by phase 6's or 9d's rule); 11c 512
    episodes x 3000 steps, gated on statistics over the batch (the JAX gait
    gate's criteria, tests/test_gait_quality.py:75-101); 11d the sweep's 40
    rows as one ``rollout_mpc`` call of 3000 steps with every option per
    episode, and row 31 (inside the sweep and alone) against 11c's episode 0
    over the first window. 11b's plain references run on the host CPU's
    workers (``pool``). Returns each call's launches and ``finish_11b()``,
    which waits for them and holds the card's window to them."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.go2_cyclic import trot_sim
    from bunmpc_tpu_torch.sim import physics, rollout
    from bunmpc_tpu_torch.utils.quat import quat_to_rot, rot_to_rpy

    f32 = torch.float32
    spec = workload.go2_spec("trot_sim")
    grid = workload.go2_sweep_grid()
    n_rows = len(grid["kp"])
    gains, sp, sb, fg = workload.go2_sweep_options(grid)
    t0 = time.time()
    sweep_start = workload.go2_settled_start(n_rows, sim_params=sp, kp=gains.kp, kd=gains.kd)
    torch.cuda.synchronize()
    log(f"[11] the sweep's settle ({n_rows} rows, 500 ms PD hold): {time.time() - t0:.1f} s; "
        f"row {SWEEP_ROW_11C} base z {float(sweep_start.q[SWEEP_ROW_11C, 2]):.4f} m")
    launches = {}

    def take(x, idx):
        return tree_map(lambda t: t[idx].contiguous(), x)

    def to(x, dtype):
        return tree_map(lambda t: t.to(dtype), x)

    # ---- 11b. one window at B=64 with every option, against the plain path in f64 ----
    n = 64
    case = workload.go2_window_inputs(n)
    idx = torch.as_tensor(case.pop("rows"), device=spec.device)
    opts = dict(gains=take(gains, idx), sim_params=take(sp, idx), swing_blend=0.5,
                force_gate=1.0)
    host = case
    win_cfg = rollout.RolloutConfig(episode_length=50, kp=trot_sim.kp, kd=trot_sim.kd,
                                    gait_period=trot_sim.gait_period)
    start64 = take(sweep_start, idx)

    def window(dtype):
        d = {k: torch.as_tensor(a, dtype=dtype, device=spec.device) for k, a in host.items()}
        o = {k: to(v, dtype) for k, v in opts.items()}
        return rollout.rollout_mpc(spec, o.pop("sim_params"), win_cfg, to(start64, dtype),
                                   d["v_des"], d["w_des"], q_noise=d["q_noise"],
                                   v_noise=d["v_noise"], **o)

    plain_refs = {dt: pool.submit(go2_window_reference, *(a.cpu().numpy() for a in start64), dt)
                  for dt in ("float64", "float32")}
    t0 = time.perf_counter()
    plans = []
    solve_batch = capture_solves(KD, plans)
    try:
        zero_counts()
        win = window(f32)
        torch.cuda.synchronize()
        launches["11b"] = counts()
    finally:
        KD.solve_mpc_batch = solve_batch
    card_s = time.perf_counter() - t0

    def finish_11b():
        t1 = time.perf_counter()
        plain = {dt: reference_rollout(torch, f, spec.device) for dt, f in
                 (("f64", plain_refs["float64"]), ("f32", plain_refs["float32"]))}
        wait_s = time.perf_counter() - t1
        dq, dv = end_diff_at(win, plain["f64"][0])
        sq, sv = end_diff_at(plain["f32"][0], plain["f64"][0])
        log(f"[11b] one Go2 window at B={n} (the card {card_s:.1f} s; the plain references on "
            f"the host CPU's workers, waited {wait_s:.1f} s): launches {launches['11b']}; end q "
            f"|d| {dq:.3e} (< {GO2_WINDOW_Q_TOL:.1e}), v |d| {dv:.3e} (< {GO2_WINDOW_V_TOL:.1e}) "
            f"against the plain path in f64; the plain path's own f32 spread here q {sq:.3e}, v "
            f"{sv:.3e} (CPU test: q {GO2_WINDOW_SPREAD[0]:.3e}, v {GO2_WINDOW_SPREAD[1]:.3e}); "
            "the window's plan:")
        plan_ok = plan_rule("11b plan", plans[0], plain["f64"][1][0], plain["f32"][1][0], n)
        check(launches["11b"] == {"admm": 1, "ddp": 1, "fused": 0},
              "11b: one window must launch K1 and K2 once each")
        check(bool(torch.isfinite(win.states).all()), "11b: window records not finite")
        check(dq < GO2_WINDOW_Q_TOL and dv < GO2_WINDOW_V_TOL,
              "11b: end-of-window state disagrees with the plain path in f64")
        check(plan_ok, "11b: the window's plan disagrees with the plain path in f64")

    # ---- 11c. the Go2 closed loop: 512 episodes x 3000 steps ----
    loop_cfg = rollout.RolloutConfig(episode_length=3000, kp=trot_sim.kp, kd=trot_sim.kd,
                                     gait_period=trot_sim.gait_period)
    T, nw = loop_cfg.episode_length, loop_cfg.n_windows
    start = physics.SimState(sweep_start.q[SWEEP_ROW_11C:SWEEP_ROW_11C + 1].expand(B, -1)
                             .contiguous(),
                             sweep_start.v[SWEEP_ROW_11C:SWEEP_ROW_11C + 1].expand(B, -1)
                             .contiguous())
    v_np, w_np = workload.go2_commands(B, seed=0)
    cmd = tuple(torch.as_tensor(a, dtype=f32, device=spec.device) for a in (v_np, w_np))
    sim = workload.go2_sim_params()
    windows = []

    def timed_solve(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        plan = solve_batch(*a, **k)
        e1.record()
        windows.append((e0, e1, plan.dyn_violation, plan.admm_iters))
        return plan

    KD.solve_mpc_batch = timed_solve
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout.rollout_mpc(spec, sim, loop_cfg, start, *cmd, swing_blend=0.5,
                                  force_gate=1.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["11c"] = counts()
    finally:
        KD.solve_mpc_batch = solve_batch
    nv = spec.model.nv
    failed, fail_step = res.failed.cpu().numpy(), res.fail_step.cpu().numpy()
    alive = ~failed
    finite, frozen = finite_and_frozen(torch, res)
    rpy = rot_to_rpy(quat_to_rot(res.states[..., nv + 9:nv + 13])).cpu().numpy()
    z = res.states[..., nv + 8].cpu().numpy()  # q[2]
    vx = res.states[..., 0].cpu().numpy()
    roll_max = np.rad2deg(np.abs(rpy[alive, 500:, 0]).max(axis=1))
    z_dev = np.abs(z[alive, -1000:].mean(axis=1) - trot_sim.nom_ht)
    vx_ratio = vx[alive, -1000:].mean(axis=1) / v_np[alive, 0]
    survival = float(alive.mean())

    def med(a):
        return float(np.median(a)) if alive.any() else float("nan")

    solve_ms = [a.elapsed_time(b) for a, b, _, _ in windows]
    window_ms = [windows[i][0].elapsed_time(windows[i + 1][0]) for i in range(nw - 1)]
    sub_ms = [w - s_ for w, s_ in zip(window_ms, solve_ms)]
    viols = torch.stack([w[2] for w in windows]).cpu().numpy()
    iters = torch.stack([w[3] for w in windows]).float().cpu().numpy()
    live = fail_step[None, :] > (np.arange(nw) * loop_cfg.steps_per_plan)[:, None]
    log(f"[11c] Go2 closed loop: {B} episodes x {T} steps ({nw} windows) in {wall:.2f} s, "
        f"{B * T / wall:.1f} env-steps/s; launches {launches['11c']}; window / solve / substeps "
        f"ms {np.mean(window_ms):.1f} / {np.mean(solve_ms):.1f} / {np.mean(sub_ms):.1f}")
    log(f"[11c] survival {survival:.4f} (>= 0.5), episode 0 (vx 0.3) failed {bool(failed[0])} "
        f"at {int(fail_step[0])}; survivors' median roll_max (500-3000 ms) {med(roll_max):.3f} "
        f"deg (< 15), median |mean z (last 1000 ms) - {trot_sim.nom_ht}| {med(z_dev):.4f} m "
        f"(< 0.05), median vx_end / vx_cmd {med(vx_ratio):.3f} (> 0.5); live solves: "
        f"converged_frac {float((viols[live] < 1e-3).mean()):.4f} (1e-2: "
        f"{float((viols[live] < 1e-2).mean()):.4f}), ADMM iterations mean "
        f"{float(iters[live].mean()):.2f}; records finite {finite}, failed frozen {frozen}")
    log(json.dumps({
        "metric": "go2_closed_loop_env_steps_per_sec", "value": round(B * T / wall, 1),
        "batch": B, "steps": T, "wall_s": round(wall, 3), "survival": survival,
        "median_roll_max_deg": med(roll_max), "median_z_dev_m": med(z_dev),
        "median_vx_ratio": med(vx_ratio),
        "window_ms_mean": round(float(np.mean(window_ms)), 3),
        "solve_ms_mean": round(float(np.mean(solve_ms)), 3),
        "substeps_ms_mean": round(float(np.mean(sub_ms)), 3),
        "admm_iters_mean": float(iters[live].mean()), "card": card}))
    check(launches["11c"] == {"admm": nw, "ddp": nw, "fused": 0},
          f"11c: K1 and K2 must launch once per window ({nw})")
    check(finite and frozen, "11c: live records not finite, or failed episodes not frozen")
    check(survival >= 0.5, f"11c: survival {survival:.4f} below 0.5")
    check(med(roll_max) < 15.0, "11c: survivors' median roll_max not below 15 deg")
    check(med(z_dev) < 0.05, "11c: survivors' median height error not below 0.05 m")
    check(med(vx_ratio) > 0.5, "11c: survivors' median vx_end / vx_cmd not above 0.5")

    # ---- 11d. the stability sweep: 40 rows, every option per episode, one call ----
    sweep_cfg = rollout.RolloutConfig(episode_length=SWEEP_STEPS, kp=trot_sim.kp, kd=trot_sim.kd,
                                      gait_period=trot_sim.gait_period)
    snw = sweep_cfg.n_windows
    vd = torch.zeros((n_rows, 3), dtype=f32, device=spec.device)
    vd[:, 0] = 0.3
    wd = torch.zeros(n_rows, dtype=f32, device=spec.device)
    zero_counts()
    t0 = time.perf_counter()
    sweep = rollout.rollout_mpc(spec, sp, sweep_cfg, sweep_start, vd, wd, gains=gains,
                                swing_blend=sb, force_gate=fg)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    launches["11d"] = counts()
    r = SWEEP_ROW_11C
    one = {k: take(v, slice(r, r + 1)) for k, v in (("gains", gains), ("sp", sp), ("sb", sb),
                                                     ("fg", fg))}
    alone = rollout.rollout_mpc(spec, one["sp"], win_cfg, take(sweep_start, slice(r, r + 1)),
                                vd[r:r + 1], wd[r:r + 1], gains=one["gains"],
                                swing_blend=one["sb"], force_gate=one["fg"])
    torch.cuda.synchronize()
    sfinite, sfrozen = finite_and_frozen(torch, sweep)

    def at_step50(rec, b):  # (q[2:], v) of the state before step 50, from the features
        return rec.states[b, 50, nv + 8:].double(), rec.states[b, 50, :nv].double()

    q11c, v11c = at_step50(res, 0)
    q_in, v_in = at_step50(sweep, r)
    uq_in, uv_in = float((q_in - q11c).abs().max()), float((v_in - v11c).abs().max())
    uq_al = float((alone.final_state.q[0, 2:].double() - q11c).abs().max())
    uv_al = float((alone.final_state.v[0].double() - v11c).abs().max())
    with open(SWEEP_ARTIFACT) as fh:
        art = json.load(fh)["rows"]
    srpy = rot_to_rpy(quat_to_rot(sweep.states[..., nv + 9:nv + 13])).cpu().numpy()
    sfail, sstep = sweep.failed.cpu().numpy(), sweep.fail_step.cpu().numpy()
    log(f"[11d] the Go2 sweep: {n_rows} rows x {SWEEP_STEPS} steps ({snw} windows) in one call, "
        f"{swall:.2f} s; launches {launches['11d']}; live records finite {sfinite}, failed "
        f"frozen {sfrozen}; row {r} (11c's settings, vx 0.3) against 11c's episode 0 at step 50:"
        f" in the sweep q |d| {uq_in:.3e}, v |d| {uv_in:.3e}; alone q |d| {uq_al:.3e}, v |d| "
        f"{uv_al:.3e} (< {GO2_WINDOW_Q_TOL:.1e}, {GO2_WINDOW_V_TOL:.1e})")
    log("[11d] per row: kp kd kn sb fg | this run: failed at (ms), roll_max 500+ ms (deg) | the "
        "JAX package's sweep on a TPU v5e (artifacts/stability_sweep_go2.json): failed at, "
        "roll_max")
    check(len(art) == n_rows and all(
        abs(art[i][k] - grid[k][i]) < 1e-9 for i in range(n_rows)
        for k in ("kp", "kd", "kn", "dn", "kt", "swing_blend", "force_gate")),
        "11d: the grid's rows are not the artifact's")
    for i in range(n_rows):
        a = art[i]
        rm = float(np.rad2deg(np.abs(srpy[i, 500:, 0]).max())) if SWEEP_STEPS > 500 else \
            float("nan")
        log(f"  {i:2d}: {grid['kp'][i]:g} {grid['kd'][i]:g} {grid['kn'][i]:g} "
            f"{grid['swing_blend'][i]:g} {grid['force_gate'][i]:g} | "
            f"{int(sstep[i]) if sfail[i] else 'survived':>8} {rm:7.2f} | "
            f"{a['fail_step'] if a['failed'] else 'survived':>8} {a['roll_max_deg']:7.2f}")
    log(json.dumps({"metric": "go2_sweep", "rows": n_rows, "steps": SWEEP_STEPS,
                    "wall_s": round(swall, 3), "survival": float(1 - sfail.mean()),
                    "jax_tpu_v5e_survival": float(np.mean([not a["failed"] for a in art])),
                    "card": card}))
    check(launches["11d"] == {"admm": snw, "ddp": snw, "fused": 0},
          f"11d: K1 and K2 must launch once per window ({snw})")
    check(sfinite and sfrozen, "11d: live records not finite, or failed episodes not frozen")
    check(uq_in < GO2_WINDOW_Q_TOL and uv_in < GO2_WINDOW_V_TOL and uq_al < GO2_WINDOW_Q_TOL
          and uv_al < GO2_WINDOW_V_TOL,
          "11d: row 31 does not run 11c's episode 0 (a per-episode option frozen in the graph?)")
    return launches, finish_11b


SOLO8_MG = 2.1154 * 9.81  # tests/test_solo8.py:101


def solo8_phase(torch, refs, zero_counts, counts, card):
    """Phase 12: ``gait_table`` on the Solo8's trot (8 joints: K2's 8-joint
    build) on bench.py's recipe about its standing q0 (``workload.solo8_states``),
    problem 0 the JAX Solo8 test's window under its bounds
    (tests/test_solo8.py:83-102: violation < 1e-3, mean stance Fz within 6 N
    of m g). Then K2 at 8 joints alone on the main path's IK problems: the
    kernel against its plain version in f64 on 64 problems (phase 4(b)'s
    quantile gate) and both timed, for the kernels line. Returns the gait's
    launches per path and the 8-joint K2's numbers."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import ik as IK
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo8_cyclic import trot
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    def problem0(name, plan):
        v0 = float(plan.dyn_violation[0])
        cnt, F = plan.cnt_plan[0, :, :, 0], plan.F_opt[0]
        fz = float((cnt * F[..., 2]).sum(-1).mean())
        miss = []
        if not v0 < 1e-3:
            miss.append("problem 0 dyn_violation")
        if not abs(fz - SOLO8_MG) < 6.0:
            miss.append("problem 0 stance Fz")
        return {"dyn_violation": v0, "bound": 1e-3, "stance_fz_mean": fz,
                "mg": round(SOLO8_MG, 3)}, miss

    launches, _ = gait_table(torch, "12", "solo8", ["trot"], refs, problem0, zero_counts, counts,
                             card)
    spec = workload.solo8_spec("trot")
    model = spec.model
    inputs = tuple(torch.as_tensor(a, dtype=torch.float32, device=spec.device)
                   for a in workload.solo8_states(B))
    prob = KD._prepare_problem(spec, *inputs)
    cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, x_solver="thomas", fista_max_iters=30)
    X = cuda_admm.solve(prob["plan"], model.total_mass, prob["x_init"], prob["W"], prob["X_ref"],
                        prob["W_F"], prob["X_wm"], prob["F_wm"], prob["x_bounds"], cfg)[0]
    tasks, x0 = KD._build_ik_tasks(spec, prob, X)
    ws, wt, cw, xr = IK.dense_weights(model, spec.eff_frames, tasks)
    ddp_in = (model, spec.eff_frames, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, xr, ws,
              wt, cw, tasks.dts)
    full = cuda_ddp.CudaDdpConfig()
    xs_k = cuda_ddp.solve_ik_batch(*ddp_in, cfg=full)[0]
    xs_p = cuda_ddp.solve_ik_batch_plain(*[a[:PARITY_N].double() if torch.is_tensor(a) else a
                                           for a in ddp_in], cfg=full)[0]
    torch.cuda.synchronize()
    log(f"[12] K2 at 8 joints (kernel f32 vs plain f64, {PARITY_N} problems of the main path):")
    err = quantile_gate("K2 xs (8 joints)", xs_k[:PARITY_N].double(), xs_p)
    check(bool(torch.isfinite(xs_k).all()), "K2 at 8 joints not finite")
    Hik = spec.ik_hor
    ms = cuda_ms(torch, lambda: cuda_ddp.solve_ik_batch(*ddp_in, cfg=full), 3)
    plain_ms = cuda_ms(torch, lambda: cuda_ddp.solve_ik_batch_plain(*ddp_in, cfg=full), 1)
    bound, by = bound_ms(ddp_bytes(B, Hik, nj=8), ddp_ops(B, Hik, full, nj=8))
    k2 = {"max_abs_err": err, "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
          "bound_ms": round(bound, 6), "bound_by": by,
          "per_block": cuda_ddp.launch_per_block(Hik, model.nq, model.nv)}
    log(f"[12] K2 at 8 joints, IK H {Hik}: {k2}")
    return launches, k2


def to_host(x):
    """Tensors inside ``x`` (a tuple, a named tuple or a ContactPlan) as
    numpy arrays on the host; anything else as it is."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if hasattr(x, "cnt"):
        return type(x)(cnt=to_host(x.cnt), r=to_host(x.r), dt=to_host(x.dt))
    if isinstance(x, tuple):
        items = [to_host(a) for a in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def from_host(torch, x, dtype, device="cpu"):
    """``to_host``'s inverse (and of a dict of arrays): numpy arrays as
    tensors on ``device``, their floating values in ``dtype`` (None: as they
    are)."""
    if isinstance(x, np.ndarray):
        t = torch.as_tensor(x, device=device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    if isinstance(x, dict):
        return {k: from_host(torch, v, dtype, device) for k, v in x.items()}
    if hasattr(x, "cnt"):
        return type(x)(cnt=from_host(torch, x.cnt, dtype, device),
                       r=from_host(torch, x.r, dtype, device),
                       dt=from_host(torch, x.dt, dtype, device))
    if isinstance(x, tuple):
        items = [from_host(torch, a, dtype, device) for a in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def plain_job(kind, args, cfg, dtype_name, kw=None):
    """A plain reference of phases 3-6 on the host CPU (one PyTorch thread):
    ``"admm"`` ``cuda_admm.solve_plain(*args, cfg, **kw)``, ``"ddp"``
    ``cuda_ddp.solve_ik_batch_plain(*args, cfg=cfg)``, ``"mpc"`` the plain
    path of the trot (``solve_mpc_batch`` on the "torch" backends with
    ``cuda_admm.plain_config(cfg)``) on ``args`` (q, v, t, v_des, w_des).
    ``args`` and ``kw`` are ``to_host`` copies of the card's inputs, run in
    ``dtype_name``; returns the result the same way."""
    sys.path.insert(0, REPO)
    import torch

    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    torch.set_num_threads(1)
    dtype = getattr(torch, dtype_name)
    a = from_host(torch, args, dtype)
    kw = {k: from_host(torch, v, dtype) for k, v in (kw or {}).items()}
    if kind == "admm":
        return to_host(cuda_admm.solve_plain(*a, cfg, **kw))
    if kind == "ddp":
        return to_host(cuda_ddp.solve_ik_batch_plain(*a, cfg=cfg))
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.solvers.ddp import DdpConfig

    spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot, Solo12Config.q0(), device="cpu")
    plan = KD.solve_mpc_batch(spec, *a, admm_cfg=cuda_admm.plain_config(cfg), ddp_cfg=DdpConfig(),
                              admm_backend="torch", ik_backend="torch")
    return {"xs": plan.xs.numpy(), "X_opt": plan.X_opt.numpy()}


def plain_window(dtype_name, run):
    """The worker protocol of the plain references, run in worker processes
    while the card works: one PyTorch thread, and every plan that
    ``KD.solve_mpc_batch`` returns captured. ``run(torch, dtype, t)`` drives
    one rollout on the host CPU in ``dtype_name`` with the plain backends;
    ``t`` turns the card's float32 values (numpy) into ``dtype``. Returns the
    end state as numpy arrays, the rollout's result and the captured plans."""
    sys.path.insert(0, REPO)
    import torch

    from bunmpc_tpu_torch.mpc import kino_dyn as KD

    torch.set_num_threads(1)
    dtype = getattr(torch, dtype_name)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32).to(dtype)

    plans = []
    solve_batch = capture_solves(KD, plans)
    try:
        res = run(torch, dtype, t)
    finally:
        KD.solve_mpc_batch = solve_batch
    return ({"final_q": res.final_state.q.numpy(), "final_v": res.final_state.v.numpy()}, res,
            plans)


def window_reference(q, v, v_des, w_des, dtype_name, grade=None):
    """The plain path ("torch", "torch") of two windows of the ``trot_sim``
    loop on the host CPU in ``dtype_name``, from the given start and
    commands (numpy, the card's float32 values), on flat ground or, with
    ``grade``, on ``workload.slope_terrain(grade)`` (phases 7a and 13b): the
    end state, and per window the plan's first 50 ms of ``xs_int``,
    ``f_int`` at substep 0, ``P_opt`` and ``admm_iters``, as numpy arrays."""

    def run(torch, dtype, t):
        from bunmpc_tpu_torch import workload
        from bunmpc_tpu_torch.mpc import kino_dyn as KD
        from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
        from bunmpc_tpu_torch.robots.solo12 import Solo12Config
        from bunmpc_tpu_torch.sim import physics, rollout

        spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0(),
                                   device="cpu")
        cfg = rollout.RolloutConfig(episode_length=100, kp=trot_sim.kp, kd=trot_sim.kd,
                                    gait_period=trot_sim.gait_period)
        terrain = None if grade is None else workload.slope_terrain(grade, device="cpu",
                                                                     dtype=dtype)
        return rollout.rollout_mpc(spec, workload.closed_loop_sim_params(), cfg,
                                   physics.SimState(t(q), t(v)), t(v_des), t(w_des),
                                   terrain=terrain, admm_backend="torch", ik_backend="torch")

    out, _, plans = plain_window(dtype_name, run)
    out["plans"] = [{"xs_int": p.xs_int[:, :50].numpy(), "f_int": p.f_int[:, 0].numpy(),
                     "P_opt": p.P_opt.numpy(), "admm_iters": p.admm_iters.numpy()}
                    for p in plans]
    return out


def gated_window_reference(q, v, v_des, w_des, start_time, rcfg, policy, dtype_name):
    """The plain path of phase 9d's gated window (``rollout_safedagger`` of the
    ``trot_sim`` loop, 150 blocked steps) on the host CPU in ``dtype_name``,
    from the card's float32 starts, commands and start times and the policy
    (``(state_dict, [state_mean, state_std, goal_mean, goal_std])`` as numpy
    arrays): the end state, the usage and the window's plan's first 50 ms of
    ``xs_int``, as numpy arrays."""

    def run(torch, dtype, t):
        from bunmpc_tpu_torch import workload
        from bunmpc_tpu_torch.learning import networks
        from bunmpc_tpu_torch.mpc import kino_dyn as KD
        from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
        from bunmpc_tpu_torch.robots.solo12 import Solo12Config
        from bunmpc_tpu_torch.sim import physics, rollout

        spec = KD.make_cyclic_spec(Solo12Config.load_model(), trot_sim, Solo12Config.q0(),
                                   device="cpu")
        sd, stats = policy
        n_dense = sum(1 for name in sd if name.endswith(".weight"))
        module = networks.GoalConditionedPolicyNet(
            sd["dense.0.weight"].shape[1], sd[f"dense.{n_dense - 1}.weight"].shape[0],
            n_dense - 1, sd["dense.0.weight"].shape[0]).to(dtype)
        module.load_state_dict({name: torch.as_tensor(a) for name, a in sd.items()})
        bundle = networks.PolicyBundle(module.eval(), *(t(a) for a in stats))
        return rollout.rollout_safedagger(
            spec, workload.closed_loop_sim_params(), rcfg, physics.SimState(t(q), t(v)),
            t(v_des), t(w_des), bundle, num_steps_to_block=150, start_time=t(start_time),
            admm_backend="torch", ik_backend="torch")

    out, res, plans = plain_window(dtype_name, run)
    out.update(mpc_usage=res.mpc_usage.numpy(), xs_int=plans[0].xs_int[:, :50].numpy())
    return out


def go2_window_reference(q, v, dtype_name):
    """The plain path of phase 11b's Go2 window (``trot_sim``, every
    per-episode option of ``workload.go2_window_inputs``) on the host CPU in
    ``dtype_name`` from the card's settled starts (numpy, float32): the end
    state and the window's plan's first 50 ms of ``xs_int``, in
    ``window_reference``'s layout."""

    def run(torch, dtype, t):
        from bunmpc_tpu_torch import workload
        from bunmpc_tpu_torch.mpc.motions.go2_cyclic import trot_sim
        from bunmpc_tpu_torch.sim import physics, rollout

        spec = workload.go2_spec("trot_sim", device="cpu")
        gains, sp, _, _ = workload.go2_sweep_options(workload.go2_sweep_grid(), device="cpu")
        case = workload.go2_window_inputs(len(q))
        idx = torch.as_tensor(case.pop("rows"))
        d = {k: torch.as_tensor(a, dtype=dtype) for k, a in case.items()}

        def rows(x):
            return tree_map(lambda a: a[idx].to(dtype), x)

        cfg = rollout.RolloutConfig(episode_length=50, kp=trot_sim.kp, kd=trot_sim.kd,
                                    gait_period=trot_sim.gait_period)
        return rollout.rollout_mpc(
            spec, rows(sp), cfg, physics.SimState(*(torch.as_tensor(a).to(dtype) for a in (q, v))),
            d["v_des"], d["w_des"], q_noise=d["q_noise"], v_noise=d["v_noise"], gains=rows(gains),
            swing_blend=0.5, force_gate=1.0, admm_backend="torch", ik_backend="torch")

    out, _, plans = plain_window(dtype_name, run)
    out["plans"] = [{"xs_int": p.xs_int[:, :50].numpy()} for p in plans]
    return out


def reference_rollout(torch, future, device):
    """A ``window_reference`` result as a rollout's end state and plans on
    ``device``: ``(namespace with final_state, [namespace per window])``."""
    from bunmpc_tpu_torch.sim import physics

    out = future.result()
    res = types.SimpleNamespace(final_state=physics.SimState(
        torch.as_tensor(out["final_q"], device=device),
        torch.as_tensor(out["final_v"], device=device)))
    plans = [types.SimpleNamespace(**{k: torch.as_tensor(a, device=device) for k, a in p.items()})
             for p in out["plans"]]
    return res, plans


WINDOW_N = 64  # episodes of phase 7a held against the plain path
SLOPE_N = 64  # episodes of phase 13b


def terrain_phase(torch, loop_spec, sim, start, cmd, slope_ref, zero_counts, counts, card):
    """Phase 13: the closed loop on uneven ground (``rollout_mpc(terrain=)``:
    the physics' ground, the plan's touchdown, swing and CoM heights; the
    heights in a device buffer read inside the substep's CUDA graph). 13a
    two windows at B=512 on a zero heightfield equal the loop without
    terrain in every record, bit for bit; 13b two windows at B=64 on a 10%
    slope against the plain path in f64 (``slope_ref``, computed on the host
    CPU; phase 7a's end-state tolerances); 13c 512 episodes x 3000 steps on
    ``workload.terrain_draw(0)`` (a random 8 m x 8 m heightfield, 2 cm
    amplitude, 3 blurs) from the flat settle, gated on K1 and K2 once a
    window, finite records and frozen failed episodes; survival, the
    survivors' median roll_max and their height above the local ground are
    printed, not gated (no earlier run says whether the expert walks on such
    ground). Returns each part's launches."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot_sim
    from bunmpc_tpu_torch.sim import physics, rollout
    from bunmpc_tpu_torch.utils.quat import quat_to_rot, rot_to_rpy

    dev = start.q.device
    fields = ("states", "actions", "vc_goals", "base", "com", "contact_forces", "contact_pos",
              "in_contact", "failed", "fail_step")
    win_cfg = rollout.RolloutConfig(episode_length=100, kp=trot_sim.kp, kd=trot_sim.kd,
                                    gait_period=trot_sim.gait_period)
    out = {}
    # 13a: a zero heightfield is flat ground
    zero = physics.Terrain(heights=torch.zeros((160, 160), device=dev), origin=(-4.0, -4.0),
                           cell=0.05)
    zero_counts()
    flat = rollout.rollout_mpc(loop_spec, sim, win_cfg, start, *cmd)
    on_zero = rollout.rollout_mpc(loop_spec, sim, win_cfg, start, *cmd, terrain=zero)
    torch.cuda.synchronize()
    out["13a"] = counts()
    equal = {f: torch.equal(getattr(flat, f), getattr(on_zero, f)) for f in fields}
    log(f"[13a] two windows at B={B} on a zero heightfield against no terrain: launches "
        f"{out['13a']}; records equal bit for bit {equal}")
    check(all(equal.values()), "13a: the zero heightfield moved the loop")
    check(out["13a"] == {"admm": 4, "ddp": 4, "fused": 0}, "13a: K1 and K2 once a window")

    # 13b: a 10% slope against the plain path in f64
    n = SLOPE_N
    slope = workload.slope_terrain(0.1)
    zero_counts()
    win = rollout.rollout_mpc(loop_spec, sim, win_cfg, physics.SimState(
        start.q[:n].contiguous(), start.v[:n].contiguous()), cmd[0][:n], cmd[1][:n],
        terrain=slope)
    torch.cuda.synchronize()
    out["13b"] = counts()
    t0 = time.perf_counter()
    ref, _ = reference_rollout(torch, slope_ref, dev)
    wait = time.perf_counter() - t0
    dq, dv = end_diff_at(win, ref)
    log(f"[13b] two windows at B={n} on a 10% slope: launches {out['13b']}; end q |d| {dq:.3e} "
        f"(< {TWO_WINDOW_Q_TOL:.1e}), v |d| {dv:.3e} (< {TWO_WINDOW_V_TOL:.1e}) against the "
        f"plain path in f64 (host CPU; waited {wait:.2f} s); failed {int(win.failed.sum())}")
    check(out["13b"] == {"admm": 2, "ddp": 2, "fused": 0}, "13b: K1 and K2 once a window")
    check(dq < TWO_WINDOW_Q_TOL and dv < TWO_WINDOW_V_TOL, "13b: the slope's end state disagrees")
    check(bool(torch.isfinite(win.states).all()), "13b: records not finite")

    # 13c: 512 x 3000 on a random heightfield
    ter = workload.terrain_draw(0)
    cfg = rollout.RolloutConfig(episode_length=3000, kp=trot_sim.kp, kd=trot_sim.kd,
                                gait_period=trot_sim.gait_period)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = rollout.rollout_mpc(loop_spec, sim, cfg, start, *cmd, terrain=ter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["13c"] = counts()
    T = cfg.episode_length
    finite, frozen = finite_and_frozen(torch, res)
    alive = ~res.failed.cpu().numpy()
    rpy = rot_to_rpy(quat_to_rot(res.states[..., 27:31])).cpu().numpy()
    roll_max = np.rad2deg(np.abs(rpy[alive, 500:, 0]).max(axis=1))
    base = res.base[:, -1000:]
    above = (base[..., 2] - ter.height_at(base[..., 0:2])).cpu().numpy()  # base over its ground
    z_dev = np.abs(above[alive].mean(axis=1) - trot_sim.nom_ht)
    survival = float(alive.mean())
    med_roll = float(np.median(roll_max)) if alive.any() else float("nan")
    med_z = float(np.median(z_dev)) if alive.any() else float("nan")
    amp = float(ter.heights.abs().max())
    log(f"[13c] {B} episodes x {T} steps on a random heightfield (|h| max {amp:.4f} m): "
        f"{wall:.2f} s, {B * T / wall:.1f} env-steps/s; launches {out['13c']}; survival "
        f"{survival:.4f}; survivors' median roll_max (500-3000 ms) {med_roll:.3f} deg, median "
        f"|mean height over the local ground (last 1000 ms) - {trot_sim.nom_ht}| {med_z:.4f} m "
        f"(printed, not gated); records of live episodes finite {finite}, failed episodes "
        f"frozen {frozen}")
    log(json.dumps({"metric": "terrain_env_steps_per_sec", "value": round(B * T / wall, 1),
                    "batch": B, "steps": T, "wall_s": round(wall, 3), "survival": survival,
                    "median_roll_max_deg": med_roll, "median_height_error_m": med_z,
                    "card": card}))
    check(out["13c"] == {"admm": T // 50, "ddp": T // 50, "fused": 0},
          f"13c: K1 and K2 once a window ({T // 50})")
    check(finite, "13c: records of live episodes not finite")
    check(frozen, "13c: failed episodes were not frozen")
    return out


ACYCLIC_PROBLEM0 = {  # tests/test_acyclic.py:33-73
    "stand": "violation < 2e-3, CoM z within 0.03 of 0.22, mean total Fz within 3 N of 2.5 g",
    "jump_fwd": "no contact in [0.4, 0.7) s, contact elsewhere, violation < 5e-3",
}


def acyclic_problem0(name, plan, dt):
    """tests/test_acyclic.py's assertions on problem 0 (stand, jump_fwd):
    (printed values, misses)."""
    v0 = float(plan.dyn_violation[0])
    if name == "stand":
        z = plan.X_opt[0, :, 2]
        fz = float(plan.F_opt[0, ..., 2].sum(-1).mean())
        dz = float((z - 0.22).abs().max())
        miss = [] if v0 < 2e-3 and dz < 0.03 and abs(fz - 2.5 * 9.81) < 3.0 else ["problem 0"]
        return {"dyn_violation": v0, "com_z_dev": dz, "fz_mean": fz}, miss
    cnt = plan.cnt_plan[0, :, :, 0].cpu().numpy()
    knot_t = np.arange(cnt.shape[0]) * dt
    flight = (knot_t >= 0.4) & (knot_t < 0.7)
    ok = cnt[flight].sum() == 0 and cnt[~flight].sum() > 0 and v0 < 5e-3
    return {"dyn_violation": v0, "flight_contacts": float(cnt[flight].sum())}, (
        [] if ok else ["problem 0"])


def acyclic_table(torch, refs, zero_counts, counts, card):
    """Phase 14: the six Solo12 acyclic motions, each a batched solve at B=512
    in f32 through K1 then K2 (``acyclic.solve_acyclic_mpc_batch``) on
    ``workload.acyclic_states`` (problem 0 the JAX tests' start at t=0; the
    others about it at times across the motion). Per motion: H and IK H,
    problems a block, K1 and K2 ms, solves/s, ADMM iterations (the slowest
    problem's and the mean), converged_frac; gates: K1 and K2 once a solve,
    finite plans where the ADMM did not diverge; against the plain path in
    f64 on 64 problems (computed on the host CPU): the converged set
    (violation < 1e-3) within 5%, the diverged set (violation above 1e3 or
    NaN) within 5% where the other side converged, the values of the
    problems that converge in f64 by phase 6's quantile gate or, where f32
    alone misses it, phase 9d's rule against the plain f32 run; problem 0 of
    stand and jump_fwd under tests/test_acyclic.py's assertions. Returns
    each motion's launches."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import acyclic as AC
    from bunmpc_tpu_torch.mpc import ik as IK
    from bunmpc_tpu_torch.mpc.motions.solo12_acyclic import MOTIONS
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    n = PARITY_N
    launches, table, failures = {}, [], []
    for name in MOTIONS:
        t_motion = time.perf_counter()
        spec = workload.acyclic_spec(name)
        model, m, H, Hik = spec.model, spec.model.total_mass, spec.horizon, spec.ik_hor
        inputs = tuple(torch.as_tensor(a, dtype=torch.float32, device=spec.device)
                       for a in workload.acyclic_states(name, B))

        def solve():
            return AC.solve_acyclic_mpc_batch(spec, *inputs)

        zero_counts()
        plan = solve()
        torch.cuda.synchronize()
        launches[name] = counts()
        reps = []
        for _ in range(3):
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            reps.append(time.perf_counter() - t0)
        div = diverged(plan)
        row = {"motion": name, "H": H, "ik_H": Hik,
               "per_block": {"k1": cuda_admm.launch_per_block(H),
                             "k2": cuda_ddp.launch_per_block(Hik)},
               "solves_per_sec": round(B / float(np.median(reps)), 1),
               "converged_frac": float((plan.dyn_violation < 1e-3).float().mean()),
               "diverged": int(div.sum()), "admm_iters": iteration_stats(plan.admm_iters),
               "finite": bool((finite_rows(torch, plan) | div).all())}
        # the kernels alone, by CUDA events, on this motion's inputs
        pr = AC._prepare(spec, *inputs)
        admm_in = (pr["plan"], m, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"], pr["X_wm"],
                   pr["F_wm"], pr["x_bounds"], cuda_admm.CudaAdmmConfig(rho=MOTIONS[name].rho,
                                                                        x_solver="thomas"))
        X = cuda_admm.solve(*admm_in)[0]
        tasks = AC._ik_tasks(spec, pr, X)
        ws, wt, cw, xr = IK.dense_weights(model, spec.eff_frames, tasks)
        ddp_in = (model, spec.eff_frames, torch.cat(inputs[:2], -1), tasks.ee_targets,
                  tasks.com_ref, tasks.mom_ref, xr, ws, wt, cw, tasks.dts)
        row["ms"] = {"k1": round(cuda_ms(torch, lambda: cuda_admm.solve(*admm_in), 3), 4),
                     "k2": round(cuda_ms(torch, lambda: cuda_ddp.solve_ik_batch(*ddp_in), 3), 4)}
        # against the plain path in f64 on n problems
        t0 = time.perf_counter()
        ref = types.SimpleNamespace(**{f: torch.as_tensor(a, device=spec.device) for f, a in
                                       refs[("acyclic", name, "float64")].result().items()})
        row["reference_wait_s"] = round(time.perf_counter() - t0, 3)
        # the converged sets, and the diverged sets where the other side
        # converged: a problem capped at the ADMM's iteration limit ends at a
        # chaotic violation, which crosses 1e3 in f32 and not in f64 or the
        # other way (cartwheel on an H100: 6 of 64, none of them converged
        # on either side)
        div_p, div_k = diverged(ref).cpu(), div[:n].cpu()
        conv_p, conv_k = (ref.dyn_violation < 1e-3).cpu(), (plan.dyn_violation[:n] < 1e-3).cpu()
        cross = int(((div_k & conv_p) | (div_p & conv_k)).sum())
        div_same = (int((conv_k ^ conv_p).sum()) <= int(0.05 * n)
                    and cross <= int(0.05 * n))
        conv = (conv_p & ~div_k).numpy()
        row["parity_diverged"] = {"plain_f64": div_p.nonzero().flatten().tolist(),
                                  "kernels": div_k.nonzero().flatten().tolist()}
        row["parity_sets"] = {"converged_mismatch": int((conv_k ^ conv_p).sum()),
                              "diverged_mismatch": int((div_k ^ div_p).sum()),
                              "diverged_where_the_other_converged": cross}
        row["parity_converged_problems"] = int(conv.sum())
        dk = {f: per_problem_max(getattr(plan, f)[:n], getattr(ref, f))[conv]
              for f in ("xs", "X_opt")}
        allk = {f: np.nan_to_num((getattr(plan, f)[:n].double() - getattr(ref, f)).abs()
                                 .cpu().numpy()[conv].flatten(), nan=np.inf) for f in dk}
        ok = all(d.size == 0 or (float(np.quantile(d, 0.999)) < 5e-3 and float(d.max()) < 5e-2)
                 for d in allk.values())
        row["parity"] = {f: {"q999": float(np.quantile(d, 0.999)) if d.size else None,
                             "max": float(d.max()) if d.size else None} for f, d in allk.items()}
        row["parity_gate"] = "f64 quantile" if ok else "plain f32"
        if not ok:
            r32 = refs[("acyclic", name, "float32")].result()
            ref32 = types.SimpleNamespace(**{f: torch.as_tensor(a, device=spec.device)
                                             for f, a in r32.items()})
            dp = {f: per_problem_max(getattr(ref32, f), getattr(ref, f))[conv] for f in dk}
            row["parity"]["plain_f32_rule"] = {
                f: {"median_kernels": float(np.median(dk[f])),
                    "median_plain_f32": float(np.median(dp[f])),
                    "far_kernels": int((dk[f] > 5e-2).sum()),
                    "far_plain_f32": int((dp[f] > 5e-2).sum())} for f in dk}
            ok = all(np.median(dk[f]) < max(5e-3, 10 * float(np.median(dp[f]))) and
                     (dk[f] > 5e-2).sum() <= (dp[f] > 5e-2).sum() + int(0.05 * n) for f in dk)
        miss = []
        if name in ACYCLIC_PROBLEM0:
            row["problem0"], miss = acyclic_problem0(name, plan, float(spec.dt_arr[0]))
        row["wall_s"] = round(time.perf_counter() - t_motion, 2)
        log(f"[14] {name}: H {H}, IK H {Hik}; problems a block K1 {row['per_block']['k1']}, K2 "
            f"{row['per_block']['k2']}; solves/s {row['solves_per_sec']}; ms {row['ms']}; ADMM "
            f"iterations {row['admm_iters']}; converged_frac {row['converged_frac']:.4f}; "
            f"diverged {row['diverged']}; launches {launches[name]}; finite where not diverged "
            f"{row['finite']}; parity ({n} problems, {row['parity_converged_problems']} converged "
            f"in f64, {row['parity_gate']}) {row['parity']}; diverged of the {n} "
            f"{row['parity_diverged']}, sets {row['parity_sets']}; problem 0 "
            f"{row.get('problem0', 'not gated')}; "
            f"{row['wall_s']} s (waiting for the plain reference {row['reference_wait_s']} s)")
        table.append(row)
        if launches[name] != {"admm": 1, "ddp": 1, "fused": 0}:
            miss.append("launches")
        if not row["finite"]:
            miss.append("finite")
        if not ok:
            miss.append("parity")
        if not div_same:
            miss.append("converged or diverged set")
        if miss:
            failures.append(f"{name}: {', '.join(miss)}")
    log(json.dumps({"metric": "acyclic", "phase": "14", "batch": B, "motions": table,
                    "card": card}))
    check(not failures, f"14: {failures}")
    return launches


def busy_share(trace_path):
    """The device's busy share of a ``torch.profiler`` Chrome trace (the
    union of its kernel, memcpy and memset intervals over the traced window,
    the span of every event, host and device), and each kernel's total
    milliseconds and calls."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, -float("inf")
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            ms, n = kernels.get(e["name"], (0.0, 0))
            kernels[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return busy / max(t1 - t0, 1e-9), (t1 - t0) / 1e3, kernels


def experiment_drivers(torch, spec, inputs, admm_cfg, ddp_cfg, zero_counts, counts, card):
    """Phase 15: the five CLI drivers' ``main(argv)`` in-process on the card, in
    a temporary directory, on their configs (the JAX scripts' defaults:
    Solo12 ``trot``, the default simulator, the unsettled q0). 15a
    ``run_data_collection`` one iteration of 1000 steps (cut from 20 x 3000);
    15b ``run_bc`` on 15a's ``.npz`` at bc.yaml's widths for 2 of 150 epochs,
    on vc goals (15c's grid runs them); 15c ``run_eval`` ``mpc_grid`` (4 vx,
    600 steps) and ``policy_grid`` of 15b's checkpoint; 15d ``run_dagger
    mode=safedagger`` (safedagger.yaml's 8 rollouts an iteration; 1 of 10
    iterations, 300 of 5000 steps, 2 of 150 and 50 epochs) with a
    checkpoint, then ``n_iterations=2 resume=true``; 15e ``torch.profiler``
    around one main-path solve at B=512 (``utils/profiling.device_trace``)
    and ``SolveTimer`` over its five stages. Returns each call's launch
    counts."""
    import tempfile

    from bunmpc_tpu_torch.eval import velocity_grid
    from bunmpc_tpu_torch.learning import dagger as D
    from bunmpc_tpu_torch.learning import database as DBM
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.scripts import run_bc, run_dagger, run_data_collection, run_eval
    from bunmpc_tpu_torch.utils import checkpoint as CK
    from bunmpc_tpu_torch.utils import profiling as PROF

    fields = ("states", "actions", "vc_goals", "cc_goals")
    launches, fails = {}, []

    def call(tag, main, argv, *spies):
        """``main(argv)`` with the ``Spy``s on; its wall seconds."""
        for sp in spies:
            sp.__enter__()
        try:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for sp in spies:
                sp.__exit__()
        launches[tag] = counts()
        log(f"[{tag}] {main.__module__.split('.')[-1]} {' '.join(argv)}: rc {rc}, "
            f"{wall:.2f} s, launches {launches[tag]}")
        if rc != 0:
            fails.append(f"{tag} rc {rc}")
        return wall

    def gate(ok, msg):
        if not ok:
            fails.append(msg)

    def bit_equal(a, b, s, g):
        with torch.no_grad():
            return bool(torch.equal(a(s, g), b(s, g)))

    def drivers_in(tmp):
        summary = {}

        # ---- 15a. run_data_collection: one iteration of 1000 steps ----
        saves = Spy(torch, DBM.Database, ["save"], counts)
        nw = 1000 // 50
        wall = call("15a", run_data_collection.main,
                    ["n_iteration=1", "episode_length=1000", f"data_save_path={tmp}/data"], saves)
        saved = [(c["args"][1], {f: getattr(c["args"][0], f) for f in fields}) for c in saves.calls]
        path, arrays = saved[-1] if saved else (None, {})
        db = DBM.Database(10_000_000, goal_type="cc")
        if path:
            db.load_saved_database(path)
        same = bool(path) and all(
            (getattr(db, f) is None and arrays[f] is None) or
            np.array_equal(getattr(db, f), arrays[f]) for f in fields)
        finite = bool(path) and all(np.isfinite(a).all() for a in arrays.values() if a is not None)
        log(f"[15a] snapshot {os.path.basename(path) if path else None}: {len(db)} rows; reloaded "
            f"arrays equal {same}, finite {finite}; K1 and K2 {2 * nw} each expected (8a's "
            f"accounting: the benchmark and the perturbed batch, {nw} windows each)")
        summary["15a"] = dict(wall_s=round(wall, 3), rows=len(db), launches=launches["15a"])
        gate(len(saved) == 1 and path.endswith(".npz"), "15a: one .npz snapshot")
        gate(same and finite and len(db) > 0, "15a: the reloaded snapshot differs, is not finite "
                                              "or is empty")
        gate(launches["15a"] == {"admm": 2 * nw, "ddp": 2 * nw, "fused": 0}, "15a: launches")

        # ---- 15b. run_bc at bc.yaml's widths, 2 epochs ----
        pol_dir = f"{tmp}/bc/policy"
        policies = Spy(torch, CK, ["save_policy"], counts)
        wall = call("15b", run_bc.main, [f"database={path}", "n_epoch=2", "goal_type=vc",
                                         f"save_path={pol_dir}"], policies)
        with open(f"{tmp}/bc/metrics.jsonl") as fh:
            epochs = [json.loads(line) for line in fh]
        with np.load(f"{pol_dir}/payload.npz") as z:
            keys = sorted(z.files)
        with open(f"{pol_dir}/meta.json") as fh:
            meta = json.load(fh)
        want_keys = sorted(["state_mean", "state_std", "goal_mean", "goal_std"] + [
            f"param::['Dense_{i}']/['{p}']" for i in range(4) for p in ("bias", "kernel")])
        dev = inputs[0].device
        loaded = CK.load_policy(pol_dir, device=dev)
        rows = torch.as_tensor(db.states[:1024], device=dev)
        goals = torch.as_tensor(db.vc_goals[:1024], device=dev)
        equal_b = bit_equal(policies.calls[-1]["args"][0], loaded, rows, goals)
        losses = [(e["Training Loss"], e["Validation Loss"]) for e in epochs]
        log(f"[15b] losses (train, valid) {losses}; files {sorted(os.listdir(pol_dir))}, meta "
            f"{meta}, payload keys {keys}; the reloaded policy's actions on {len(rows)} database "
            f"rows bit-equal to the trained one's {equal_b}")
        summary["15b"] = dict(wall_s=round(wall, 3), epochs=len(epochs),
                              train_losses=[e["Training Loss"] for e in epochs])
        gate(sorted(os.listdir(pol_dir)) == ["meta.json", "payload.npz"] and keys == want_keys and
             meta == {"output_size": 12, "num_hidden_layer": 3, "hidden_dim": 512,
                      "batch_norm": False}, "15b: the checkpoint's layout")
        gate(equal_b and len(rows) == 1024, "15b: the reloaded policy's actions differ")
        gate(all(np.isfinite(e["Training Loss"]) for e in epochs) and len(epochs) == 2,
             "15b: losses")
        gate(launches["15b"] == {"admm": 0, "ddp": 0, "fused": 0}, "15b: launched a kernel")

        # ---- 15c. run_eval: the MPC grid and 15b's policy grid ----
        grids = Spy(torch, velocity_grid, ["eval_mpc_grid", "eval_policy_grid"], counts)
        wall_m = call("15c_mpc_grid", run_eval.main,
                      ["mode=mpc_grid", "vx=0:0.3:4", "episode_length=600", f"out={tmp}/mpc.csv"],
                      grids)
        wall_p = call("15c_policy_grid", run_eval.main,
                      ["mode=policy_grid", f"policy={pol_dir}", "vx=0:0.3:4", "episode_length=600",
                       f"out={tmp}/policy.csv"], grids)
        sums = [c["res"].summary() for c in grids.calls]
        log(f"[15c] summaries: MPC grid {sums[0]}; policy grid {sums[1]}")
        summary["15c"] = dict(wall_s=[round(wall_m, 3), round(wall_p, 3)], summaries=sums)
        nw = 600 // 50
        gate(launches["15c_mpc_grid"] == {"admm": nw, "ddp": nw, "fused": 0},
             "15c: the MPC grid must launch K1 and K2 once per window")
        gate(launches["15c_policy_grid"] == {"admm": 0, "ddp": 0, "fused": 0},
             "15c: the policy grid launched a kernel")
        gate(np.isfinite(sums[0]["survival_rate"]) and (
            sums[0]["survival_rate"] == 0 or np.isfinite(sums[0]["vx_mse_mean"])),
            "15c: the MPC grid's summary is not finite")

        # ---- 15d. run_dagger mode=safedagger with a checkpoint, then resume ----
        args = ["mode=safedagger", "episode_length=300", "warmup_bc_epochs=2", "bc_epochs=2",
                f"checkpoint_dir={tmp}/sd/checkpoint", f"save_path={tmp}/sd"]
        calls = []
        for tag, extra in (("15d_first", ["n_iterations=1"]),
                           ("15d_resume", ["n_iterations=2", "resume=true"])):
            drivers = Spy(torch, D._IterativeDriver, ["warmup", "iteration", "run"], counts)
            walls = call(tag, run_dagger.main, args + extra, drivers, policies)
            calls.append((walls, drivers.calls))
        (wall_1, first), (wall_2, second) = calls
        kinds = [[c["name"] for c in ev] for ev in (first, second)]
        logs1, logs2 = ([c["res"] for c in ev if c["name"] == "run"][0] for ev in (first, second))
        it1 = [c["launches"] for c in first if c["name"] == "iteration"]
        with open(f"{tmp}/sd/checkpoint/state.json") as fh:
            state = json.load(fh)
        final = CK.load_policy(f"{tmp}/sd/policy", device=dev)
        equal_d = bit_equal(policies.calls[-1]["args"][0], final, rows, goals)
        log(f"[15d] first call {kinds[0]}, per call launches: warmup "
            f"{[c['launches'] for c in first if c['name'] == 'warmup']}, iteration {it1}; the "
            f"resumed call {kinds[1]}, launches {launches['15d_resume']}; logs "
            f"{json.dumps(logs2, default=float)}; "
            f"the iteration-0 entry restored {logs2[:1] == logs1}; state.json next_iteration "
            f"{state['next_iteration']}; the final policy reloaded bit-equal {equal_d}")
        summary["15d"] = dict(wall_s=[round(wall_1, 3), round(wall_2, 3)],
                              launches=[launches["15d_first"], launches["15d_resume"]],
                              logs=logs2)
        gate(kinds[0] == ["warmup", "iteration", "run"] and kinds[1] == ["iteration", "run"],
             "15d: the first call must warm up and iterate once, the resumed one iterate once")
        gate(len(logs1) == 1 and len(logs2) == 2 and logs2[0] == logs1[0],
             "15d: the resumed call's iteration-0 entry is not the restored one")
        gate(launches["15d_resume"] == it1[0] and it1[0]["admm"] > 0 and it1[0]["fused"] == 0,
             "15d: the resumed call's launches are not one iteration's")
        gate(state["next_iteration"] == 2 and equal_d, "15d: the checkpoint or the final policy")

        # ---- 15e. a device trace of one main-path solve, and its stages ----
        def solve():
            return KD.solve_mpc_batch(spec, *inputs, admm_cfg=admm_cfg, ddp_cfg=ddp_cfg,
                                      admm_backend="cuda", ik_backend="cuda")

        solve()
        torch.cuda.synchronize()
        zero_counts()
        with PROF.device_trace(f"{tmp}/trace") as prof:
            plan = solve()
        launches["15e"] = counts()
        share, window_ms, kernels = busy_share(f"{tmp}/trace/trace.json")
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        names = " ".join(kernels)
        timer = PROF.SolveTimer()
        for _ in range(3):
            main_path_stages(spec, inputs, admm_cfg, timer.phase)
        stages = {k: {f: round(v, 6) for f, v in s_.items()} for k, s_ in timer.summary().items()}
        log(f"[15e] trace of one main-path solve at B={B}: window {window_ms:.3f} ms, device busy "
            f"{100 * share:.2f}%, {sum(n for _, n in kernels.values())} kernel launches of "
            f"{len(kernels)} kernels; launches counted {launches['15e']}; top 10 by device time "
            "(ms, calls): " + "; ".join(f"{k[:60]} {ms:.4f} {n}" for k, (ms, n) in top))
        log("[15e] SolveTimer (s, 3 solves):\n" + timer.report())
        summary["15e"] = dict(busy_share=share, window_ms=window_ms, stages_s=stages,
                              top_kernels=[[k, ms, n] for k, (ms, n) in top],
                              profiler_rows=len(prof.key_averages()))
        gate(bool(torch.isfinite(plan.xs).all()), "15e: the traced solve is not finite")
        gate(launches["15e"] == {"admm": 1, "ddp": 1, "fused": 0}, "15e: launches")
        gate("admm_kernel" in names and "ddp_kernel" in names,
             "15e: K1's or K2's __global__ name is not in the trace (CUPTI did not see a launch of "
             "a ctypes-loaded library)")

        log(json.dumps({"metric": "experiment_drivers", **summary, "card": card}, default=float))
        check(not fails, f"phase-15 gates missed: {fails}")
        return launches

    tmp = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    try:
        return drivers_in(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 16: every rollout of the three demos cut to 300 steps; the analysis
# scripts' episodes: past the 500 ms the JAX scripts' attitude windows skip
# (550: 11 windows), 500 for one half-second line of diagnose_gait, 300 for
# sweep_contact (its metrics are over the second half)
DEMO_STEPS = 300
SCRIPT_STEPS = {"diagnose_gait": 500, "sweep_contact": 300, "calibrate_contact": 550,
                "validate_wf_norm": 550, "sweep_stability": 550}


def analysis_scripts(torch, zero_counts, counts, card):
    """Phase 16: the ten analysis and demo scripts (``bunmpc_tpu_torch/
    scripts``) through ``main(argv)`` in-process on the card, cut small, in a
    temporary directory. Per script: its wall seconds, K1/K2 launches and key
    outputs printed before its gates; the launches its loop implies (one K1
    and one K2 a window of every MPC or gated rollout, or a solve); finite
    outputs; its output file read back by a strict JSON parse, with the JAX
    script's keys. 16a ``solve_times_sweep`` at B=64 (4 horizons x an untimed
    and a timed call); 16b ``diagnose_admm`` at B=16 (the plain solver, no
    launch; its ADMM and FISTA iterations within their caps); 16c
    ``diagnose_gait`` Solo12 and Go2, 16d ``sweep_contact``, 16e
    ``calibrate_contact``, 16f ``validate_wf_norm`` and 16g ``sweep_stability``
    (the Go2's default grid, 40 rows in one call) at SCRIPT_STEPS; 16h-16j the three
    demos at 1 iteration of 2 commands with every rollout (warmup, gated,
    ending, eval) at 300 steps, 2 BC epochs and 2 warmup commands, their
    checkpoints in the temporary directory. Returns each call's launches."""
    import io
    import tempfile

    from bunmpc_tpu_torch.eval import velocity_grid
    from bunmpc_tpu_torch.learning.bc import BcConfig
    from bunmpc_tpu_torch.scripts import (_common, calibrate_contact, diagnose_admm,
                                          diagnose_gait, run_learning_demo, run_locodemo,
                                          run_locosafedagger_demo, solve_times_sweep,
                                          sweep_contact, sweep_stability, validate_wf_norm)
    from bunmpc_tpu_torch.sim import rollout

    launches, fails = {}, []

    def steps(name):
        return SCRIPT_STEPS[name], SCRIPT_STEPS[name] // 50

    def gate(ok, msg):
        if not ok:
            fails.append(msg)
        return ok

    def call(tag, mod, argv, *spies):
        """``mod.main(argv)`` with the ``Spy``s on and its standard output
        captured: ``(rc, wall seconds, printed lines)``."""
        for sp in spies:
            sp.__enter__()
        buf = io.StringIO()
        try:
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for sp in spies:
                sp.__exit__()
        launches[tag] = counts()
        SECONDS[f"16/{tag}"] = wall
        log(f"[{tag}] {mod.__name__.split('.')[-1]} {' '.join(argv)}: rc {rc}, {wall:.2f} s, "
            f"launches {launches[tag]}")
        gate(rc == 0, f"{tag}: rc {rc}")
        return wall, buf.getvalue().splitlines()

    def want(tag, n):
        return gate(launches[tag] == {"admm": n, "ddp": n, "fused": 0} and n >= 0,
                    f"{tag}: K1 and K2 must launch {n} times each")

    def strict(path):
        with open(path) as fh:
            text = fh.read()
        lines = [json.loads(ln, parse_constant=lambda c: fails.append(f"{path}: {c}"))
                 for ln in text.splitlines() if ln.strip()] if path.endswith(".jsonl") else \
            json.loads(text, parse_constant=lambda c: fails.append(f"{path}: {c}"))
        return lines

    def windows(spy):
        """Windows of the MPC and gated rollouts a spy recorded (one K1 and one
        K2 each)."""
        return sum(c["args"][2].episode_length // c["args"][2].steps_per_plan for c in spy.calls
                   if c["name"] != "rollout_policy")

    def finite_lines(tag, lines):
        text = " ".join(lines)
        return gate("nan" not in text and "inf" not in text,
                    f"{tag}: a printed value is not finite")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_scripts_") as tmp:
        # ---- 16a. solve_times_sweep at its default B=64 ----
        _, lines = call("16a", solve_times_sweep, ["gait=trot", "batch=64", f"out={tmp}/st.json"])
        for ln in lines:
            log(f"  {ln}")
        doc = strict(f"{tmp}/st.json")
        want("16a", 8)
        gate(list(doc) == ["10", "15", "20", "25"] and all(
            set(r) == {"sec_per_batch", "solves_per_sec", "mean_admm_iters", "mean_viol"} and
            all(np.isfinite(v) for v in r.values()) for r in doc.values()), "16a: the table")
        gate(all(r["mean_viol"] < 1e-3 for r in doc.values()), "16a: a horizon did not converge")

        # ---- 16b. diagnose_admm at B=16: the plain solver on CUDA tensors ----
        diag = Spy(torch, diagnose_admm, ["diagnose"], counts)
        _, lines = call("16b", diagnose_admm, ["batch=16"], diag)
        for ln in lines:
            log(f"  {ln}")
        d = diag.calls[0]["res"] if diag.calls else None
        want("16b", 0)
        gate(d is not None and all(
            d[f"precondition={p}"]["admm_iters"].max() <= d[f"precondition={p}"]["max_admm_iters"]
            for p in (False, True)) and d["f_sub"]["iters"].max() <= d["fista_max_iters"] and
            d["x_sub"]["iters"].max() <= d["fista_max_iters"], "16b: iterations past their caps")
        finite_lines("16b", lines)

        # ---- 16c. diagnose_gait, Solo12 and the Go2 ----
        T, nw = steps("diagnose_gait")
        for robot in ("solo12", "go2"):
            tag = f"16c {robot}"
            _, lines = call(tag, diagnose_gait, [robot, "0.3", str(T), f"{tmp}/diag_{robot}"])
            for ln in lines:
                log(f"  {ln}")
            want(tag, nw)
            gate(any(ln.startswith("robot=") for ln in lines) and
                 sum("touchdown offset" in ln for ln in lines) == 4, f"{tag}: the report")
            finite_lines(tag, lines)

        # ---- 16d. sweep_contact: 8 combinations, one solve a window ----
        T, nw = steps("sweep_contact")
        _, lines = call("16d", sweep_contact, ["solo12", "0.3", str(T)])
        for ln in lines:
            log(f"  {ln}")
        want("16d", nw)
        gate(len(lines) == 2 + len(sweep_contact.COMBOS["solo12"]) + 1, "16d: the table")
        finite_lines("16d", lines)

        # ---- 16e. calibrate_contact: the 36-row grid and the trot_sim baseline ----
        T, nw = steps("calibrate_contact")
        call("16e", calibrate_contact, [f"{tmp}/cal.json", str(T)])
        doc = strict(f"{tmp}/cal.json")
        b = doc["best"]
        log(f"  best row kn {b['kn']:g} dn {b['dn']:g} kt {b['kt']:g}: failed {b['failed']}, "
            f"duty {b['duty_factor']:.3f}, roll max {b['roll_max_deg']:.2f} deg; baseline "
            f"failed {doc['trot_sim_baseline']['failed']}, duty "
            f"{doc['trot_sim_baseline']['duty_factor']:.3f}; device {doc['meta']['device']}")
        want("16e", 2 * nw)
        gate(set(doc) == {"meta", "best", "grid_rows", "trot_sim_baseline"} and
             len(doc["grid_rows"]) == 36 and doc["meta"]["device"] == card,
             "16e: the document's keys")
        gate(all(np.isfinite(r["duty_factor"]) and np.isfinite(r["roll_max_deg"])
                 for r in doc["grid_rows"]), "16e: a row is not finite")

        # ---- 16f. validate_wf_norm: four cases ----
        T, nw = steps("validate_wf_norm")
        call("16f", validate_wf_norm, [f"{tmp}/wf.json", str(T)])
        doc = strict(f"{tmp}/wf.json")
        for r in doc["results"]:
            log(f"  {r['case']}: failed {r['failed']}, survival {r['survival_ms']} ms, roll max "
                f"{r['roll_max_deg']:.2f} deg, |z - nom| {r['z_dev_end_mm']:.2f} mm, vx_end "
                f"{r['vx_end']:.3f}")
        want("16f", 4 * nw)
        gate(set(doc) == {"meta", "results"} and len(doc["results"]) == 4 and
             doc["meta"]["device"] == card, "16f: the document's keys")
        gate(all(np.isfinite(r["roll_max_deg"]) for r in doc["results"]), "16f: not finite")

        # ---- 16g. sweep_stability: the Go2's 40-row default grid, one call ----
        T, nw = steps("sweep_stability")
        _, lines = call("16g", sweep_stability, ["go2", "0.3", str(T), "500", "default",
                                                 f"{tmp}/ss.json"])
        doc = strict(f"{tmp}/ss.json")
        log(f"  {len(doc['rows'])} rows, {sum(not r['failed'] for r in doc['rows'])} survived "
            f"{T} ms; row 31 (11c's settings) roll max {doc['rows'][31]['roll_max_deg']:.2f} deg, "
            f"z_end {doc['rows'][31]['z_end_m']:.3f} m")
        want("16g", nw)
        with open(SWEEP_ARTIFACT) as fh:
            art = json.load(fh)
        gate(set(doc) == set(art) and set(doc["rows"][0]) == set(art["rows"][0]) and
             len(doc["rows"]) == 40, "16g: the document's keys")
        gate(all(np.isfinite(r["roll_max_deg"]) for r in doc["rows"]), "16g: not finite")

        # ---- 16h-16j. the three demos, cut ----
        def cut(make):
            def f(*a):
                return dataclasses.replace(
                    make(*a), episode_length=DEMO_STEPS, rollouts_warmup=2,
                    episode_length_warmup=DEMO_STEPS, ending_mpc_rollout_ms=DEMO_STEPS,
                    warmup_bc_epochs=2, bc=BcConfig(n_epoch=2))
            return f

        eval_grid, ckpt = velocity_grid.eval_policy_grid, _common.checkpoint_dir

        def short_eval(spec, sim_params, cfg, *a, **k):
            return eval_grid(spec, sim_params, dataclasses.replace(cfg, episode_length=DEMO_STEPS),
                             *a, **k)

        demos = (("16h", run_learning_demo, ["1", "2", str(DEMO_STEPS)]),
                 ("16i", run_locodemo, ["1", "2"]),
                 ("16j", run_locosafedagger_demo, ["1", "2", str(DEMO_STEPS)]))
        velocity_grid.eval_policy_grid = short_eval
        _common.checkpoint_dir = lambda out: os.path.join(tmp, os.path.basename(ckpt(out)))
        try:
            for tag, mod, args in demos:
                make = mod.make_cfg
                mod.make_cfg = cut(make)
                roll = Spy(torch, rollout, ["rollout_mpc", "rollout_safedagger",
                                            "rollout_policy"], counts)
                try:
                    out = f"{tmp}/torch_{mod.__name__.split('.')[-1]}.jsonl"
                    _, lines = call(tag, mod, [out] + args, roll)
                finally:
                    mod.make_cfg = make
                entries = strict(out)
                meta, last = entries[0]["meta"], entries[-1]
                stages = [e for e in entries[1:] if "iteration" in e]
                log(f"  {len(stages)} stages; rollout calls {[c['name'] for c in roll.calls]}; "
                    f"last line {json.dumps(last)[:300]}")
                want(tag, windows(roll))
                gate(meta["device"] == card and meta["n_iterations"] == 1 and
                     [s["iteration"] for s in stages][-1] == 0, f"{tag}: the meta line and stages")
                gate(all(np.isfinite(s["train_loss"]) for s in stages if "train_loss" in s),
                     f"{tag}: a loss is not finite")
                if tag == "16h":
                    gate(set(last) == {"best_iteration", "survival_rate", "mean_survival_ms",
                                       "tracking_score"}, "16h: the summary line")
                if tag == "16i":
                    gate(last["final_posterior_entropy"] < meta["prior_entropy"],
                         "16i: the posterior did not concentrate")
            gate(os.path.isdir(os.path.join(tmp, ".ckpt_torch_run_learning_demo")) and
                 os.path.isdir(os.path.join(tmp, ".ckpt_torch_run_locodemo")),
                 "16h/16i: no checkpoint in the temporary directory")
        finally:
            velocity_grid.eval_policy_grid, _common.checkpoint_dir = eval_grid, ckpt
    log(json.dumps({"metric": "analysis_scripts", "launches": launches,
                    "wall_s": {k[3:]: round(v, 2) for k, v in SECONDS.items()
                               if k.startswith("16/")}, "card": card}))
    check(not fails, "phase 16: " + "; ".join(fails))
    return launches


def main_path_stages(spec, inputs, admm_cfg, stage):
    """One ``solve_mpc_batch(admm_backend="cuda", ik_backend="cuda")`` on these
    inputs, stage by stage, each inside ``with stage(name, out):``, where the
    stage appends its outputs to the list ``out``; returns the plan."""
    from bunmpc_tpu_torch.mpc import ik as IK
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp

    model, m = spec.model, spec.model.total_mass
    out = []
    with stage("prep", out):
        out.append(KD._prepare_problem(spec, *inputs))
    pr = out.pop()
    with stage("k1_admm", out):
        out.append(cuda_admm.solve(pr["plan"], m, pr["x_init"], pr["W"], pr["X_ref"], pr["W_F"],
                                   pr["X_wm"], pr["F_wm"], pr["x_bounds"], admm_cfg))
    X, F, viol, iters, P = out.pop()
    with stage("ik_build", out):
        tk, x0s = KD._build_ik_tasks(spec, pr, X)
        out.append(IK.dense_weights(model, spec.eff_frames, tk))
    ws, wt, cw, xr = out.pop()
    with stage("k2_ddp", out):
        out.append(cuda_ddp.solve_ik_batch(model, spec.eff_frames, x0s, tk.ee_targets,
                                           tk.com_ref, tk.mom_ref, xr, ws, wt, cw, tk.dts))
    ixs, ius, icost = out.pop()
    with stage("interp", out):
        out.append(KD._finish_from_ik(spec, pr, X, F, viol, iters, ixs, ius, icost, P))
    return out.pop()


def main_path_stage_ms(torch, spec, inputs, admm_cfg):
    """Milliseconds of each stage of the main path on these inputs, by CUDA
    events around the stages."""
    events = []

    @contextlib.contextmanager
    def stage(name, out):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        yield
        ev[1].record()
        events.append((name, ev))

    main_path_stages(spec, inputs, admm_cfg, stage)
    torch.cuda.synchronize()
    return {name: round(e0.elapsed_time(e1), 3) for name, (e0, e1) in events}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA card is required",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import bunmpc_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the repository (bunmpc_tpu_torch not found)",
              file=sys.stderr)
        return 1
    from bunmpc_tpu_torch import _build
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused

    t_start = time.time()

    # ---- 1. device ----
    card = card_info()
    log(f"[1] device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build (every kernel, nvcc in parallel) ----
    t0 = time.time()
    reports = _build.build_kernels(
        [cuda_admm.KERNEL, *cuda_ddp.KERNELS.values(), cuda_fused.KERNEL], force=True)
    build_s = SECONDS["2 build"] = time.time() - t0
    log(f"[2] build: {build_s:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                log(f"  {name}: {line.strip()}")
    # the plain references of phases 3-6, 7a, 9d, 10a, 11a, 12, 13b and 14, on the
    # host CPU while the card works
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    try:
        return run_phases(torch, card, t_start, pool)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def run_phases(torch, card, t_start, pool):
    """Phases 3-15 and the kernels line (``main`` checked the card, built the
    kernels and started the reference workers)."""
    from bunmpc_tpu_torch import workload
    from bunmpc_tpu_torch.mpc import ik as IK
    from bunmpc_tpu_torch.mpc import kino_dyn as KD
    from bunmpc_tpu_torch.mpc.motions.solo12_cyclic import trot, trot_sim
    from bunmpc_tpu_torch.robots.solo12 import Solo12Config
    from bunmpc_tpu_torch.sim import physics, rollout
    from bunmpc_tpu_torch.solvers import cuda_admm, cuda_ddp, cuda_fused
    from bunmpc_tpu_torch.solvers.ddp import DdpConfig
    from bunmpc_tpu_torch.utils.quat import quat_to_rot, rot_to_rpy

    dev = torch.device("cuda")
    model = Solo12Config.load_model()
    # the closed loop's start first: phases 7a's and 13b's plain references go to
    # the host CPU's workers ahead of the gaits' (10a, 11a, 12, 14)
    loop_spec = KD.make_cyclic_spec(model, trot_sim, Solo12Config.q0(), device="cuda")
    sim = workload.closed_loop_sim_params()
    t0 = time.time()
    start = workload.settled_start(B)
    v_np, w_np = workload.command_draw(B, seed=0)
    cmd = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (v_np, w_np))
    torch.cuda.synchronize()
    SECONDS["settle"] = time.time() - t0
    log(f"[7a] settled start (500 ms PD hold): {time.time() - t0:.1f} s, base z "
        f"{float(start.q[0, 2]):.4f} m")
    head = [a[:WINDOW_N].cpu().numpy() for a in (start.q, start.v, *cmd)]
    window_refs = {dt: pool.submit(window_reference, *head, dt) for dt in ("float64", "float32")}
    head = [a[:SLOPE_N] for a in head]
    slope_ref = pool.submit(window_reference, *head, "float64", 0.1)
    refs = submit_references(pool)
    spec = KD.make_cyclic_spec(model, trot, Solo12Config.q0(), device="cuda")
    # the launch shape: a warp and a shared-memory slice per problem
    admm_shape = (cuda_admm.launch_per_block(spec.horizon), 4 * cuda_admm.shared_size(spec.horizon))
    ddp_shape = (cuda_ddp.launch_per_block(spec.ik_hor),
                 4 * cuda_ddp.shared_size(spec.ik_hor, model.nq, model.nv))
    for name, (pb, per_problem) in (("admm", admm_shape), ("fused", admm_shape),
                                    ("ddp", ddp_shape)):
        log(f"  {name}: {pb} problems ({pb * 32} threads) per block, {pb * per_problem} bytes "
            f"of shared memory per block ({per_problem} per problem)")
    inputs = tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                   for a in workload.trot_states(B))
    prob = KD._prepare_problem(spec, *inputs)
    m = model.total_mass
    plan = prob["plan"]
    admm_in = (plan, m, prob["x_init"], prob["W"], prob["X_ref"], prob["W_F"], prob["X_wm"],
               prob["F_wm"], prob["x_bounds"])
    bench_cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, x_solver="thomas", fista_max_iters=30)

    # ---- 3. K1 against its plain version ----
    # the plain references of phases 3-6 run on the host CPU's workers from
    # the card's inputs (copied to the host first); the card's side runs
    # here and ``finish_3_6`` holds it to them once the card's phases are done
    t36 = time.time()
    refs36 = {}
    admm_host = to_host(admm_in)
    pinned = cuda_admm.CudaAdmmConfig(rho=trot.rho, x_solver="thomas", max_admm_iters=15,
                                      dual_relax=1.0, rho_growth=1.0)
    card36 = {"3 pinned": cuda_admm.solve(*admm_in, pinned)}
    refs36["3 pinned"] = pool.submit(plain_job, "admm", admm_host, pinned, "float32")
    Xk, Fk, vk, itk, Pk = card36["3 bench"] = cuda_admm.solve(*admm_in, bench_cfg)
    refs36["3 bench"] = pool.submit(plain_job, "admm", admm_host, bench_cfg, "float32")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(Xk).all() and torch.isfinite(Fk).all()), "K1 output not finite")

    # ---- 3b. K1's other branches against the plain version run in f64 ----
    # 64 problems, 15 pinned iterations (reference schedule); the gates are
    # the JAX package's fista gates (tests/test_pallas_admm.py:69-72: X 5e-3,
    # F 2e-1, viol rel 1e-3), except viol rel 5e-3 for fista+precondition:
    # there the capped, preconditioned X-FISTA amplifies f32 rounding into
    # jumps on single problems, so an f32 run may land ~2.5e-3 from f64 on
    # these inputs whatever its code: the g++ build of the same kernel math
    # does (the card's build, which contracts into fused multiply-adds, lands
    # far closer), and so does the plain version at fista_max_iters 149
    sub = rows(admm_in, 64)
    sub_host = to_host(sub)
    branches = (("fista", dict(x_solver="fista"), 1e-3),
                ("thomas+precondition", dict(precondition=True), 1e-3),
                ("fista+precondition", dict(x_solver="fista", precondition=True), 5e-3))
    for name, kw, viol_tol in branches:
        cfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, max_admm_iters=15, dual_relax=1.0,
                                       rho_growth=1.0, **kw)
        card36[f"3b {name}"] = cuda_admm.solve(*sub, cfg)
        for dt in ("float64", "float32"):
            refs36[f"3b {name} {dt}"] = pool.submit(plain_job, "admm", sub_host, cfg, dt)

    # ---- 3c. K1 with a carried dual, against the plain version in f64 ----
    # the bench solve's (X, F, P) as the warm start of the same 64 problems,
    # with the accelerated schedule (rho escalates and backs off, rescaling
    # the dual) on both precondition branches: the dual is read and given
    # back at the base rho, as the plain version reads P_wm and returns P
    warm = sub[:6] + (Xk[:64].contiguous(), Fk[:64].contiguous(), sub[8])
    P0 = Pk[:64].contiguous()
    for prec in (False, True):
        cfg = dataclasses.replace(bench_cfg, precondition=prec)
        card36[f"3c {prec}"] = (cuda_admm.solve(*warm, cfg, P_wm=P0), cuda_admm.solve(*warm, cfg))
        refs36[f"3c {prec}"] = pool.submit(plain_job, "admm", to_host(warm), cfg, "float64",
                                           {"P_wm": to_host(P0)})

    # ---- 4. K2 against its plain version ----
    # (a) one iteration, one alpha, on the random IK problems of the JAX
    # package's own kernel check (tests/test_pallas_ddp.py), at the main
    # path's shapes. The plain version runs in f64 on the same inputs: in f32
    # its own rounding (batched LAPACK Cholesky, forward-mode Jacobians) is
    # ~2e-4 on xs over 512 problems, about 100x the kernel's
    one = cuda_ddp.CudaDdpConfig(n_iters=1, alphas=(1.0,))
    rnd_in = workload.random_ik_problems(model, spec.eff_frames, B, spec.ik_hor, dev)
    card36["4 one"] = cuda_ddp.solve_ik_batch(*rnd_in, cfg=one)
    refs36["4 one"] = pool.submit(plain_job, "ddp", to_host(rnd_in), one, "float64")
    # (b) the full config on the main path's own IK problems (built from K1's
    # output); their weights span 1e-5..1e4, so f32 rounding moves both f32
    # solvers by up to ~1e-2 from the exact solution: the plain version runs
    # in f64 on the same inputs and the kernel (f32) is held to the quantile
    # gates
    tasks, x0 = KD._build_ik_tasks(spec, prob, Xk)
    w_stage, w_term, ctrl_w, x_reg = IK.dense_weights(model, spec.eff_frames, tasks)
    ddp_in = (model, spec.eff_frames, x0, tasks.ee_targets, tasks.com_ref, tasks.mom_ref, x_reg,
              w_stage, w_term, ctrl_w, tasks.dts)
    full = cuda_ddp.CudaDdpConfig()
    card36["4 full"] = cuda_ddp.solve_ik_batch(*ddp_in, cfg=full)
    refs36["4 full"] = pool.submit(plain_job, "ddp", to_host(ddp_in), full, "float64")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(card36["4 full"][0]).all()), "K2 output not finite")

    # ---- 5. K1 against the committed native fixture (reference schedule) ----
    fx = np.load(os.path.join(REPO, "tests", "fixtures", "solo12_trot_e2e.npz"))
    f32 = torch.float32

    def one_row(a):
        return torch.as_tensor(np.asarray(a, np.float64)[None], dtype=f32, device=dev)

    fprob = KD._prepare_problem(
        spec, one_row(fx["q"]), one_row(fx["v"]), one_row(float(fx["t"])),
        one_row(fx["v_des"]), one_row(float(fx["w_des"])),
    )
    fcfg = cuda_admm.CudaAdmmConfig(rho=trot.rho, x_solver="thomas", exit_tol=1e-5,
                                    max_admm_iters=500, dual_relax=1.0, rho_growth=1.0)
    Xf, Ff, vf, itf, _ = cuda_admm.solve(
        fprob["plan"], m, fprob["x_init"], fprob["W"], fprob["X_ref"], fprob["W_F"],
        fprob["X_wm"], fprob["F_wm"], fprob["x_bounds"], fcfg,
    )
    torch.cuda.synchronize()
    fdX = float(np.abs(Xf[0].double().cpu().numpy() - fx["X_opt"]).max())
    fdF = float(np.abs(Ff[0].double().cpu().numpy() - fx["F_opt"]).max())
    log(f"[5] K1 vs native fixture: viol {float(vf[0]):.3e} (< 1e-4), iters {int(itf[0])}, "
        f"|dX| {fdX:.3e} (< 1e-3), |dF| {fdF:.3e} (< 5e-3)")
    check(float(vf[0]) < 1e-4 and fdX < 1e-3 and fdF < 5e-3, "K1 misses the native fixture")

    # ---- 5a. K1 and K2 at twice the trot's horizons, against their plain versions ----
    # the trot with gait_horizon=4.0, the longest Solo12 gait horizon of the
    # JAX package's motions: ADMM H=40 (fewer problems a block fit), IK H=20;
    # the gates of phases 3 and 4(a)
    spec2 = KD.make_cyclic_spec(model, dataclasses.replace(trot, gait_horizon=4.0),
                                Solo12Config.q0(), device="cuda")
    prob2 = KD._prepare_problem(spec2, *inputs)
    admm2 = (prob2["plan"], m, prob2["x_init"], prob2["W"], prob2["X_ref"], prob2["W_F"],
             prob2["X_wm"], prob2["F_wm"], prob2["x_bounds"])
    card36["5a shape"] = (spec2.horizon, cuda_admm.launch_per_block(spec2.horizon), spec2.ik_hor,
                          cuda_ddp.launch_per_block(spec2.ik_hor))
    card36["5a K1"] = cuda_admm.solve(*admm2, pinned)
    refs36["5a K1"] = pool.submit(plain_job, "admm", to_host(admm2), pinned, "float32")
    rnd2 = workload.random_ik_problems(model, spec2.eff_frames, B, spec2.ik_hor, dev)
    card36["5a K2"] = cuda_ddp.solve_ik_batch(*rnd2, cfg=one)
    refs36["5a K2"] = pool.submit(plain_job, "ddp", to_host(rnd2), one, "float64")
    torch.cuda.synchronize()
    check(bool(torch.isfinite(card36["5a K1"][0]).all() and
               torch.isfinite(card36["5a K2"][0]).all()), "long-horizon output not finite")

    # ---- 5b. K3 against its plain version, on the card ----
    H = spec.horizon
    pc = KD.make_prep_consts(spec)
    ci = KD._compact_inputs(spec, *inputs)
    k3_in = (ci[1], ci[2], inputs[4], ci[3], ci[4], ci[5], ci[6], m, pc)
    for name, cfg in (("pinned (15 iters)", pinned), ("bench config", bench_cfg)):
        K = cuda_fused.solve_from_state(*k3_in, cfg, H, spec.n_eff)
        P = cuda_fused.solve_from_state_plain(*k3_in, cfg, H, spec.n_eff)
        torch.cuda.synchronize()
        dr, ddt = float((K[5] - P[5]).abs().max()), float((K[6] - P[6]).abs().max())
        log(f"[5b] K3 {name}: cnt equal {torch.equal(K[4], P[4])}, swing equal "
            f"{torch.equal(K[7], P[7])}, |dr| {dr:.3e} (< 1e-5), |ddt| {ddt:.3e} (< 1e-5); "
            f"iters kernel mean {K[3].float().mean():.2f}, plain {P[3].float().mean():.2f}")
        check(torch.equal(K[4], P[4]) and torch.equal(K[7], P[7]), "K3 contact plan flags differ")
        check(dr < 1e-5 and ddt < 1e-5, "K3 contact locations or knot durations differ")
        check(bool(torch.isfinite(K[0]).all() and torch.isfinite(K[1]).all()), "K3 not finite")
        if cfg is pinned:
            dX, dF = float((K[0] - P[0]).abs().max()), float((K[1] - P[1]).abs().max())
            dv = float(((K[2] - P[2]).abs() / P[2].abs().clamp_min(1e-30)).max())
            log(f"  K3 pinned: |dX| {dX:.3e} (< 1e-4), |dF| {dF:.3e} (< 1e-3), viol rel "
                f"{dv:.3e} (< 1e-3)")
            check(dX < 1e-4 and dF < 1e-3 and dv < 1e-3, "K3 pinned case disagrees")
        else:
            k3_err = quantile_gate("K3 X", K[0], P[0])
            k3_iters = K[3]

    # ---- 6. the main path, end to end ----
    ddp_cfg = DdpConfig()

    def solve():
        return KD.solve_mpc_batch(spec, *inputs, admm_cfg=bench_cfg, ddp_cfg=ddp_cfg,
                                  admm_backend="cuda", ik_backend="cuda")

    # K2 counts its launches at every joint count (a library each)
    kernels_of = {"admm": [cuda_admm.KERNEL], "ddp": list(cuda_ddp.KERNELS.values()),
                  "fused": [cuda_fused.KERNEL]}

    def zero_counts():
        for ks in kernels_of.values():
            for k in ks:
                k.launches = 0

    def counts():
        return {n: sum(k.launches for k in ks) for n, ks in kernels_of.items()}

    zero_counts()
    plans = solve()
    torch.cuda.synchronize()
    launches = counts()
    log(f"[6] main path launches: {launches}")
    check(launches == {"admm": 1, "ddp": 1, "fused": 0}, "K1 and K2 must launch once per solve")
    expect = {"xs_int": (B, spec.n_int, 37), "us_int": (B, spec.n_int, 18),
              "f_int": (B, spec.n_int, 12), "X_opt": (B, 21, 9), "F_opt": (B, 20, 4, 3),
              "xs": (B, 11, 37), "us": (B, 10, 18)}
    for name, shape in expect.items():
        a = getattr(plans, name)
        check(tuple(a.shape) == shape, f"{name}: shape {tuple(a.shape)}, expected {shape}")
        check(bool(torch.isfinite(a).all()), f"{name}: not finite")
    conv = float((plans.dyn_violation < 1e-3).float().mean())
    log(f"[6] converged_frac {conv:.4f} (>= 0.99), admm iters mean "
        f"{plans.admm_iters.float().mean():.2f}")
    check(conv >= 0.99, "converged_frac below 0.99")
    # the whole path against the plain path in f64 on the first 64 problems
    # (the host CPU's workers; held in finish_3_6)
    refs36["6"] = pool.submit(plain_job, "mpc", to_host(tuple(a[:64] for a in inputs)), bench_cfg,
                              "float64")

    # timed reps: host clock around work that ends in synchronize
    solve()
    torch.cuda.synchronize()
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        reps.append(time.perf_counter() - t0)
    check(cuda_admm.KERNEL.launches == 7 and cuda_ddp.KERNEL.launches == 7,
          "launch counters did not rise by one per solve")
    med = float(np.median(reps))

    stages = main_path_stage_ms(torch, spec, inputs, bench_cfg)
    log(json.dumps({
        "metric": "trot_mpc_solves_per_sec", "value": round(B / med, 1), "batch": B,
        "converged_frac": conv, "rep_times_s": [round(r, 5) for r in reps],
        "stage_ms": stages, "card": card,
    }))

    # ---- 6b. the fused path (fuse_prep=True: compact inputs, K3, IK, K2), end to end ----
    def solve_fused():
        return KD.solve_mpc_batch(spec, *inputs, admm_cfg=bench_cfg, ddp_cfg=ddp_cfg,
                                  admm_backend="cuda", ik_backend="cuda", fuse_prep=True)

    zero_counts()
    fplans = solve_fused()
    torch.cuda.synchronize()
    launches = counts()
    log(f"[6b] fused path launches: {launches}")
    check(launches == {"admm": 0, "ddp": 1, "fused": 1}, "K3 and K2 must launch once per solve")
    for name, shape in expect.items():
        a = getattr(fplans, name)
        check(tuple(a.shape) == shape, f"fused {name}: shape {tuple(a.shape)}, expected {shape}")
        check(bool(torch.isfinite(a).all()), f"fused {name}: not finite")
    fconv = float((fplans.dyn_violation < 1e-3).float().mean())
    log(f"[6b] converged_frac {fconv:.4f} (>= 0.99), admm iters mean "
        f"{fplans.admm_iters.float().mean():.2f}")
    check(fconv >= 0.99, "fused path converged_frac below 0.99")
    log(f"[6b] fused path vs the main path (both on the kernels, {B} problems):")
    quantile_gate("xs", fplans.xs, plans.xs)
    quantile_gate("X_opt", fplans.X_opt, plans.X_opt)
    solve_fused()
    torch.cuda.synchronize()
    freps = []
    for _ in range(5):
        t0 = time.perf_counter()
        solve_fused()
        torch.cuda.synchronize()
        freps.append(time.perf_counter() - t0)
    fmed = float(np.median(freps))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    qr, t_, vdw, x_init, ee, hip, amom = KD._compact_inputs(spec, *inputs)
    ev[1].record()
    X, F, viol, iters, cnt, r, dts, swing = cuda_fused.solve_from_state(
        t_, vdw, inputs[4], x_init, ee, hip, amom, m, pc, bench_cfg, H, spec.n_eff)
    ev[2].record()
    fpr = dict(q=qr, v=inputs[1], x_init=x_init, plan=type(plan)(cnt=cnt, r=r, dt=dts),
               swing_mask=swing)
    tk, x0s = KD._build_ik_tasks(spec, fpr, X)
    ws, wt, cw, xr = IK.dense_weights(model, spec.eff_frames, tk)
    ev[3].record()
    ixs, ius, icost = cuda_ddp.solve_ik_batch(model, spec.eff_frames, x0s, tk.ee_targets,
                                              tk.com_ref, tk.mom_ref, xr, ws, wt, cw, tk.dts)
    ev[4].record()
    KD._finish_from_ik(spec, fpr, X, F, viol, iters, ixs, ius, icost, torch.zeros_like(X))
    ev[5].record()
    torch.cuda.synchronize()
    fstage_names = ["compact", "k3", "ik_build", "k2_ddp", "interp"]
    fstages = {n: round(ev[i].elapsed_time(ev[i + 1]), 3) for i, n in enumerate(fstage_names)}
    log(json.dumps({
        "metric": "fused_trot_mpc_solves_per_sec", "value": round(B / fmed, 1), "batch": B,
        "converged_frac": fconv, "rep_times_s": [round(r, 5) for r in freps],
        "stage_ms": fstages, "card": card,
    }))

    # ---- 7a. the kernels inside the closed loop: one window ----
    # the closed loop of the data-collection driver: the walking trot
    # (trot_sim) on its simulator, from the settled standing start, with
    # commands of the reference envelope (vx ~ U[0, 0.3], seed 0); one window
    # is one solve (K1 and K2 once each) and 50 substeps
    card36["6"] = plans

    def finish_3_6():
        """Phases 3-6's gates: the card's results against the plain references
        the host CPU's workers computed from the same inputs. Returns K1's and
        K2's max errors for the kernels line."""
        t1 = time.perf_counter()
        ref = {k: from_host(torch, f.result(), None, dev) for k, f in refs36.items()}
        log(f"[3-6] the plain references of phases 3-6 on the host CPU's workers: waited "
            f"{time.perf_counter() - t1:.1f} s")
        Xk, Fk, vk, _, _ = card36["3 pinned"]
        Xp, Fp, vp, _, _ = ref["3 pinned"]
        dX, dF = float((Xk - Xp).abs().max()), float((Fk - Fp).abs().max())
        dv = float(((vk - vp).abs() / vp.abs().clamp_min(1e-30)).max())
        log(f"[3] K1 pinned (15 iters): |dX| {dX:.3e} (< 1e-4), |dF| {dF:.3e} (< 1e-3), "
            f"viol rel {dv:.3e} (< 1e-3)")
        check(dX < 1e-4 and dF < 1e-3 and dv < 1e-3,
              "K1 pinned case disagrees with its plain version")
        Xk, Fk, vk, itk, Pk = card36["3 bench"]
        Xp, Fp, vp, itp, Pp = ref["3 bench"]
        log(f"[3] K1 bench config: iters kernel mean {itk.float().mean():.2f}, plain mean "
            f"{itp.float().mean():.2f}; problems with other iteration counts {(itk != itp).sum()}")
        k1_err = quantile_gate("K1 X", Xk, Xp)
        log(f"  K1 F: |d| max {float((Fk - Fp).abs().max()):.3e} (force scale "
            f"{float(Fp.abs().max()):.1f} N)")
        for name, _, viol_tol in branches:
            Xb, Fb, vb, _, _ = card36[f"3b {name}"]
            Xr, Fr, vr, _, _ = ref[f"3b {name} float64"]
            X3, _, v3, _, _ = ref[f"3b {name} float32"]
            dX, dF = float((Xb.double() - Xr).abs().max()), float((Fb.double() - Fr).abs().max())
            dv = float(((vb.double() - vr).abs() / vr.abs().clamp_min(1e-30)).max())
            dv3 = float(((v3.double() - vr).abs() / vr.abs().clamp_min(1e-30)).max())
            log(f"[3b] K1 {name} (15 iters) vs plain f64: |dX| {dX:.3e} (< 5e-3), |dF| {dF:.3e} "
                f"(< 2e-1), viol rel {dv:.3e} (< {viol_tol}); plain f32 vs plain f64: |dX| "
                f"{float((X3.double() - Xr).abs().max()):.3e}, viol rel {dv3:.3e}")
            check(dX < 5e-3 and dF < 2e-1 and dv < viol_tol,
                  f"K1 {name} disagrees with its plain version")
            check(bool(torch.isfinite(Xb).all() and torch.isfinite(Fb).all()),
                  f"K1 {name} not finite")
        log(f"[3c] the carried dual: |P0| max {float(P0.abs().max()):.3e}; K1's P vs the plain "
            f"version's on the bench solve: |d| max {float((Pk - Pp).abs().max()):.3e}")
        for prec in (False, True):
            (Xc, Fc, vc, itc, Pc), cold = card36[f"3c {prec}"]
            Xr, Fr, vr, itr, Pr = ref[f"3c {prec}"]
            log(f"[3c] K1 precondition={prec} with the carried dual vs plain f64: iters mean "
                f"kernel {itc.float().mean():.2f}, plain {itr.float().mean():.2f} (a zero dual: "
                f"{cold[3].float().mean():.2f}); viol max {float(vc.max()):.3e}")
            quantile_gate(f"K1 X (precondition={prec}, P0)", Xc.double(), Xr)
            quantile_gate(f"K1 P (precondition={prec}, P0)", Pc.double(), Pr)
            check(bool(torch.isfinite(Xc).all() and torch.isfinite(Pc).all()),
                  "K1 with a carried dual not finite")
        xs_k, us_k, c_k = card36["4 one"]
        xs_p, us_p, c_p = ref["4 one"]
        dxs, dus = float((xs_k - xs_p).abs().max()), float((us_k - us_p).abs().max())
        dc = float(((c_k - c_p).abs() / c_p.abs()).max())
        log(f"[4] K2 one iteration (kernel f32 vs plain f64): |dxs| {dxs:.3e} (< 2e-4), "
            f"|dus| {dus:.3e} (< 2e-3), cost rel {dc:.3e} (< 1e-4)")
        check(dxs < 2e-4 and dus < 2e-3 and dc < 1e-4, "K2 single iteration disagrees")
        xs_k, us_k, c_k = card36["4 full"]
        xs_p, us_p, c_p = ref["4 full"]
        log("[4] K2 full config (kernel f32 vs plain f64):")
        k2_err = quantile_gate("K2 xs", xs_k.double(), xs_p)
        log(f"  K2 cost rel max {float(((c_k.double() - c_p).abs() / c_p.abs()).max()):.3e}")
        H2, pb2, Hik2, pbik2 = card36["5a shape"]
        Xk, Fk, vk, _, _ = card36["5a K1"]
        Xp, Fp, vp, _, _ = ref["5a K1"]
        dX, dF = float((Xk - Xp).abs().max()), float((Fk - Fp).abs().max())
        dv = float(((vk - vp).abs() / vp.abs().clamp_min(1e-30)).max())
        log(f"[5a] K1 at H={H2} ({pb2} problems a block), pinned: |dX| {dX:.3e} (< 1e-4), |dF| "
            f"{dF:.3e} (< 1e-3), viol rel {dv:.3e} (< 1e-3)")
        check(dX < 1e-4 and dF < 1e-3 and dv < 1e-3, "K1 at the long horizon disagrees")
        xs_k, us_k, c_k = card36["5a K2"]
        xs_p, us_p, c_p = ref["5a K2"]
        dxs, dus = float((xs_k - xs_p).abs().max()), float((us_k - us_p).abs().max())
        dc = float(((c_k - c_p).abs() / c_p.abs()).max())
        log(f"[5a] K2 at IK H={Hik2} ({pbik2} problems a block), one iteration vs plain f64: "
            f"|dxs| {dxs:.3e} (< 2e-4), |dus| {dus:.3e} (< 2e-3), cost rel {dc:.3e} (< 1e-4)")
        check(dxs < 2e-4 and dus < 2e-3 and dc < 1e-4, "K2 at the long horizon disagrees")
        log("[6] main path vs plain path in f64 (64 problems):")
        quantile_gate("xs", card36["6"].xs[:64].double(), ref["6"]["xs"])
        quantile_gate("X_opt", card36["6"].X_opt[:64].double(), ref["6"]["X_opt"])
        return k1_err, k2_err

    SECONDS["3-6b"] = time.time() - t36
    log(f"[6] phases 3-6b done {time.time() - t_start:.1f} s after the start")
    t7a = time.time()
    win_cfg = rollout.RolloutConfig(episode_length=100, kp=trot_sim.kp, kd=trot_sim.kd,
                                    gait_period=trot_sim.gait_period)
    n = WINDOW_N
    plans = []  # the card's two solves
    solve_batch = capture_solves(KD, plans)
    try:
        zero_counts()
        win = rollout.rollout_mpc(loop_spec, sim, win_cfg, start, *cmd)
        torch.cuda.synchronize()
        win_launches = counts()
    finally:
        KD.solve_mpc_batch = solve_batch
    t_w = KD.window_clock(0.0, 0, win_cfg.plan_freq, start.q).expand(B)

    def finish_7a(card_plans=plans, win=win, n=n, win_launches=win_launches):
        """7a's gates against the plain path's two windows in f64 and f32,
        which the host CPU's workers compute meanwhile."""
        # the plain path's, in f64 and f32 (the host CPU's workers)
        t0 = time.perf_counter()
        ref_win, ref_plans = {}, {}
        for dtype in (torch.float64, f32):
            ref_win[dtype], ref_plans[dtype] = reference_rollout(
                torch, window_refs[str(dtype).split(".")[-1]], dev)
        plans = card_plans + ref_plans[torch.float64]
        log(f"[7a] waited {time.perf_counter() - t0:.2f} s for the plain references")
        dq, dv = end_diff_at(win, ref_win[torch.float64])
        sq, sv = end_diff_at(ref_win[f32], ref_win[torch.float64])
        log(f"[7a] two windows (the second solve takes the first's X, F and dual P) launches: "
            f"{win_launches}; end q |d| {dq:.3e} (< {TWO_WINDOW_Q_TOL:.1e}), v |d| {dv:.3e} (< "
            f"{TWO_WINDOW_V_TOL:.1e}) against the plain path in f64 ({n} episodes); the plain "
            f"path's own f32 spread here q {sq:.3e}, v {sv:.3e} (CPU test: q "
            f"{TWO_WINDOW_SPREAD[0]:.3e}, v "
            f"{TWO_WINDOW_SPREAD[1]:.3e}); ADMM iterations mean window 1 "
            f"{plans[0].admm_iters.float().mean():.2f}, window 2 "
            f"{plans[1].admm_iters.float().mean():.2f} (plain f64: "
            f"{plans[2].admm_iters.float().mean():.2f}, "
            f"{plans[3].admm_iters.float().mean():.2f})")
        log(f"[7a] the windows' plans and K1's dual after window 1 against the plain path in f64 "
            f"({n} episodes):")
        quantile_gate("xs_int (window 1)", plans[0].xs_int[:n, :50].double(), plans[2].xs_int)
        quantile_gate("f_int (window 1, substep 0)", plans[0].f_int[:n, 0].double(),
                      plans[2].f_int)
        quantile_gate("P_opt (window 1)", plans[0].P_opt[:n].double(), plans[2].P_opt)
        quantile_gate("xs_int (window 2, carried)", plans[1].xs_int[:n, :50].double(),
                      plans[3].xs_int)
        check(bool(plans[0].P_opt.abs().max() > 0), "K1 returned a zero dual")
        check(win_launches == {"admm": 2, "ddp": 2, "fused": 0},
              "two windows must launch K1 and K2 twice each")
        check(dq < TWO_WINDOW_Q_TOL and dv < TWO_WINDOW_V_TOL, "end-of-window state disagrees")
        check(bool(torch.isfinite(win.states).all()), "window records not finite")

    SECONDS["7a"] = time.time() - t7a
    log(f"[7a] {time.time() - t7a:.1f} s")
    t7b = time.time()

    # ---- 7b. the closed loop at full width: 512 episodes x 3000 steps ----
    loop_cfg = rollout.RolloutConfig(episode_length=3000, kp=trot_sim.kp, kd=trot_sim.kd,
                                     gait_period=trot_sim.gait_period)
    nw, spp = loop_cfg.n_windows, loop_cfg.steps_per_plan
    windows = []  # per window: CUDA events around its solve, the plan's violations
    solve_batch = KD.solve_mpc_batch

    def timed_solve(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        plan = solve_batch(*a, **k)
        e1.record()
        windows.append((e0, e1, plan.dyn_violation, plan.admm_iters))
        return plan

    KD.solve_mpc_batch = timed_solve
    try:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout.rollout_mpc(loop_spec, sim, loop_cfg, start, *cmd)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        loop_launches = counts()
        # the same loop cold (warm_start_carry=False, PR 8's default on the card) over
        # its first COLD_WINDOWS windows, against the carried run's first as many
        carried_windows, windows = windows, []
        cold_cfg = dataclasses.replace(loop_cfg, episode_length=COLD_WINDOWS * loop_cfg.steps_per_plan)
        res_cold = rollout.rollout_mpc(loop_spec, sim, cold_cfg, start, *cmd,
                                       warm_start_carry=False)
        e_end = torch.cuda.Event(enable_timing=True)
        e_end.record()
        torch.cuda.synchronize()
        cold_windows, windows = windows, carried_windows
    finally:
        KD.solve_mpc_batch = solve_batch
    T = loop_cfg.episode_length
    failed, fail_step = res.failed.cpu().numpy(), res.fail_step.cpu().numpy()
    alive = ~failed
    finite, frozen = finite_and_frozen(torch, res)
    viols = torch.stack([w[2] for w in windows]).cpu().numpy()  # (windows, B)
    live = fail_step[None, :] > (np.arange(nw) * spp)[:, None]  # alive at the window's start
    conv_loop = float((viols[live] < 1e-3).mean())
    iters_all = torch.stack([w[3] for w in windows]).float().cpu().numpy()  # (windows, B)
    iters_loop = float(iters_all[live].mean())
    nc = COLD_WINDOWS
    cold_live = res_cold.fail_step.cpu().numpy()[None, :] > (np.arange(nc) * spp)[:, None]
    iters_cold = float(torch.stack([w[3] for w in cold_windows]).float().cpu().numpy()[
        cold_live].mean())
    iters_carried_head = float(iters_all[:nc][live[:nc]].mean())
    # the slowest live problem of each window sets K1's time in that window
    win_max = [float(iters_all[w][live[w]].max()) for w in range(nw) if live[w].any()]
    cold_all = torch.stack([w[3] for w in cold_windows]).float().cpu().numpy()
    cold_max = [float(cold_all[w][cold_live[w]].max()) for w in range(nc) if cold_live[w].any()]
    iters_max = {"carried": {"mean_of_window_max": round(float(np.mean(win_max)), 2),
                             "max": int(max(win_max)),
                             "head_mean_of_window_max": round(float(np.mean(win_max[:nc])), 2)},
                 "cold_head": {"mean_of_window_max": round(float(np.mean(cold_max)), 2),
                               "max": int(max(cold_max))}}
    head_ms = {"carried": windows[0][0].elapsed_time(windows[nc][0]),
               "cold": cold_windows[0][0].elapsed_time(e_end)}
    head_rate = {k: B * nc * spp / (v / 1e3) for k, v in head_ms.items()}
    head_survival = {"carried": float((fail_step >= nc * spp).mean()),
                     "cold": float(1 - res_cold.failed.float().mean())}
    solve_ms_cold = [a.elapsed_time(b) for a, b, _, _ in cold_windows]
    solve_ms = [a.elapsed_time(b) for a, b, _, _ in windows]
    window_ms = [windows[i][0].elapsed_time(windows[i + 1][0]) for i in range(nw - 1)]
    sub_ms = [w - s for w, s in zip(window_ms, solve_ms)]
    rpy = rot_to_rpy(quat_to_rot(res.states[..., 27:31])).cpu().numpy()  # q[3:7] of the features
    z = res.states[..., 26].cpu().numpy()  # q[2]
    roll_max = np.rad2deg(np.abs(rpy[alive, 500:, 0]).max(axis=1))
    z_dev = np.abs(z[alive, -1000:].mean(axis=1) - trot_sim.nom_ht)
    survival = float(alive.mean())
    med_roll = float(np.median(roll_max)) if alive.any() else float("nan")
    med_z = float(np.median(z_dev)) if alive.any() else float("nan")
    stages = main_path_stage_ms(torch, loop_spec, (start.q, start.v, t_w, *cmd),
                                cuda_admm.CudaAdmmConfig(rho=trot_sim.rho, x_solver="thomas"))
    log(f"[7b] closed loop: {B} episodes x {T} steps ({nw} windows) in {wall:.2f} s, "
        f"{B * T / wall:.1f} env-steps/s; launches {loop_launches}; (X, F, P) carried: live "
        f"solves' ADMM iterations mean {iters_loop:.2f}, the slowest live problem's a window "
        f"{iters_max['carried']['mean_of_window_max']:.2f} on average (max "
        f"{iters_max['carried']['max']}), solve ms mean {np.mean(solve_ms):.2f}")
    log(f"[7b] the first {nc} windows ({nc * spp} steps), carried against the same loop cold "
        f"in this run (CUDA events): env-steps/s {head_rate['carried']:.1f} vs "
        f"{head_rate['cold']:.1f}; survival to step {nc * spp} {head_survival['carried']:.4f} vs "
        f"{head_survival['cold']:.4f}; live solves' ADMM iterations mean "
        f"{iters_carried_head:.2f} vs {iters_cold:.2f}, the slowest live problem's a window "
        f"{iters_max['carried']['head_mean_of_window_max']:.2f} vs "
        f"{iters_max['cold_head']['mean_of_window_max']:.2f}; solve ms mean "
        f"{np.mean(solve_ms[:nc]):.2f} vs {np.mean(solve_ms_cold):.2f}")
    log(f"[7b] survival {survival:.4f} (>= 0.5), mean survival {float(fail_step.mean()):.1f} ms; "
        f"survivors' median roll_max (500-3000 ms) {med_roll:.3f} deg (< 10), median |mean z "
        f"(last 1000 ms) - {trot_sim.nom_ht}| {med_z:.4f} m (< 0.03); converged_frac of the "
        f"live episodes' solves {conv_loop:.4f}; records of live episodes finite {finite}, "
        f"failed episodes frozen {frozen}")
    log(json.dumps({
        "metric": "closed_loop_env_steps_per_sec", "value": round(B * T / wall, 1), "batch": B,
        "steps": T, "wall_s": round(wall, 3), "survival": survival,
        "window_ms_mean": round(float(np.mean(window_ms)), 3),
        "solve_ms_mean": round(float(np.mean(solve_ms)), 3),
        "substeps_ms_mean": round(float(np.mean(sub_ms)), 3),
        "first_window_ms": round(window_ms[0], 3), "solve_stage_ms_window0": stages,
        "admm_iters_mean": iters_loop, "admm_iters_slowest": iters_max,
        "first_windows_carried_vs_cold": {
            "windows": nc, "env_steps_per_sec": head_rate, "survival": head_survival,
            "admm_iters_mean": {"carried": iters_carried_head, "cold": iters_cold},
            "solve_ms_mean": {"carried": float(np.mean(solve_ms[:nc])),
                              "cold": float(np.mean(solve_ms_cold))}},
        "card": card,
    }))
    check(loop_launches == {"admm": nw, "ddp": nw, "fused": 0},
          f"the closed loop must launch K1 and K2 once per window ({nw})")
    check(finite, "records of live episodes not finite")
    check(frozen, "failed episodes were not frozen")
    check(survival >= 0.5, f"survival {survival:.4f} below 0.5")
    check(med_roll < 10.0, f"survivors' median roll_max {med_roll:.3f} deg not below 10")
    check(med_z < 0.03, f"survivors' median height error {med_z:.4f} m not below 0.03")

    SECONDS["7b"] = time.time() - t7b
    # ---- 8. the learning loop: data collection, BC, the policy rollout ----
    t0 = time.time()
    dc_launches, cc_policy = learning_loop(torch, loop_spec, sim, start, cmd, zero_counts, counts,
                                           card)
    SECONDS["8"] = time.time() - t0
    log(f"[8] learning loop {time.time() - t0:.1f} s")

    # ---- 9. the DAgger family: SafeDagger, rollout_dagger, LocoSafeDagger ----
    t0 = time.time()
    dagger_launches, vc_policies, finish_9d = dagger_family(torch, loop_spec, sim, start,
                                                            zero_counts, counts, card, pool)
    SECONDS["9"] = time.time() - t0
    log(f"[9] DAgger family {time.time() - t0:.1f} s")

    # ---- 10. every gait (10a) and the eval suite (10b-10f) ----
    t0 = time.time()
    gait_launches = every_gait(torch, refs, zero_counts, counts, card)
    SECONDS["10a"] = time.time() - t0
    log(f"[10a] every gait {time.time() - t0:.1f} s")
    t1 = time.time()
    eval_launches = eval_suite(torch, loop_spec, sim, start, zero_counts, counts, card, vc_policies,
                               cc_policy)
    SECONDS["10b-10f"] = time.time() - t1
    log(f"[10] eval suite {time.time() - t1:.1f} s; phase 10 {time.time() - t0:.1f} s")

    # ---- 11. the Go2: every gait on both paths (11a), its closed loop (11b-11d) ----
    t0 = time.time()
    go2_launches, _ = go2_gaits(torch, refs, zero_counts, counts, card)
    SECONDS["11a"] = time.time() - t0
    log(f"[11a] the Go2's gaits {time.time() - t0:.1f} s")
    t1 = time.time()
    go2_loop_launches, finish_11b = go2_loop(torch, zero_counts, counts, card, pool)
    SECONDS["11b-11d"] = time.time() - t1
    log(f"[11] the Go2's loop {time.time() - t1:.1f} s; phase 11 {time.time() - t0:.1f} s")

    # ---- 12. the Solo8: K2 at 8 joints on the main and the fused path ----
    t0 = time.time()
    solo8_launches, k2_nj8 = solo8_phase(torch, refs, zero_counts, counts, card)
    SECONDS["12"] = time.time() - t0
    log(f"[12] the Solo8 {time.time() - t0:.1f} s")

    # ---- 13. terrain: zero heights, a slope, a random heightfield ----
    t0 = time.time()
    terrain_launches = terrain_phase(torch, loop_spec, sim, start, cmd, slope_ref, zero_counts,
                                     counts, card)
    SECONDS["13"] = time.time() - t0
    log(f"[13] terrain {time.time() - t0:.1f} s")

    # ---- 14. the six Solo12 acyclic motions through K1 and K2 ----
    t0 = time.time()
    acyclic_launches = acyclic_table(torch, refs, zero_counts, counts, card)
    SECONDS["14"] = time.time() - t0
    log(f"[14] the acyclic motions {time.time() - t0:.1f} s")

    # ---- 15. the experiment drivers: the CLI's main() in-process, and a trace ----
    t0 = time.time()
    driver_launches = experiment_drivers(torch, spec, inputs, bench_cfg, ddp_cfg, zero_counts,
                                         counts, card)
    SECONDS["15"] = time.time() - t0
    log(f"[15] the experiment drivers {time.time() - t0:.1f} s")

    # ---- 16. the analysis scripts and the learning demos ----
    t0 = time.time()
    script_launches = analysis_scripts(torch, zero_counts, counts, card)
    SECONDS["16"] = time.time() - t0
    log(f"[16] the analysis scripts {time.time() - t0:.1f} s")

    # ---- 3-6's, 7a's, 9d's and 11b's gates: their plain references ran on the host CPU's
    # workers ----
    t0 = time.time()
    k1_err, k2_err = finish_3_6()
    finish_7a()
    finish_9d()
    finish_11b()
    SECONDS["gates 3-6, 7a, 9d, 11b"] = time.time() - t0

    # ---- 7. the kernels line ----
    t_line = time.time()
    zero_counts()
    solve()
    torch.cuda.synchronize()
    main_launches = counts()
    check(main_launches == {"admm": 1, "ddp": 1, "fused": 0}, "main path launches")
    zero_counts()
    solve_fused()
    torch.cuda.synchronize()
    fused_launches = counts()
    check(fused_launches == {"admm": 0, "ddp": 1, "fused": 1}, "fused path launches")

    k1_ms = cuda_ms(torch, lambda: cuda_admm.solve(*admm_in, bench_cfg), 5)
    k1_plain_ms = cuda_ms(torch, lambda: cuda_admm.solve_plain(*admm_in, bench_cfg), 1)
    k3_ms = cuda_ms(torch, lambda: cuda_fused.solve_from_state(*k3_in, bench_cfg, H, 4), 5)
    k3_plain_ms = cuda_ms(
        torch, lambda: cuda_fused.solve_from_state_plain(*k3_in, bench_cfg, H, 4), 1)
    k2_ms = cuda_ms(torch, lambda: cuda_ddp.solve_ik_batch(*ddp_in, cfg=full), 3)
    k2_plain_ms = cuda_ms(torch, lambda: cuda_ddp.solve_ik_batch_plain(*ddp_in, cfg=full), 1)
    Hik = spec.ik_hor
    fista_total = cuda_admm.fista_iterations(*admm_in, bench_cfg)
    k3_fista = cuda_fused.fista_iterations(*k3_in, bench_cfg, H, 4)
    log(f"[7] K1 work per problem: ADMM iterations mean {itk.float().mean():.2f}, F-step FISTA "
        f"iterations mean {fista_total.float().mean():.2f}")
    # K1 reads cnt, r, dt, x_init, W, q, W_F, qF, lb, ub, X_wm, F_wm and
    # writes X, F, viol, iters (f32/int32)
    nXk, nFk = (H + 1) * 9, H * 12
    k1_bytes = 4.0 * B * (H * 4 + nFk + H + 9 + 5 * nXk + 3 * nFk + nXk + nFk + 2)
    k1_bound, k1_by = bound_ms(k1_bytes, admm_ops(itk, fista_total, H, bench_cfg))
    # K3 reads t, v_des_w, w_des, x_init, ee, hip, amom (41 floats) and
    # writes X, F, viol, iters, cnt, r, dt, swing
    k3_bytes = 4.0 * B * (41 + nXk + nFk + 2 + H * 4 + nFk + H + H * 4)
    k3_bound, k3_by = bound_ms(
        k3_bytes, admm_ops(k3_iters, k3_fista, H, bench_cfg) + prep_ops(B, H))
    k2_bound, k2_by = bound_ms(ddp_bytes(B, Hik), ddp_ops(B, Hik, full))
    def phase10(k):
        """Kernel ``k``'s launches per gait and path (10a), per eval call
        (10b-10f; a list per call where a phase makes several), per Go2 gait
        and path (11a), per Go2 loop call (11b-11d), per Solo8 path (12), per
        terrain call (13), per acyclic motion (14) and per driver call (15)."""
        return {"gait_launches": {g: {p: n[k] for p, n in paths.items()}
                                  for g, paths in gait_launches.items()},
                "eval_launches": {tag: [c[k] for c in v] if isinstance(v, list) else v[k]
                                  for tag, v in eval_launches.items()},
                "go2_gait_launches": {g: {p: n[k] for p, n in paths.items()}
                                      for g, paths in go2_launches.items()},
                "go2_loop_launches": {tag: c[k] for tag, c in go2_loop_launches.items()},
                "solo8_launches": {g: {p: n[k] for p, n in paths.items()}
                                   for g, paths in solo8_launches.items()},
                "terrain_launches": {tag: c[k] for tag, c in terrain_launches.items()},
                "acyclic_launches": {name: c[k] for name, c in acyclic_launches.items()},
                "driver_launches": {tag: c[k] for tag, c in driver_launches.items()},
                "script_launches": {tag: c[k] for tag, c in script_launches.items()}}

    kernels = [
        {"name": "admm", "route": "cuda", "source": "bunmpc_tpu_torch/csrc/admm.cu",
         "replaces": "bunmpc_tpu/solvers/pallas_admm.py:589", "launches": main_launches["admm"],
         "closed_loop_launches": loop_launches["admm"],
         "data_collection_launches": dc_launches["admm"],
         "dagger_launches": [c["admm"] for c in dagger_launches],
         "max_abs_err": k1_err, "ms": round(k1_ms, 4), "plain_ms": round(k1_plain_ms, 4),
         "bound_ms": round(k1_bound, 6), "bound_by": k1_by, "library_ms": None,
         **phase10("admm")},
        {"name": "ddp", "route": "cuda", "source": "bunmpc_tpu_torch/csrc/ddp.cu",
         "replaces": "bunmpc_tpu/solvers/pallas_ddp.py:1046", "launches": main_launches["ddp"],
         "closed_loop_launches": loop_launches["ddp"],
         "data_collection_launches": dc_launches["ddp"],
         "dagger_launches": [c["ddp"] for c in dagger_launches],
         "max_abs_err": k2_err, "ms": round(k2_ms, 4), "plain_ms": round(k2_plain_ms, 4),
         "bound_ms": round(k2_bound, 6), "bound_by": k2_by, "library_ms": None,
         **phase10("ddp")},
        {"name": "fused", "route": "cuda", "source": "bunmpc_tpu_torch/csrc/fused.cu",
         "replaces": "bunmpc_tpu/solvers/pallas_admm.py:1028",
         "launches": fused_launches["fused"], "data_collection_launches": dc_launches["fused"],
         "dagger_launches": [c["fused"] for c in dagger_launches],
         "max_abs_err": k3_err, "ms": round(k3_ms, 4),
         "plain_ms": round(k3_plain_ms, 4), "bound_ms": round(k3_bound, 6), "bound_by": k3_by,
         "library_ms": None, **phase10("fused")},
        {"name": "ddp (8 joints)", "route": "cuda", "source": "bunmpc_tpu_torch/csrc/ddp.cu",
         "replaces": "bunmpc_tpu/solvers/pallas_ddp.py:1046",
         "launches": solo8_launches["trot"]["main"]["ddp"],
         "solo8_launches": {p: n["ddp"] for p, n in solo8_launches["trot"].items()},
         "max_abs_err": k2_nj8["max_abs_err"], "ms": k2_nj8["ms"], "plain_ms": k2_nj8["plain_ms"],
         "bound_ms": k2_nj8["bound_ms"], "bound_by": k2_nj8["bound_by"], "library_ms": None},
    ]
    SECONDS["kernels line"] = time.time() - t_line
    total = time.time() - t_start
    log(f"[time] seconds by phase {json.dumps({k: round(v, 1) for k, v in SECONDS.items()})}; "
        f"the phases {sum(v for k, v in SECONDS.items() if '/' not in k):.1f} s of "
        f"a total {total:.1f} s")
    log(f"[7] total {total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
