"""Iterative DAgger / SafeDAgger / LocoSafeDagger drivers.

Counterpart of ``bunmpc_tpu/learning/dagger.py`` (reference
examples/iterative_algorithm/dagger_modified.py:39-918,
safedagger_modified.py:51-916, locosafedagger_modified.py:62-627). The loop
is the reference's, {train -> roll out with expert mixing or gating ->
aggregate expert-labelled data}; every rollout batch of an iteration is one
batched call of ``sim.rollout`` on the driver's device (with the default
"cuda" backends K1 and K2 launch once per window of every MPC and gated
call), and the host samples the commands and goals, copies each call's
records once and aggregates them. LocoSafeDagger's Bayesian grid update is
``learning/bayes.py``.

Algorithm notes against the JAX driver:

* The expert rollouts carry (X, F, P) from window to window for "tiled"
  specs on both backends, as the JAX driver's XLA ADMM does (K1 takes the
  dual in and gives it back). The gated rollouts cold-start, as the JAX
  ``_gated_rollout`` does.
* The perturbations of an iteration are drawn in one batch from the
  driver's ``torch.Generator`` (the JAX driver splits a key per row), and
  DAgger's coins from the same generator (the JAX driver from a key per
  episode); the commands, goals, candidate picks and training seeds come
  from ``np.random.default_rng(seed)`` in the JAX driver's order.
* A checkpoint holds what the JAX driver's does, with the torch
  generator's state in place of the JAX key and the database as the port's
  ``.npz`` snapshot (``database.npz``, not ``database.hdf5``); the policy is
  in the JAX package's format (``utils/checkpoint``). A run resumed from the
  checkpoint after iteration k equals the uninterrupted run bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..mpc import gait as G
from ..mpc.kino_dyn import CyclicMpcSpec, resolve_device
from ..sim import physics, rollout
from . import bayes, data_collection
from . import goals as GU
from . import perturbations
from .bc import BcConfig, train_policy
from .database import Database

# the records the drivers read on the host, copied once per rollout call (the
# final state, from which the ending rollouts start, stays on the device)
_HOST_FIELDS = ("states", "actions", "vc_goals", "failed", "fail_step", "mpc_usage")


@dataclasses.dataclass
class DaggerConfig:
    """Defaults mirror cfgs/dagger_modified_config.yaml /
    safedagger_modified_config.yaml (trot row for the per-gait sigmas), as
    the JAX package's ``DaggerConfig``."""

    episode_length: int = 2000
    n_iterations: int = 5
    rollouts_per_iteration: int = 8
    mpc_usage_percentage: float = 0.5  # DAgger mixing
    # reference num_steps_to_block_under_safety = 2000 (4 gait cycles,
    # safedagger_modified_config.yaml:87): 150 released control back to the
    # policy after 3 swing phases, too early for the expert to stabilise
    # and label a recovery segment
    num_steps_to_block: int = 2000
    vx_range: tuple = (-0.3, 0.5)
    vy_range: tuple = (-0.2, 0.2)
    w_range: tuple = (-0.3, 0.3)
    goal_type: str = "vc"
    action_type: str = "pd_target"  # torque | pd_target | structured
    database_size: int = 1_000_000
    warmup_bc_epochs: int = 150
    bc: BcConfig = dataclasses.field(default_factory=BcConfig)

    # --- the reference loop's structure (safedagger_modified.py:274-916) ---
    # warmup = perturbed-start MPC rollouts along the nominal trajectory
    # (the recovery data BC needs; a standing-start-only warmup gives
    # policies that die within ~1 s), sized by rollouts_warmup commands x
    # one gait cycle of replanning points x perturbations each
    rollouts_warmup: int | None = None  # None -> rollouts_per_iteration
    episode_length_warmup: int | None = None  # None -> episode_length
    warmup_perturbations_per_replanning: int = 1
    # gated rollouts start from perturbed states ON the nominal trajectory
    # (num_replannings sampled replanning points x num_perturbations each)
    num_replannings: int = 1
    num_perturbations: int = 2
    # after each gated episode, an MPC-only rollout continues from its final
    # state (reference ending_mpc_rollout_episode_length; 0 disables)
    ending_mpc_rollout_ms: int = 1000
    # contact-conditioned perturbation sigmas (reference per-gait trot row)
    sigma_base_pos: float = 0.1
    sigma_base_ori: float = 0.7
    sigma_joint_pos: float = 0.2
    sigma_vel: float = 0.2
    # PD-settle the initial pose into the soft contacts before episodes
    settle_ms: int = 500
    # The reference's aggregation (data_collection.py:272-277): failed
    # episodes contribute NOTHING. False keeps the JAX package's deviation
    # (the pre-failure prefix minus PREFIX_MARGIN, recovery-tube coverage),
    # which at a high failed fraction floods the database with doomed
    # trajectories: the JAX package's BC policy degraded iteration over
    # iteration (survival 0.25 -> 0.08 -> 0.0 at failed_frac ~0.85).
    skip_failed_episodes: bool = False
    # Warmup override (None -> skip_failed_episodes). The JAX package's
    # controlled A/B (PARITY.md): keeping prefixes is load-bearing in the
    # perturbed-start warmup (warmup grid survival 1204 ms with it, 643 ms
    # without) while it poisons the gated iterations; the measured best is
    # skip_failed_episodes=True with skip_failed_warmup=False.
    skip_failed_warmup: bool | None = None


class Starts(NamedTuple):
    """A batch of episode starts on the driver's device: state, per-episode
    start time (f32) and command."""

    q: torch.Tensor  # (B, nq)
    v: torch.Tensor  # (B, nv)
    st: torch.Tensor  # (B,)
    v_des: torch.Tensor  # (B, 3)
    w_des: torch.Tensor  # (B,)


class _IterativeDriver:
    """Shared train / roll out / aggregate scaffolding."""

    mode = "dagger"

    def __init__(
        self,
        spec: CyclicMpcSpec,
        cfg: DaggerConfig = DaggerConfig(),
        sim_params: physics.SimParams = physics.SimParams(),
        seed: int = 0,
        admm_cfg=None,
        ddp_cfg=None,
        admm_backend: str = "cuda",
        ik_backend: str = "cuda",
    ):
        """Rollouts and training run on ``spec.device`` (the card unless the
        spec was made with ``device="cpu"``) in float32, the rollouts with
        ``admm_backend`` and ``ik_backend`` as in ``rollout.rollout_mpc``."""
        self.spec = spec
        self.cfg = cfg
        self.sim_params = sim_params
        self.device = resolve_device(spec.device)
        self.admm_cfg, self.ddp_cfg = admm_cfg, ddp_cfg
        self.backends = dict(admm_backend=admm_backend, ik_backend=ik_backend)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.database = Database(cfg.database_size, goal_type=cfg.goal_type)
        p = spec.params
        self.rcfg = rollout.RolloutConfig(
            episode_length=cfg.episode_length,
            plan_freq=p.plan_freq,
            action_type=cfg.action_type,
            kp=p.kp,
            kd=p.kd,
            gait_id=GU.get_vc_gait_value(p.motion_name),
            gait_period=p.gait_period,
        )
        self.policy = None
        self._params = None
        self._settled = None

    def _f32(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _rollout_kw(self):
        return dict(admm_cfg=self.admm_cfg, ddp_cfg=self.ddp_cfg, **self.backends)

    def _mpc_rollout(self, qb, vb, vds, wds, st=None, ep_len=None):
        """One batched expert rollout call (per-episode start times ``st``),
        its records on the host."""
        rcfg = dataclasses.replace(self.rcfg, episode_length=ep_len or self.cfg.episode_length)
        return data_collection.host_records(rollout.rollout_mpc(
            self.spec, self.sim_params, rcfg, physics.SimState(qb, vb), vds, wds,
            start_time=0.0 if st is None else st, **self._rollout_kw()), _HOST_FIELDS)

    def _settle(self, q0, v0):
        """The settled standing start (1, nq), (1, nv) shared by every
        episode (see DaggerConfig.settle_ms)."""
        if self._settled is None:
            s0 = physics.SimState(q=self._f32(q0).reshape(1, -1), v=self._f32(v0).reshape(1, -1))
            if self.cfg.settle_ms > 0:
                p = self.spec.params
                s0 = rollout.settle_state(self.spec.model, tuple(self.spec.eff_frames),
                                          self.sim_params, s0, p.kp, p.kd, ms=self.cfg.settle_ms)
            self._settled = s0
        return self._settled

    @staticmethod
    def _tile(s0, n):
        return s0.q.expand(n, -1).contiguous(), s0.v.expand(n, -1).contiguous()

    # --- perturbed on-trajectory starts (safedagger_modified.py:744-815) ---

    def _perturbed_starts(self, res, vds, wds, quota: int, sample_replans: bool):
        """``quota`` contact-conditioned perturbed starts from the replanning
        points of the first gait cycle of each benchmark episode that lived
        through it (``res``: host records; ``vds``, ``wds``: its commands).
        Always exactly ``quota`` rows (the candidates are cycled, or drawn
        with ``self.rng`` where ``sample_replans``), so the gated batch keeps
        its shape across iterations; None when every benchmark episode fell
        within one gait cycle. The perturbations are one batched draw."""
        p = self.spec.params
        spp = self.rcfg.steps_per_plan
        n_cycle = max(1, int(round(p.gait_period / p.plan_freq)))
        n_cycle = min(n_cycle, res.states.shape[1] // spp)
        cands = [
            (b, r)
            for b in range(res.states.shape[0])
            if not (res.failed[b] and res.fail_step[b] < n_cycle * spp)
            for r in range(n_cycle)
        ]
        if not cands:
            return None
        if sample_replans:
            idx = self.rng.integers(0, len(cands), quota)
        else:
            idx = np.arange(quota) % len(cands)
        bs, rs = np.array([cands[int(i)] for i in idx]).T
        f = res.states[bs, rs * spp]  # features [v(18), base_wrt_foot(8), q[2:](17)]
        q_r = np.concatenate([np.zeros((quota, 2), f.dtype), f[:, 26:]], axis=1)  # xy = 0
        st = self._f32(rs * p.plan_freq)
        q0p, v0p, _ = perturbations.sample_perturbed_state(
            self.spec.model, self.spec.eff_frames, self.generator, self._f32(q_r),
            self._f32(f[:, :18]), G.in_stance(self.spec.gait, st),
            sigma_base_pos=self.cfg.sigma_base_pos,
            sigma_base_ori=self.cfg.sigma_base_ori,
            sigma_joint_pos=self.cfg.sigma_joint_pos,
            sigma_vel=self.cfg.sigma_vel,
        )
        return Starts(q0p, v0p, st, self._f32(np.asarray(vds)[bs]), self._f32(np.asarray(wds)[bs]))

    # --- phases ---

    def warmup(self, q0, v0):
        """Initial expert data and BC policy (reference SafeDagger.warmup,
        safedagger_modified.py:274-461): nominal (standing-start) MPC
        episodes for each warmup command, then perturbed-start episodes from
        every replanning point of the first gait cycle, so that the database
        BC warms up on is mostly recovery data, not a single nominal tube."""
        cfg = self.cfg
        n_cmd = cfg.rollouts_warmup or cfg.rollouts_per_iteration
        ep = cfg.episode_length_warmup or cfg.episode_length
        s0 = self._settle(q0, v0)
        vds, wds = self._sample_commands(n_cmd)
        bench = self._mpc_rollout(*self._tile(s0, n_cmd), vds, wds, ep_len=ep)
        sf_warm = (cfg.skip_failed_warmup if cfg.skip_failed_warmup is not None
                   else cfg.skip_failed_episodes)
        self._aggregate(bench, expert_only=False, skip_failed=sf_warm)
        p = self.spec.params
        n_cycle = max(1, int(round(p.gait_period / p.plan_freq)))
        quota = n_cmd * n_cycle * cfg.warmup_perturbations_per_replanning
        pert = self._perturbed_starts(bench, vds, wds, quota, sample_replans=False)
        if pert is not None:
            res = self._mpc_rollout(pert.q, pert.v, pert.v_des, pert.w_des, st=pert.st, ep_len=ep)
            self._aggregate(res, expert_only=False, skip_failed=sf_warm)
        self._train(warmup=True)

    def _sample_commands(self, B):
        """``B`` commands from ``self.rng``: v_des (B, 3), w_des (B,) numpy."""
        vds, wds = zip(*(GU.sample_velocities(self.rng, self.cfg.vx_range, self.cfg.vy_range,
                                              self.cfg.w_range) for _ in range(B)))
        return np.stack(vds), np.array(wds)

    def _train(self, warmup=False):
        """Retrain from the previous weights. Each call makes a new module,
        and a rollout captures the weights of the ``self.policy`` it is
        given for that call only (a graph lives as long as its rollout), so
        no rollout runs stale weights: the JAX package's bug of baking the
        warmup weights into a jitted rollout (its tests/test_drivers.py
        regression) has no counterpart here."""
        cfg = dataclasses.replace(
            self.cfg.bc, n_epoch=self.cfg.warmup_bc_epochs if warmup else self.cfg.bc.n_epoch)
        self.policy, report = train_policy(
            self.database, cfg, rng_seed=int(self.rng.integers(1 << 31)), params=self._params,
            device=self.device)
        self._params = self.policy.module.state_dict()
        return report

    # steps cut off the end of a failed episode's surviving prefix: the last
    # quarter second before a fall is committed-to-falling data (saturated
    # recovery torques at extreme states) that an imitation target should
    # not contain (the JAX package's round-4 finding: its database was
    # dominated by near-failure data). The reference skips failed episodes
    # entirely (data_collection.py:272-277); keeping the clean prefix keeps
    # the recovery-tube coverage its PyBullet expert gets for free.
    PREFIX_MARGIN = 250

    def _aggregate(self, res, expert_only=True, keep=None, skip_failed=None):
        """Append expert-labelled data from host records; failed episodes
        contribute their pre-failure prefix minus PREFIX_MARGIN (or nothing,
        with ``skip_failed``: reference data_collection.py:272-277), and for
        gated rollouts only MPC-controlled steps are kept (the DAgger label
        rule). ``keep``: optional (B,) bool mask dropping episodes entirely
        (ending-MPC rollouts whose gated episode already failed: their
        start state is frozen at the failure)."""
        if skip_failed is None:
            skip_failed = self.cfg.skip_failed_episodes
        added = 0
        for b in range(res.states.shape[0]):
            if keep is not None and not bool(keep[b]):
                continue
            if bool(res.failed[b]):
                if skip_failed:
                    continue
                T = int(res.fail_step[b]) - self.PREFIX_MARGIN
                if T < 100:
                    continue
            else:
                T = res.states.shape[1]
            mask = res.mpc_usage[b][:T] > 0 if expert_only else np.ones(T, bool)
            if mask.sum() == 0:
                continue
            self.database.append(res.states[b][:T][mask], res.actions[b][:T][mask],
                                 vc_goals=res.vc_goals[b][:T][mask])
            added += int(mask.sum())
        return added

    def _gated(self, starts: Starts):
        """The expert-gated rollout call of an iteration (subclasses)."""
        raise NotImplementedError

    # --- checkpoint / resume (the reference has none: a killed loop loses
    # its progress; here the driver's state is saved after every iteration
    # and a resumed loop continues exactly) ---

    def _extra_state(self) -> dict:
        """Subclass hook: extra arrays to persist (the Bayesian posterior)."""
        return {}

    def _load_extra_state(self, z):
        pass

    def save_checkpoint(self, ckpt_dir: str, iteration: int, logs: list):
        """The driver's state in ``ckpt_dir``: ``database.npz``, ``policy/``,
        ``driver_state.npz`` (the torch generator and the subclass's arrays)
        and ``state.json`` (mode, next iteration, logs, the numpy generator),
        the last written through a temporary file and a rename."""
        from ..utils import checkpoint as CK

        os.makedirs(ckpt_dir, exist_ok=True)
        self.database.save(os.path.join(ckpt_dir, "database.npz"))
        if self.policy is not None:
            CK.save_policy(self.policy, os.path.join(ckpt_dir, "policy"))
        np.savez(os.path.join(ckpt_dir, "driver_state.npz"),
                 generator=self.generator.get_state().numpy(), **self._extra_state())
        state = {
            "mode": self.mode,
            "next_iteration": iteration,
            "logs": logs,
            "rng_state": self.rng.bit_generator.state,
        }
        tmp = os.path.join(ckpt_dir, "state.json.tmp")
        with open(tmp, "w") as fh:
            json.dump(state, fh)
        os.replace(tmp, os.path.join(ckpt_dir, "state.json"))

    def load_checkpoint(self, ckpt_dir: str):
        """Restore the driver's state; returns (next_iteration, logs)."""
        from ..utils import checkpoint as CK

        with open(os.path.join(ckpt_dir, "state.json")) as fh:
            state = json.load(fh)
        if state["mode"] != self.mode:
            raise ValueError(f"checkpoint mode {state['mode']!r} != driver {self.mode!r}")
        self.database = Database(self.cfg.database_size, goal_type=self.cfg.goal_type)
        self.database.load_saved_database(os.path.join(ckpt_dir, "database.npz"))
        pol_dir = os.path.join(ckpt_dir, "policy")
        if os.path.exists(os.path.join(pol_dir, "meta.json")):
            self.policy = CK.load_policy(pol_dir, device=self.device)
            self._params = self.policy.module.state_dict()
        with np.load(os.path.join(ckpt_dir, "driver_state.npz"), allow_pickle=False) as z:
            self.generator.set_state(torch.as_tensor(z["generator"]))
            self._load_extra_state(z)
        self.rng.bit_generator.state = state["rng_state"]
        return state["next_iteration"], state["logs"]

    def run(self, q0, v0, checkpoint_dir: str | None = None, resume: bool = False,
            eval_hook=None):
        """The full loop: warmup, then ``n_iterations`` iterations
        (safedagger_modified.py:464-900). With ``checkpoint_dir`` the driver's
        state is saved after the warmup and after every iteration;
        ``resume=True`` continues from the last one there (and runs from the
        start where there is none). ``eval_hook(driver) -> dict`` (optional)
        is called after warmup and after every iteration's training, the
        reference's per-iteration eval slot (safedagger_modified.py:491-516);
        its dict joins that iteration's log entry."""
        start_it, logs = 0, []
        if resume and checkpoint_dir and os.path.exists(
                os.path.join(checkpoint_dir, "state.json")):
            start_it, logs = self.load_checkpoint(checkpoint_dir)
        else:
            self.warmup(q0, v0)
            if eval_hook is not None:
                logs.append({"iteration": "warmup", **eval_hook(self)})
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, 0, logs)
        s0 = self._settle(q0, v0)
        for it in range(start_it, self.cfg.n_iterations):
            entry = self.iteration(it, s0)
            if eval_hook is not None:
                entry.update(eval_hook(self))
            logs.append(entry)
            if checkpoint_dir:
                self.save_checkpoint(checkpoint_dir, it + 1, logs)
        return logs

    def iteration(self, it: int, s0: physics.SimState) -> dict:
        """One iteration from the settled start ``s0``: benchmark MPC
        episodes, gated episodes from perturbed starts on their
        trajectories, ending MPC episodes from the gated episodes' final
        states, aggregation, BC. Returns the iteration's log entry."""
        cfg = self.cfg
        n_cmd = cfg.rollouts_per_iteration
        vds, wds = self._sample_commands(n_cmd)

        # benchmark MPC episodes give the nominal trajectories the perturbed
        # gated starts ride on (safedagger_modified.py:700-815); their data
        # is NOT aggregated (reference parity: only warmup and
        # expert-labelled segments enter the database)
        bench = self._mpc_rollout(*self._tile(s0, n_cmd), vds, wds)
        quota = n_cmd * cfg.num_replannings * cfg.num_perturbations
        pert = self._perturbed_starts(bench, vds, wds, quota, sample_replans=True)
        if pert is None:
            # every benchmark fell within one gait cycle: settled standing
            # starts, so that the iteration still collects
            rep = np.arange(quota) % n_cmd
            pert = Starts(*self._tile(s0, quota), self._f32(np.zeros(quota)),
                          self._f32(vds[rep]), self._f32(wds[rep]))
        res = self._gated(pert)
        added = self._aggregate(res)

        # ending MPC rollouts from each gated episode's final state
        # (reference ending_mpc_rollout_episode_length block,
        # safedagger_modified.py:871-886): fresh expert data wherever the
        # policy dragged the state
        added_end = 0
        if cfg.ending_mpc_rollout_ms > 0:
            res_end = self._mpc_rollout(
                res.final_state.q, res.final_state.v, pert.v_des, pert.w_des,
                st=pert.st + cfg.episode_length * self.rcfg.sim_dt,
                ep_len=cfg.ending_mpc_rollout_ms)
            added_end = self._aggregate(res_end, expert_only=False, keep=~res.failed)

        report = self._train()
        return {
            "iteration": it,
            "datapoints_added": added + added_end,
            "datapoints_ending_mpc": added_end,
            "database_size": len(self.database),
            "train_loss_first": report.train_losses[0],
            "train_loss": report.train_losses[-1],
            "valid_loss": report.valid_losses[-1],
            "mpc_usage": float(np.mean(res.mpc_usage)),
            "failed_frac": float(np.mean(res.failed)),
            "bench_failed_frac": float(np.mean(bench.failed)),
        }


class Dagger(_IterativeDriver):
    """Classic DAgger (reference dagger_modified.py): the gated episodes hand
    each window to the MPC on a coin (``rollout.rollout_dagger``)."""

    mode = "dagger"

    def _gated(self, s: Starts):
        return data_collection.host_records(rollout.rollout_dagger(
            self.spec, self.sim_params, self.rcfg, physics.SimState(s.q, s.v), s.v_des, s.w_des,
            self.policy, generator=self.generator,
            mpc_usage_percentage=self.cfg.mpc_usage_percentage, start_time=s.st,
            **self._rollout_kw()), _HOST_FIELDS)


class SafeDagger(_IterativeDriver):
    """Safety-gated DAgger (reference safedagger_modified.py): the MPC takes
    over in the danger box (``rollout.rollout_safedagger``)."""

    mode = "safedagger"

    def _gated(self, s: Starts):
        return data_collection.host_records(rollout.rollout_safedagger(
            self.spec, self.sim_params, self.rcfg, physics.SimState(s.q, s.v), s.v_des, s.w_des,
            self.policy, num_steps_to_block=self.cfg.num_steps_to_block, start_time=s.st,
            **self._rollout_kw()), _HOST_FIELDS)


def weighted_vc_error(states, fail_step, failed, v_des, w_des):
    """Weighted velocity-tracking error of a rollout batch, the reference's
    formula (locosafedagger_modified.py:566-585):

        e = 0.4 * vx_mse^2 + 0.3 * vy_mse^2 + 0.3 * w_mse^2

    with the component MSEs of ``compute_vc_mse`` (utils.py:221-237) over the
    base-local velocity rows of the state features: state[:, 0:2] are (vx,
    vy) and state[:, 5] the yaw rate, the rows the reference reads. Failed
    episodes count their surviving prefix."""
    states = np.asarray(states)
    B, T = states.shape[0], states.shape[1]
    fail_step = np.asarray(fail_step)
    failed = np.asarray(failed)
    errs = []
    for b in range(B):
        Tb = int(fail_step[b]) if bool(failed[b]) else T
        if Tb < 2:
            errs.append(np.inf)
            continue
        vx_e, vy_e, w_e = GU.compute_vc_mse(
            np.asarray(v_des), float(w_des), states[b, :Tb, 0:2], states[b, :Tb, 5])
        errs.append(0.4 * vx_e**2 + 0.3 * vy_e**2 + 0.3 * w_e**2)
    return float(np.mean(errs))


class LocoSafeDagger(_IterativeDriver):
    """LocoSafeDagger (reference locosafedagger_modified.py:62-627,
    run_unperturbed :449-617): each iteration samples its training goal from
    a Bayesian posterior over the velocity grid, rolls out both the MPC
    expert and the current policy for that goal, aggregates whichever
    tracked it better by the weighted vx/vy/w error (:586-605), and updates
    the posterior with a Gaussian likelihood centred at the attempted goal
    (:357-384; the reference's own call site drops its error argument, so
    the error-scaled likelihood is opt-in, ``error_scaled_likelihood``)."""

    mode = "locosafedagger"

    def __init__(self, *args, grid_n: int = 30, error_scaled_likelihood: bool = False,
                 grid: bayes.GoalGrid | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        # an explicit grid lets a degenerate task envelope (e.g. vx only)
        # use singleton vy/w axes instead of n duplicated zero rows
        self.grid = grid if grid is not None else bayes.GoalGrid.make(
            self.cfg.vx_range, self.cfg.vy_range, self.cfg.w_range, n=grid_n)
        self.posterior = self.grid.uniform_prior()
        self.error_scaled_likelihood = error_scaled_likelihood

    def _extra_state(self):
        return {"posterior": np.asarray(self.posterior)}

    def _load_extra_state(self, z):
        if "posterior" in z.files:
            self.posterior = z["posterior"]

    def select_rollout(self, res_mpc, res_policy, v_des, w_des):
        """The reference's decision rule (locosafedagger_modified.py:586-605):
        aggregate the rollout with the smaller weighted tracking error.
        Returns ("mpc"|"policy", e_mpc, e_policy)."""
        e_mpc = weighted_vc_error(res_mpc.states, res_mpc.fail_step, res_mpc.failed, v_des,
                                  w_des)
        e_policy = weighted_vc_error(res_policy.states, res_policy.fail_step, res_policy.failed,
                                     v_des, w_des)
        return ("mpc" if e_mpc < e_policy else "policy"), e_mpc, e_policy

    def iteration(self, it: int, s0: physics.SimState) -> dict:
        goal = bayes.random_sample_from_distribution(self.rng, self.grid, self.posterior)
        v_des = np.array([goal[0], goal[1], 0.0])
        w_des = float(goal[2])
        B = self.cfg.rollouts_per_iteration
        qb, vb = self._tile(s0, B)
        vds, wds = np.tile(v_des, (B, 1)), np.full(B, w_des)

        # dual rollout: the nominal MPC expert AND the current policy
        res_mpc = self._mpc_rollout(qb, vb, vds, wds)
        res_policy = data_collection.host_records(rollout.rollout_policy(
            self.spec, self.sim_params, self.rcfg, physics.SimState(qb, vb), vds, wds,
            self.policy), _HOST_FIELDS)
        choice, e_mpc, e_policy = self.select_rollout(res_mpc, res_policy, v_des, w_des)
        added = self._aggregate(res_mpc if choice == "mpc" else res_policy, expert_only=False)
        err = min(e_mpc, e_policy)

        like = bayes.compute_likelihood(
            self.grid, goal, error=err if self.error_scaled_likelihood else None)
        self.posterior = bayes.update_goal_distribution(self.posterior, like)
        post = self.posterior
        entropy = float(-(post[post > 0] * np.log(post[post > 0])).sum())

        report = self._train()
        return {
            "iteration": it,
            "goal": goal.tolist(),
            "aggregated": choice,
            "e_mpc": e_mpc,
            "e_policy": e_policy,
            "tracking_error": err,
            # the posterior's concentration (the "Bayesian Updates" of
            # BUNMPC's name): its entropy after this iteration's update, below
            # the uniform prior's log(N) once any update has been applied
            "posterior_entropy": entropy,
            "datapoints_added": added,
            "database_size": len(self.database),
            "train_loss_first": report.train_losses[0],
            "train_loss": report.train_losses[-1],
            "valid_loss": report.valid_losses[-1],
        }
