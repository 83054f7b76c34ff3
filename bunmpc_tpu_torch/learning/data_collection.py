"""BC dataset generation: the data-collection loop.

Counterpart of ``bunmpc_tpu/learning/data_collection.py`` (reference
``DataCollection``, examples/iterative_algorithm/data_collection.py:34-288):
per iteration, sample a velocity command, roll out a nominal (benchmark) MPC
episode, then roll out one batch of contact-conditioned perturbed MPC
episodes from states along the first gait cycle, and append the successful
episodes to the replay database with their vc and cc goals.

Both rollouts run on the card through ``sim.rollout.rollout_mpc`` (K1 and K2
once per window with the default "cuda" backends); the host samples the
command, copies each call's records once and assembles the goals.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mpc import gait as G
from ..mpc.kino_dyn import CyclicMpcSpec, resolve_device
from ..sim import physics, rollout
from . import goals as GU
from . import perturbations
from .database import Database

# the records _append_rollouts reads, copied to the host once per rollout call
_HOST_FIELDS = ("states", "actions", "vc_goals", "com", "in_contact", "contact_pos", "failed")


@dataclasses.dataclass
class DataCollectionConfig:
    """Reference defaults from cfgs/data_collection_config.yaml."""

    episode_length: int = 3000
    n_iteration: int = 5
    num_perturbations_per_replanning: int = 4
    goal_horizon: int = 1
    vx_range: tuple = (-0.3, 0.5)
    vy_range: tuple = (-0.2, 0.2)
    w_range: tuple = (-0.3, 0.3)
    action_type: str = "pd_target"
    database_size: int = 1_000_000
    sigma_base_pos: float = 0.1
    sigma_base_ori: float = 0.3
    sigma_joint_pos: float = 0.2
    sigma_vel: float = 0.1


def host_records(res: rollout.RolloutResult, fields=_HOST_FIELDS) -> rollout.RolloutResult:
    """The records ``fields`` (by default those ``DataCollection._append_rollouts``
    reads) as numpy arrays, one copy per field, and the final state on the
    device, cloned (a later rollout may start from it); the other fields
    are None."""
    out = {f: getattr(res, f).cpu().numpy() if f in fields else None
           for f in rollout.RolloutResult._fields}
    out["final_state"] = physics.SimState(res.final_state.q.clone(), res.final_state.v.clone())
    return rollout.RolloutResult(**out)


class DataCollection:
    def __init__(
        self,
        spec: CyclicMpcSpec,
        cfg: DataCollectionConfig = DataCollectionConfig(),
        sim_params: physics.SimParams = physics.SimParams(),
        seed: int = 0,
        admm_cfg=None,
        ddp_cfg=None,
        admm_backend: str = "cuda",
        ik_backend: str = "cuda",
    ):
        """Rollouts run on ``spec.device`` (the card unless the spec was made
        with ``device="cpu"``) in float32, with ``admm_backend`` and
        ``ik_backend`` as in ``rollout.rollout_mpc``. The perturbations are
        drawn from a ``torch.Generator`` seeded with ``seed`` on that device,
        the commands from ``np.random.default_rng(seed)``."""
        self.spec = spec
        self.cfg = cfg
        self.sim_params = sim_params
        self.device = resolve_device(spec.device)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.database = Database(cfg.database_size, goal_type="cc")
        self.admm_cfg, self.ddp_cfg = admm_cfg, ddp_cfg
        self.backends = dict(admm_backend=admm_backend, ik_backend=ik_backend)

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

    def _rollout(self, q, v, v_des, w_des):
        return rollout.rollout_mpc(
            self.spec, self.sim_params, self.rcfg, physics.SimState(q=q, v=v), v_des, w_des,
            admm_cfg=self.admm_cfg, ddp_cfg=self.ddp_cfg, **self.backends)

    def _append_rollouts(self, res):
        """Host-side postprocessing of records held as numpy arrays: build cc
        goals from each rollout's measured contact events and append
        successful episodes (data_collection.py:272-277 skips failed ones)."""
        n_eff = self.spec.n_eff
        B = res.states.shape[0]
        added = 0
        for b in range(B):
            if bool(res.failed[b]):
                continue
            states = np.asarray(res.states[b])
            actions = np.asarray(res.actions[b])
            vc = np.asarray(res.vc_goals[b])
            events = GU.contact_events_from_rollout(
                np.asarray(res.in_contact[b]), np.asarray(res.contact_pos[b])
            )
            if len(events) == 0:
                continue
            schedule = GU.construct_contact_schedule(events, n_eff)
            cc = GU.construct_cc_goal(
                self.cfg.episode_length,
                n_eff,
                schedule,
                np.asarray(res.com[b]),
                goal_horizon=self.cfg.goal_horizon,
            )
            T = len(cc)
            if T == 0:
                continue
            self.database.append(states[:T], actions[:T], vc_goals=vc[:T], cc_goals=cc[:T])
            added += T
        return added

    def run_iteration(self, q0, v0):
        """One data-collection iteration (data_collection.py:129-277) from the
        nominal state ``(q0 (nq,), v0 (nv,))``: the benchmark rollout (B=1),
        then ``num_replanning x num_perturbations_per_replanning`` perturbed
        rollouts in one batch, from the replanning points of the benchmark's
        first gait cycle (10 for the trot; as many as the episode has windows
        where it is shorter)."""
        cfg = self.cfg
        p = self.spec.params
        f32 = dict(dtype=torch.float32, device=self.device)
        v_des, w_des = GU.sample_velocities(self.rng, cfg.vx_range, cfg.vy_range, cfg.w_range)

        # --- benchmark MPC rollout (batch of 1) ---
        q0t = torch.as_tensor(q0, **f32).reshape(1, -1)
        v0t = torch.as_tensor(v0, **f32).reshape(1, -1)
        vdt = torch.as_tensor(v_des, **f32)[None]
        wdt = torch.full((1,), float(w_des), **f32)
        bench = host_records(self._rollout(q0t, v0t, vdt, wdt))
        added = self._append_rollouts(bench)

        # the nominal (q, v) at each replanning point of one gait cycle, from
        # the logged features [v(18), base_wrt_foot(8), q[2:](17)]: q = [0, 0, q[2:]];
        # an episode shorter than a gait cycle has fewer (the JAX package's
        # DataCollection raises IndexError there)
        num_replanning = min(int(p.gait_period / p.plan_freq), self.rcfg.n_windows)
        feat = bench.states[0, np.arange(num_replanning) * self.rcfg.steps_per_plan]
        q_r = np.concatenate([np.zeros((num_replanning, 2), np.float32), feat[:, 26:]], axis=1)
        v_r = feat[:, :18]
        # contact flags at each replanning time from the gait phase
        per_replan_t = torch.as_tensor(np.arange(num_replanning) * p.plan_freq, **f32)
        cnt_flags = G.in_stance(self.spec.gait, per_replan_t)

        # --- perturbed rollouts, all in one batch ---
        npert = cfg.num_perturbations_per_replanning
        B = num_replanning * npert
        qb, vb, _ = perturbations.sample_perturbed_state(
            self.spec.model,
            self.spec.eff_frames,
            self.generator,
            torch.as_tensor(q_r, **f32).repeat_interleave(npert, dim=0),
            torch.as_tensor(v_r, **f32).repeat_interleave(npert, dim=0),
            cnt_flags.repeat_interleave(npert, dim=0),
            sigma_base_pos=cfg.sigma_base_pos,
            sigma_base_ori=cfg.sigma_base_ori,
            sigma_joint_pos=cfg.sigma_joint_pos,
            sigma_vel=cfg.sigma_vel,
        )
        res = host_records(self._rollout(qb, vb, vdt.expand(B, -1), wdt.expand(B)))
        added += self._append_rollouts(res)
        return {"v_des": v_des, "w_des": w_des, "datapoints_added": added,
                "database_size": len(self.database)}

    def run(self, q0, v0, save_path: str | None = None):
        """``n_iteration`` iterations; with ``save_path``, a snapshot of the
        database after each, ``save_path/database_<rows>.npz`` (the JAX
        package writes the same arrays as ``.hdf5``)."""
        logs = []
        for it in range(self.cfg.n_iteration):
            log = self.run_iteration(q0, v0)
            logs.append(log)
            if save_path is not None:
                self.database.save(f"{save_path}/database_{len(self.database)}.npz")
        return logs
