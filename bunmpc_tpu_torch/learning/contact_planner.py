"""Offline Raibert contact planner — the expert cc-goal generator.

Counterpart of ``bunmpc_tpu/learning/contact_planner.py`` (reference
``ContactPlanner``, examples/iterative_algorithm/contact_planner.py:9-257):
the *desired* long-horizon contact plan and contact schedule for commanded
velocities, which the cc-conditioned policy is trained and evaluated
against. One call plans a batch of episodes with the port's
``gait.create_cnt_plan`` over the episode-length horizon.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kin import algorithms as K
from ..mpc import gait as G
from ..mpc.kino_dyn import CyclicMpcSpec


class ContactPlanner:
    def __init__(self, spec: CyclicMpcSpec, sim_dt: float = 0.001):
        self.spec = spec
        self.sim_dt = sim_dt

    def get_raibert_contact_plan(self, q0, v0, v_des, w_des, episode_length, start_time):
        """(contact_planner.py:61-234) for a batch: ``q0`` (B, nq), ``v_des``
        (B, 3), ``w_des`` (B,) (tensors keep their device, anything else goes
        to the spec's). Returns ``(cnt_plan (B, horizon, n_eff, 4) [flag, x, y,
        z], swing (B, horizon, n_eff))`` as numpy arrays. The horizon uses the
        reference's x20 buffer formula (:129-130)."""
        p = self.spec.params
        horizon = int(
            20.0 * episode_length * self.sim_dt * p.gait_horizon * p.gait_period / p.gait_dt
        )
        device = q0.device if torch.is_tensor(q0) else self.spec.device
        q0 = torch.as_tensor(q0, device=device)
        dtype = q0.dtype if q0.is_floating_point() else torch.float64
        q0 = q0.to(dtype)
        B = q0.shape[0]
        model = self.spec.model
        plan, swing = G.create_cnt_plan(
            self.spec.gait,
            self.spec.planner,
            horizon,
            q0,
            torch.full((B,), float(start_time), dtype=dtype, device=device),
            torch.as_tensor(v_des, dtype=dtype, device=device),
            torch.as_tensor(w_des, dtype=dtype, device=device),
            K.com(model, q0),
            K.frame_positions(model, q0, self.spec.eff_frames),
        )
        cnt_plan = torch.cat([plan.cnt[..., None], plan.r], dim=-1)
        return cnt_plan.cpu().numpy(), swing.cpu().numpy()

    def get_switches(self, cnt_plan, start_step=0.0):
        """Swing->stance transitions of a batch of plans, time-ordered within
        each episode: ``(episode (N,), rows (N, 5) [ee, step, x, y, z])``; z
        hard-coded to 1e-3 like the reference (contact_planner.py:53)."""
        p = self.spec.params
        landed = (cnt_plan[:, 1:, :, 0] == 1) & (cnt_plan[:, :-1, :, 0] == 0)
        b, i, ee = np.nonzero(landed)  # ordered by episode, then knot, then foot
        i = i + 1
        step = start_step + i * p.gait_dt / self.sim_dt
        rows = np.stack([ee.astype(np.float64), step, cnt_plan[b, i, ee, 1],
                         cnt_plan[b, i, ee, 2], np.full(len(b), 1e-3)], axis=-1)
        return b, rows

    def get_contact_schedule(self, q0, v0, v_des, w_des, episode_length, start_time):
        """(contact_planner.py:236-257) for a batch: ``(schedule (B, n_eff,
        n_events, 4) [step, x, y, z], cnt_plan)``. Each foot's touchdowns in
        time order, padded to the batch's largest count by repeating the
        foot's last touchdown, so that ``rollout.cc_goal_fn``'s search picks
        the row it picks on the foot's own events (a foot with none keeps
        zero rows)."""
        cnt_plan, _ = self.get_raibert_contact_plan(
            q0, v0, v_des, w_des, episode_length, start_time
        )
        B, ne = cnt_plan.shape[0], self.spec.n_eff
        b, rows = self.get_switches(cnt_plan, start_time / self.sim_dt)
        group = b * ne + rows[:, 0].astype(np.int64)
        order = np.argsort(group, kind="stable")  # keeps time order within a foot
        counts = np.bincount(group, minlength=B * ne)
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(order)) - first[group[order]]
        n_events = max(int(counts.max(initial=0)), 1)
        events = np.zeros((B * ne, n_events, 4))
        events[group[order], rank] = rows[order, 1:5]
        pad = np.minimum(np.arange(n_events)[None, :], np.maximum(counts, 1)[:, None] - 1)
        schedule = np.take_along_axis(events, pad[..., None], axis=1)
        return schedule.reshape(B, ne, n_events, 4), cnt_plan
