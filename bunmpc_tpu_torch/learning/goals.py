"""Goal construction, contact schedules, and command sampling utilities.

Copy of ``bunmpc_tpu/learning/goals.py`` (reference
examples/iterative_algorithm/utils.py:36-289). Host-side numpy: goal
construction runs on logged rollout records between device phases.
"""

from __future__ import annotations

import numpy as np

GAIT_VALUES = {"trot": 1.0, "trot_sim": 1.0, "jump": 2.0, "bound": 3.0}


def get_vc_gait_value(gait: str) -> float:
    """(utils.py:268-289)"""
    return GAIT_VALUES.get(gait, 0.0)


def get_phase_percentage(sim_step, sim_dt, gait_period):
    """(utils.py:253-266)"""
    return ((sim_step * sim_dt) % gait_period) / gait_period


def sample_velocities(
    rng: np.random.Generator,
    vx_range,
    vy_range,
    w_range,
    dist: str = "uniform",
):
    """Command sampling (utils.py:141-185): uniform or normal v_des (z=0),
    uniform |w| with random sign."""
    if dist == "uniform":
        v_des = np.array(
            [rng.uniform(vx_range[0], vx_range[1]), rng.uniform(vy_range[0], vy_range[1]), 0.0]
        )
    elif dist == "normal":
        v_des = np.array(
            [rng.normal(loc=vx_range[1], scale=vx_range[1] / 4), rng.normal(0, vy_range[1]), 0.0]
        )
    else:
        raise ValueError(dist)
    w_des = rng.uniform(w_range[0], w_range[1])
    if rng.uniform() < 0.5:
        w_des = -w_des
    return v_des, w_des


def contact_events_from_rollout(in_contact: np.ndarray, contact_pos: np.ndarray):
    """Detect touchdown events in a rollout log: steps where a foot enters
    contact (reference new_ee_contact, simulation.py:299-314). Returns an
    array [ee, step, x, y, z] per event, time-ordered."""
    T, ne = in_contact.shape
    prev = np.concatenate([np.zeros((1, ne), bool), in_contact[:-1].astype(bool)], axis=0)
    events = []
    for t in range(1, T):
        for ee in range(ne):
            if in_contact[t, ee] and not prev[t, ee]:
                events.append([ee, t, *contact_pos[t, ee]])
    return np.asarray(events) if events else np.zeros((0, 5))


def construct_contact_schedule(new_contact_pos: np.ndarray, n_eff: int):
    """Per-foot schedule [n_eff, n_events, (step, x, y, z)]
    (utils.py:104-120)."""
    out = np.zeros((n_eff, max(len(new_contact_pos), 1), 4))
    ee_index = np.zeros(n_eff, int)
    for row in new_contact_pos:
        ee = int(row[0])
        out[ee, ee_index[ee]] = row[1:5]
        ee_index[ee] += 1
    return out


def ee_contact_index(time, ee_schedule_times):
    """Index of the next contact switch (utils.py:86-102): one past the
    first ``sw`` with ``times[sw] <= time < times[sw + 1]``, 0 where there is
    none. ``time`` may be an array of steps."""
    times = np.asarray(ee_schedule_times)
    t = np.asarray(time)[..., None]
    hit = (times[:-1] <= t) & (t < times[1:])
    return np.where(hit.any(-1), hit.argmax(-1) + 1, 0)


def construct_cc_goal(
    episode_length: int,
    n_eff: int,
    contact_schedule: np.ndarray,
    com: np.ndarray,
    goal_horizon: int = 1,
    sim_dt: float = 0.001,
    start_step: int = 0,
):
    """Contact-conditioned goal [time-to-contact, dx, dy] per foot per horizon
    slot (utils.py:36-84). Note the reference overrides sim_dt=1.0 inside
    base_wrt_goal so 'time' is in steps — preserved. All steps of a foot at
    once: the JAX package's per-step loop, element for element."""
    end_time = episode_length
    for ee in range(n_eff):
        end_time = int(min(end_time, np.max(contact_schedule[ee, :, 0])))
    if end_time <= start_step:
        return np.zeros((0, 3 * n_eff * goal_horizon))

    ts = np.arange(start_step, end_time)
    goal = np.zeros((len(ts), 3 * n_eff * goal_horizon))
    last = contact_schedule.shape[1] - 1
    for ee in range(n_eff):
        nxt = ee_contact_index(ts, contact_schedule[ee, :, 0])
        for gh in range(goal_horizon):
            sched = contact_schedule[ee, np.minimum(nxt + gh, last)]  # (steps, 4)
            col = 3 * n_eff * gh + 3 * ee
            goal[:, col] = sched[:, 0] - ts  # steps to contact
            goal[:, col + 1 : col + 3] = com[: len(ts), :2] - sched[:, 1:3]
    return goal


def compute_vc_mse(des_v, des_w, actual_v, actual_w):
    """Velocity-tracking MSE (utils.py:221-237)."""
    vx_error = np.mean(np.square(actual_v[:, 0] - des_v[0]))
    vy_error = np.mean(np.square(actual_v[:, 1] - des_v[1]))
    w_error = np.mean(np.square(actual_w - des_w))
    return vx_error, vy_error, w_error


def estimated_com_trajectory(com0, v_des, end_time, sim_dt=0.001):
    """Straight-line CoM estimate used by the contact planner
    (utils.py:187-219); z set to 0."""
    steps = np.arange(end_time)[:, None] * sim_dt
    xy = np.round(com0[:2], 3)[None, :] + steps * np.asarray(v_des[:2])[None, :]
    return np.concatenate([xy, np.zeros((end_time, 1))], axis=-1)
