"""The benchmark's inputs, drawn from ``--seed`` with numpy.

Frozen copies of the recipes the port is driven with (its ``workload``
module): ``trot_states`` is bench.py's batch of mid-trot states, and
``command_draw`` the closed loop's commands from the reference's data
collection envelope. They live here so that a change to the program cannot
change the yardstick.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number >= 0) and a stream index:
    different streams of one seed draw independently."""
    return np.random.default_rng([int(seed), *stream])


def trot_states(n: int, gen: np.random.Generator, q0):
    """bench.py's inputs ``(q, v, t, v_des, w_des)`` as float64 arrays: q0
    with N(0, 0.05) joint offsets, N(0, 0.05) velocities, a uniform gait
    clock in [0, 0.5), commands v_des in [-0.3, 0.5] x [-0.2, 0.2] and yaw
    rates in [-0.3, 0.3]."""
    q0 = np.asarray(q0, np.float64)
    nj = q0.shape[0] - 7
    q = np.tile(q0, (n, 1))
    q[:, 7:] += gen.normal(size=(n, nj)) * 0.05
    v = gen.normal(size=(n, nj + 6)) * 0.05
    t = gen.uniform(0, 0.5, size=n)
    v_des = np.stack([gen.uniform(-0.3, 0.5, n), gen.uniform(-0.2, 0.2, n), np.zeros(n)], -1)
    w_des = gen.uniform(-0.3, 0.3, size=n)
    return q, v, t, v_des, w_des


def solve_batch(traffic: dict, q0, seed: int, k: int):
    """Batch ``k`` of a solve mix: ``trot_states`` of ``traffic["batch"]``
    problems about q0, from stream k of the seed. Where the mix has a
    ``lead``, problem 0 is q0 at rest at t=0 with the lead's command (the
    port's Go2 check, ``workload.go2_states``)."""
    q, v, t, v_des, w_des = trot_states(traffic["batch"], rng(seed, 0, k), q0)
    lead = traffic.get("lead")
    if lead is not None:
        q[0], v[0], t[0] = q0, 0.0, 0.0
        v_des[0], w_des[0] = lead["v_des"], lead["w_des"]
    return q, v, t, v_des, w_des


def command_draw(n: int, gen: np.random.Generator):
    """Commands of the reference envelope (the data-collection config's
    vx_range [0, 0.3], no lateral or yaw command): ``(v_des (n, 3), w_des
    (n,))`` as float64 arrays."""
    v_des = np.zeros((n, 3))
    v_des[:, 0] = gen.uniform(0.0, 0.3, n)
    return v_des, np.zeros(n)


def episode_commands(traffic: dict, seed: int, k: int):
    """The commands of episode ``k`` of a closed-loop mix."""
    return command_draw(traffic["batch"], rng(seed, 1, k))


def sample(seed: int, n_total: int, n: int) -> np.ndarray:
    """``n`` distinct indices of ``range(n_total)`` drawn from the seed (the
    problems or episodes the comparison reads), sorted."""
    return np.sort(rng(seed, 2).choice(n_total, size=min(n, n_total), replace=False))
