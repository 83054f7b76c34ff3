"""Solo12 acyclic motion definitions: forward jump, cartwheel, rearing, stand
(copy of ``bunmpc_tpu/mpc/motions/solo12_acyclic.py``).

Numeric twins of the reference acyclic motion files (reference
examples/motions/acyclic/{plan_jump,plan_cartwheel,rearing,stand}.py) — the
time-stamped segment tables consumed by ``mpc.acyclic``.
"""

from __future__ import annotations

import numpy as np

from .params import ACyclicMotionParams

_NV = 18
_NJ = 12
_Q0 = np.array(
    [0.0, 0.0, 0.25, 0.0, 0.0, 0.0, 1.0] + [0.0, 0.8, -1.6] * 2 + [0.0, -0.8, 1.6] * 2
)
_X0 = np.concatenate([_Q0, np.zeros(_NV)])


def _jump():
    """Forward jump (reference plan_jump.py:21-98)."""
    st, flight, T = 0.4, 0.3, 1.2
    dt = T / 30
    n_col = 25

    cnt = lambda c, t0, t1: [  # noqa: E731
        [c, 0.3946, 0.14695, 0.0, t0, t1],
        [c, 0.3946, -0.14695, 0.0, t0, t1],
        [c, 0.0054, 0.14695, 0.0, t0, t1],
        [c, 0.0054, -0.14695, 0.0, t0, t1],
    ]
    state_wt_1 = np.array(
        [1e-2, 1e-2, 1e-2] + [5.0, 5.0, 1e-2] + 4 * [1e1, 1e-1, 1e-1]
        + [0.0, 0.0, 1e-5] + [5.0, 5.0, 5.0] + 4 * [3.5, 3.5, 3.5]
    )
    state_wt_2 = np.array(
        [1e-2, 1e-2, 1e2] + [1e2, 1e2, 1e2] + 4 * [1e1, 1e2, 1e2]
        + [0.0, 0.0, 0.0] + [5.0, 5.0, 5.0] + 4 * [3.5, 3.5, 3.5]
    )
    ctrl_wt = np.array([0, 0, 0] + [1e-4] * 3 + [1e-4] * _NJ)
    t1 = st + flight
    return ACyclicMotionParams(
        robot_name="solo12",
        motion_name="jump_fwd",
        n_col=n_col,
        dt_arr=np.full(n_col, dt),
        plan_freq=[[0.3, 0, t1], [0.5, t1, T]],
        cnt_plan=[cnt(1.0, 0.0, st), cnt(0.0, st, t1), cnt(1.0, t1, T)],
        W_X=np.array([1e-5, 1e-5, 1e5, 1e-4, 1e-4, 1e-4, 3e4, 3e4, 3e4]),
        W_X_ter=10 * np.array([1e-5, 1e-5, 1e5, 1e2, 1e1, 1e2, 1e5, 1e5, 1e5]),
        W_F=np.array(4 * [5e0, 5e0, 7e0]),
        X_nom=[
            [0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0, 0.0, st],
            [0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0, st, t1],
            [0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0, t1, T],
        ],
        X_ter=np.array([0.2, 0, 0.2, 0, 0, 0, 0, 0.0, 0.0]),
        rho=7e4,
        bounds=[[-0.25, -0.25, 0.1, 0.25, 0.25, 0.25, 0, st],
                [-0.25, -0.25, 0.1, 0.25, 0.25, 0.3, st, T]],
        swing_wt=[
            [
                [1e2, 0.3946, 0.14695, 0.0, st + 0.25 * flight, st + 0.5 * flight],
                [1e2, 0.3946, -0.14695, 0.0, st + 0.25 * flight, st + 0.5 * flight],
                [1e2, 0.0054, 0.14695, 0.0, st + 0.25 * flight, st + 0.5 * flight],
                [1e2, 0.0054, -0.14695, 0.0, st + 0.25 * flight, st + 0.5 * flight],
            ]
        ],
        cent_wt=(5e1, 1e3),
        cnt_wt=5e4,
        state_wt=[np.hstack((state_wt_1, [0, t1])), np.hstack((state_wt_2, [t1, T]))],
        state_reg=[np.hstack((_X0, [0, t1])), np.hstack((_X0, [t1, T]))],
        state_scale=[[1e-3, 0, t1], [1e-3, t1, T]],
        ctrl_wt=[np.hstack((ctrl_wt, [0, t1])), np.hstack((ctrl_wt, [t1, T]))],
        ctrl_reg=[np.hstack((np.zeros(_NV), [0, t1])), np.hstack((np.zeros(_NV), [t1, T]))],
        ctrl_scale=[[1e-4, 0, t1], [1e-2, t1, T]],
        kp=[[0.0, 0, t1], [2.5, t1, T]],
        kd=[[0.01, 0, t1], [0.1, t1, T]],
    )


def _cartwheel():
    """Cartwheel (reference plan_cartwheel.py:20-97)."""
    st, flip, T = 0.4, 0.5, 1.2
    dt = 5e-2
    n_col = int(np.round(T / dt))
    t1 = st + flip

    front = lambda c, x: [c, x, 0.14695, 0.0]  # noqa: E731
    x_reg1 = _X0.copy()
    x_reg1[2] = 0.3
    x_reg2 = x_reg1.copy()
    x_reg2[3:7] = [0, 1, 0, 0]  # upside-down base
    x_reg2[7:13] = 2 * [0.0, -np.pi + 0.8, -1.6]
    x_reg2[13:19] = 2 * [0.0, -np.pi - 0.8, 1.6]
    state_wt_1 = np.array(
        [1e2, 0, 100] + [100, 0, 100] + 4 * [1e3, 50.0, 20]
        + [0.0] * 3 + [10, 10, 10] + [3.5] * _NJ
    )
    state_wt_2 = np.array(
        [1e2, 0, 1000.0] + [100, 100, 100] + 4 * [1e3, 1e2, 50]
        + [0.0] * 3 + [10, 10, 10] + [3.5] * _NJ
    )
    ctrl_wt = np.array([0, 0, 10] + [1, 1, 1] + [70.0] * _NJ)
    return ACyclicMotionParams(
        robot_name="solo12",
        motion_name="cartwheel",
        n_col=n_col,
        dt_arr=np.full(n_col, dt),
        plan_freq=[[0.6, 0, T], [1.0, T, T + 1.5]],
        cnt_plan=[
            [[1.0, 0.3946, 0.14695, 0.0, 0.0, st], [1.0, 0.3946, -0.14695, 0.0, 0.0, st],
             [1.0, 0.0054, 0.14695, 0.0, 0.0, st], [1.0, 0.0054, -0.14695, 0.0, 0.0, st]],
            [[1.0, 0.3946, 0.14695, 0.0, st, t1], [1.0, 0.3946, -0.14695, 0.0, st, t1],
             [0.0, 0.0054, 0.14695, 0.0, st, t1], [0.0, 0.0054, -0.14695, 0.0, st, t1]],
            [[1.0, 0.3946, 0.14695, 0.0, t1, T], [1.0, 0.3946, -0.14695, 0.0, t1, T],
             [1.0, 0.8054, 0.14695, 0.0, t1, T], [1.0, 0.8054, -0.14695, 0.0, t1, T]],
        ],
        W_X=np.array([1e-2, 1e-2, 1e5, 1e-2, 1e-2, 1e-4, 1e3, 1e3, 1e4]),
        W_X_ter=10 * np.array([1e-2, 1e-2, 1e5, 1e-2, 1e-2, 1e-4, 1e3, 1e4, 1e4]),
        W_F=np.array(4 * [1e1, 1e1, 2e0]),
        X_nom=[
            [0.2, 0, 0.2, 0, 0, 0, 0, 0.1, 0.0, 0, st],
            [0.4, 0, 0.3, 0, 0, 0, 0, 0.6, 0.0, st, t1],
            [0.6, 0, 0.2, 0, 0, 0, 0, 0.0, 0.0, t1, T],
        ],
        X_ter=np.array([0.2, 0, 0.2, 0, 0, 0, 0, 0.0, 0.0]),
        rho=5e4,
        bounds=[[-0.45, -0.45, 0.0, 0.45, 0.45, 0.3, 0, st],
                [-0.45, -0.45, 0.0, 0.45, 0.45, 0.45, st, T]],
        swing_wt=None,
        cent_wt=(1.0, 3e3),
        cnt_wt=1e4,
        state_wt=[np.hstack((state_wt_1, [0, t1])), np.hstack((state_wt_2, [t1, T]))],
        state_reg=[np.hstack((x_reg1, [0, t1])), np.hstack((x_reg2, [t1, T]))],
        state_scale=[[1e-2, 0, t1], [500 * 1e-2, t1, T]],
        ctrl_wt=[np.hstack((ctrl_wt, [0, T]))],
        ctrl_reg=[np.hstack((np.zeros(_NV), [0, T]))],
        ctrl_scale=[[7e-4, 0, T]],
        kp=[[5.5, 0, T]],
        kd=[[0.1, 0, T]],
    )


def _rearing():
    """Rearing on the hind legs (reference rearing.py:20-100)."""
    st, rear, T = 0.5, 0.4, 1.2
    dt = 0.05
    n_col = 20
    t1 = st + rear
    state_wt_1 = np.array(
        [1e-2, 1e-2, 1e-2] + [0, 0, 1.0] + 2 * [1e-3, 1e-3, 1e-3] + 2 * [1e1, 5e1, 5e1]
        + 3 * [0.0] + [0, 0, 1.0] + [0.5] * _NJ
    )
    state_wt_2 = np.array(
        [1e-2, 1e-2, 1e2] + [1e2, 1e2, 1e2] + 4 * [1e1, 1e2, 1e2]
        + [0.0, 0.0, 0.0] + [5.0, 5.0, 5.0] + 4 * [3.5, 3.5, 3.5]
    )
    ctrl_wt = np.array([0, 0, 10] + [1, 1, 1] + [10.0] * _NJ)
    return ACyclicMotionParams(
        robot_name="solo12",
        motion_name="rearing",
        n_col=n_col,
        dt_arr=np.full(n_col, dt),
        plan_freq=[[0.4, 0, t1], [0.4, t1, T]],
        cnt_plan=[
            [[1.0, 0.3946, 0.14695, 0.0, 0.0, st], [1.0, 0.3946, -0.14695, 0.0, 0.0, st],
             [1.0, 0.0054, 0.14695, 0.0, 0.0, st], [1.0, 0.0054, -0.14695, 0.0, 0.0, st]],
            [[0.0, 0.3946, 0.14695, 0.0, st, t1], [0.0, 0.3946, -0.14695, 0.0, st, t1],
             [1.0, 0.0054, 0.14695, 0.0, st, t1], [1.0, 0.0054, -0.14695, 0.0, st, t1]],
            [[1.0, 0.41, 0.14695, 0.0, t1, T], [1.0, 0.41, -0.14695, 0.0, t1, T],
             [1.0, 0.0054, 0.14695, 0.0, t1, T], [1.0, 0.0054, -0.14695, 0.0, t1, T]],
        ],
        W_X=np.array([1e3, 1e1, 1e5, 1e-4, 1e-4, 1e-4, 1e2, 5e3, 1e2]),
        W_X_ter=10 * np.array([1e3, 1e1, 1e5, 1e-1, 1e-1, 1e-1, 1e2, 1e4, 1e2]),
        W_F=np.array(4 * [1e1, 1e1, 1e0]),
        X_nom=[
            [0.2, 0, 0.22, 0, 0, 0, 0, -0.05, 0.0, 0.0, st],
            [0.18, 0, 0.28, 0, 0, 0, 0, -0.45, 0.0, st, t1],
            [0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0, t1, T],
        ],
        X_ter=np.array([0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0]),
        rho=5e4,
        bounds=[[-0.25, -0.25, 0.1, 0.25, 0.25, 0.25, 0, st],
                [-0.25, -0.25, 0.1, 0.25, 0.25, 0.4, st, t1],
                [-0.25, -0.25, 0.1, 0.25, 0.25, 0.25, t1, T]],
        swing_wt=[
            [
                [1e2, 0.4, 0.14695, 0.6, st + 0.25 * rear, st + 0.5 * rear],
                [1e2, 0.4, -0.14695, 0.3, st + 0.25 * rear, st + rear],
                [0.0, 0.0054, 0.14695, 0.0, st + 0.25 * rear, st + 0.5 * rear],
                [0.0, 0.0054, -0.14695, 0.0, st + 0.25 * rear, st + 0.5 * rear],
            ]
        ],
        cent_wt=(1e1, 5e1),
        cnt_wt=1e2,
        state_wt=[np.hstack((state_wt_1, [0, t1])), np.hstack((state_wt_2, [t1, T]))],
        state_reg=[np.hstack((_X0, [0, t1])), np.hstack((_X0, [t1, T]))],
        state_scale=[[1e-2, 0, t1], [1e-2, t1, T]],
        ctrl_wt=[np.hstack((ctrl_wt, [0, T]))],
        ctrl_reg=[np.hstack((np.zeros(_NV), [0, T]))],
        ctrl_scale=[[5e-4, 0, T]],
        kp=[[2.0, 0, T]],
        kd=[[0.1, 0, T]],
    )


def _stand():
    """Quiet standing (reference stand.py:20-80)."""
    T = 1.2
    n_col = 30
    dt = T / 30
    state_wt_1 = np.array(
        [1e-2, 1e-2, 1e2] + [5.0, 5.0, 5.0] + 4 * [1e2, 1e2, 1e2]
        + [0.0, 0.0, 0.0] + [5.0, 5.0, 5.0] + 4 * [3.5, 3.5, 3.5]
    )
    ctrl_wt = np.array([0, 0, 1] + [1, 1, 1] + [5.0] * _NJ)
    cnt = [
        [1.0, 0.3946, 0.14695, 0.0, 0.0, T],
        [1.0, 0.3946, -0.14695, 0.0, 0.0, T],
        [1.0, 0.0054, 0.14695, 0.0, 0.0, T],
        [1.0, 0.0054, -0.14695, 0.0, 0.0, T],
    ]
    return ACyclicMotionParams(
        robot_name="solo12",
        motion_name="stand",
        n_col=n_col,
        dt_arr=np.full(n_col, dt),
        plan_freq=[[0.4, 0, T]],
        cnt_plan=[cnt],
        W_X=np.array([1e-5, 1e-5, 1e5, 1e-4, 1e-4, 2e2, 3e4, 3e4, 3e4]),
        W_X_ter=10 * np.array([1e-5, 1e-5, 1e5, 1e-1, 1e-1, 2e2, 1e5, 1e5, 1e5]),
        W_F=np.array(4 * [1e1, 1e1, 1e1]),
        X_nom=[[0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0, 0.0, T]],
        X_ter=np.array([0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0]),
        rho=5e4,
        bounds=[[-0.25, -0.25, 0.1, 0.25, 0.25, 0.25, 0, T]],
        swing_wt=None,
        cent_wt=(1e1, 1e4),
        cnt_wt=1e1,
        state_wt=[np.hstack((state_wt_1, [0, T]))],
        state_reg=[np.hstack((_X0, [0, T]))],
        state_scale=[[1e-2, 0, T]],
        ctrl_wt=[np.hstack((ctrl_wt, [0, T]))],
        ctrl_reg=[np.hstack((np.zeros(_NV), [0, T]))],
        ctrl_scale=[[1e-4, 0, T]],
        kp=[[2.0, 0, T]],
        kd=[[0.1, 0, T]],
    )


def _hifive():
    """Hind-leg rear into a front-paw "hifive" hop (reference plan_hifive.py:21-103)."""
    st, rear, jt, T = 0.5, 0.4, 0.10, 1.4
    dt = 0.05
    n_col = 25
    t1 = st + rear  # front feet leave
    t2 = t1 + jt  # full flight ends
    state_wt_1 = np.array(
        [1e-2, 1e-2, 1e-2] + [0, 0, 1.0] + 2 * [1e-3, 1e-3, 1e-3] + 2 * [1e1, 5e1, 5e1]
        + 3 * [0.0] + [0, 0, 1.0] + [0.5] * _NJ
    )
    state_wt_2 = np.array(
        [1e-2, 1e-2, 1e2] + [1e2, 1e2, 1e2] + 4 * [1e1, 1e2, 1e2]
        + [0.0, 0.0, 0.0] + [5.0, 5.0, 5.0] + 4 * [3.5, 3.5, 3.5]
    )
    ctrl_wt = np.array([0, 0, 10] + [1, 1, 1] + [10.0] * _NJ)
    return ACyclicMotionParams(
        robot_name="solo12",
        motion_name="hifive",
        n_col=n_col,
        dt_arr=np.full(n_col, dt),
        plan_freq=[[1.4, 0, st], [1.4, st, t2], [0.05, t2, T]],
        cnt_plan=[
            [[1.0, 0.3946, 0.14695, 0.0, 0.0, st], [1.0, 0.3946, -0.14695, 0.0, 0.0, st],
             [1.0, 0.0054, 0.14695, 0.0, 0.0, st], [1.0, 0.0054, -0.14695, 0.0, 0.0, st]],
            [[0.0, 0.3946, 0.14695, 0.0, st, t1], [0.0, 0.3946, -0.14695, 0.0, st, t1],
             [1.0, 0.0054, 0.14695, 0.0, st, t1], [1.0, 0.0054, -0.14695, 0.0, st, t1]],
            [[0.0, 0.3946, 0.14695, 0.0, t1, t2], [0.0, 0.3946, -0.14695, 0.0, t1, t2],
             [0.0, 0.0054, 0.14695, 0.0, t1, t2], [0.0, 0.0054, -0.14695, 0.0, t1, t2]],
            [[1.0, 0.41, 0.14695, 0.0, t2, T], [1.0, 0.41, -0.14695, 0.0, t2, T],
             [1.0, -0.0054, 0.14695, 0.0, t2, T], [1.0, -0.0054, -0.14695, 0.0, t2, T]],
        ],
        W_X=np.array([1e3, 1e1, 1e2, 1e-4, 1e-4, 1e-4, 1e2, 5e3, 1e2]),
        W_X_ter=10 * np.array([1e3, 1e1, 1e5, 1e-1, 1e-1, 1e-1, 1e2, 1e4, 1e2]),
        W_F=np.array(4 * [1e1, 1e1, 5e-1]),
        X_nom=[
            [0.2, 0, 0.22, 0, 0, 0, 0, -0.05, 0.0, 0.0, st],
            [0.18, 0, 0.28, 0, 0, 0, 0, -0.45, 0.0, st, t1],
            [0.18, 0, 0.32, 0, 0, 0, 0, 0.0, 0.0, t1, t2],
            [0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0, t2, T],
        ],
        X_ter=np.array([0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0]),
        rho=5e4,
        bounds=[[-0.25, -0.25, 0.1, 0.25, 0.25, 0.25, 0, st],
                [-0.25, -0.25, 0.1, 0.25, 0.25, 0.4, st, t1],
                [-0.25, -0.25, 0.1, 0.25, 0.25, 0.25, t1, T]],
        swing_wt=[
            [
                [0e2, 0.55, 0.14695, 0.7, st + 0.4 * rear, st + 0.5 * rear],
                [0e2, 0.55, -0.14695, 0.7, st + 0.4 * rear, st + 0.5 * rear],
                [0.0, 0.0054, 0.14695, 0.0, st + 0.25 * rear, st + 0.5 * rear],
                [0.0, 0.0054, -0.14695, 0.0, st + 0.25 * rear, st + 0.5 * rear],
            ]
        ],
        cent_wt=(1e1, 1e2),
        cnt_wt=1e4,
        state_wt=[np.hstack((state_wt_1, [0, t1])), np.hstack((state_wt_2, [t1, T]))],
        state_reg=[np.hstack((_X0, [0, t1])), np.hstack((_X0, [t1, T]))],
        state_scale=[[1e-2, 0, t1], [1e-2, t1, T]],
        ctrl_wt=[np.hstack((ctrl_wt, [0, T]))],
        ctrl_reg=[np.hstack((np.zeros(_NV), [0, T]))],
        ctrl_scale=[[5e-4, 0, T]],
        kp=[[2.0, 0, T]],
        kd=[[0.1, 0, T]],
    )


def _rearing_jump():
    """Rear onto the hind legs, then a full jump (reference rearing_jump.py:22-105)."""
    st, rear, jt, T = 0.5, 0.4, 0.4, 1.4
    dt = 0.05
    n_col = 20
    t1 = st + rear
    t2 = t1 + jt
    state_wt_1 = np.array(
        [1e-2, 1e-2, 1e-2] + [0, 0, 1.0] + 2 * [1e-3, 1e-3, 1e-3] + 2 * [1e1, 5e1, 5e1]
        + 3 * [0.0] + [0, 0, 1.0] + [0.5] * _NJ
    )
    state_wt_2 = np.array(
        [1e-2, 1e-2, 1e2] + [1e2, 1e2, 1e2] + 4 * [1e1, 1e2, 1e2]
        + [0.0, 0.0, 0.0] + [5.0, 5.0, 5.0] + 4 * [3.5, 3.5, 3.5]
    )
    ctrl_wt = np.array([0, 0, 10] + [1, 1, 1] + [10.0] * _NJ)
    return ACyclicMotionParams(
        robot_name="solo12",
        motion_name="rearing_jump",
        n_col=n_col,
        dt_arr=np.full(n_col, dt),
        plan_freq=[[0.4, 0, t1], [0.4, t1, T]],
        cnt_plan=[
            [[1.0, 0.3946, 0.14695, 0.0, 0.0, st], [1.0, 0.3946, -0.14695, 0.0, 0.0, st],
             [1.0, 0.0054, 0.14695, 0.0, 0.0, st], [1.0, 0.0054, -0.14695, 0.0, 0.0, st]],
            [[0.0, 0.3946, 0.14695, 0.0, st, t1], [0.0, 0.3946, -0.14695, 0.0, st, t1],
             [1.0, 0.0054, 0.14695, 0.0, st, t1], [1.0, 0.0054, -0.14695, 0.0, st, t1]],
            [[0.0, 0.3946, 0.14695, 0.0, t1, t2], [0.0, 0.3946, -0.14695, 0.0, t1, t2],
             [0.0, 0.0054, 0.14695, 0.0, t1, t2], [0.0, 0.0054, -0.14695, 0.0, t1, t2]],
            [[1.0, 0.41, 0.14695, 0.0, t2, T], [1.0, 0.41, -0.14695, 0.0, t2, T],
             [1.0, 0.0054, 0.14695, 0.0, t2, T], [1.0, 0.0054, -0.14695, 0.0, t2, T]],
        ],
        W_X=np.array([1e3, 1e1, 1e5, 1e-4, 1e-4, 1e-4, 1e2, 5e3, 1e2]),
        W_X_ter=10 * np.array([1e3, 1e1, 1e5, 1e-1, 1e-1, 1e-1, 1e2, 1e4, 1e2]),
        W_F=np.array(4 * [1e1, 1e1, 1e0]),
        X_nom=[
            [0.2, 0, 0.22, 0, 0, 0, 0, -0.05, 0.0, 0.0, st],
            [0.18, 0, 0.28, 0, 0, 0, 0, -0.45, 0.0, st, t1],
            [0.23, 0, 0.30, 0, 0, 0, 0, 0.0, 0.0, t1, t2],
            [0.23, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0, t2, T],
        ],
        X_ter=np.array([0.2, 0, 0.22, 0, 0, 0, 0, 0.0, 0.0]),
        rho=5e4,
        # reference lists overlapping windows ([st,t1] then [st,t2]); with
        # last-match semantics (abstract_acyclic_gen.py:173-175, no break) the
        # wide window wins over [st,t1] — encoded here in the same order.
        bounds=[[-0.25, -0.25, 0.1, 0.25, 0.25, 0.25, 0, st],
                [-0.25, -0.25, 0.1, 0.25, 0.25, 0.4, st, t1],
                [-100.0, -100.0, 0.0, 100.0, 100.0, 0.7, st, t2],
                [-0.25, -0.25, 0.1, 0.25, 0.25, 0.25, t2, T]],
        swing_wt=[
            [
                [1e2, 0.4, 0.14695, 0.6, st + 0.25 * rear, st + 0.5 * rear],
                [1e2, 0.4, -0.14695, 0.3, st + 0.25 * rear, st + rear],
                [0.0, 0.0054, 0.14695, 0.0, st + 0.25 * rear, st + 0.5 * rear],
                [0.0, 0.0054, -0.14695, 0.0, st + 0.25 * rear, st + 0.5 * rear],
            ]
        ],
        cent_wt=(1e1, 5e1),
        cnt_wt=1e2,
        state_wt=[
            np.hstack((state_wt_1, [0, t1])),
            np.hstack((state_wt_1, [t1, t2])),
            np.hstack((state_wt_2, [t2, T])),
        ],
        state_reg=[np.hstack((_X0, [0, t1])), np.hstack((_X0, [t1, T]))],
        state_scale=[[1e-2, 0, t1], [1e-2, t1, T]],
        ctrl_wt=[np.hstack((ctrl_wt, [0, T]))],
        ctrl_reg=[np.hstack((np.zeros(_NV), [0, T]))],
        ctrl_scale=[[5e-4, 0, T]],
        kp=[[2.0, 0, T]],
        kd=[[0.1, 0, T]],
    )


jump_fwd = _jump()
cartwheel = _cartwheel()
rearing = _rearing()
stand = _stand()
hifive = _hifive()
rearing_jump = _rearing_jump()

MOTIONS = {
    "jump_fwd": jump_fwd,
    "cartwheel": cartwheel,
    "rearing": rearing,
    "stand": stand,
    "hifive": hifive,
    "rearing_jump": rearing_jump,
}
