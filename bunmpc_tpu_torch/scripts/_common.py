"""What the ported analysis scripts share: their argument split, the two
robots' trot specs and simulators, and the attitude and height records of a
rollout."""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def split_args(argv):
    """``(positional, device)``: the JAX script's positional arguments in
    order, and the ``device=...`` option the port adds (None: the card)."""
    args = sys.argv[1:] if argv is None else list(argv)
    device = None
    pos = []
    for a in args:
        if a.startswith("device="):
            device = a.split("=", 1)[1]
        else:
            pos.append(a)
    return pos, device


def arg(pos, i, cast, default):
    return cast(pos[i]) if len(pos) > i else default


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def trot_spec(robot: str, device, params=None, warm_start_style=None):
    """``(spec, config class, trot table)`` of a robot's ``trot``: Solo12's
    with its defaults, the Go2's with its feet, thighs and foot size (as
    the JAX scripts build them). ``params`` replaces the table."""
    from ..mpc import kino_dyn as KD

    if robot == "solo12":
        from ..mpc.motions.solo12_cyclic import trot
        from ..robots.solo12 import Solo12Config as C

        kw = {}
    else:
        from ..mpc.motions.go2_cyclic import trot
        from ..robots.go2 import Go2Config as C

        kw = dict(eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
                  foot_size=C.foot_size)
    p = trot if params is None else params
    spec = KD.make_cyclic_spec(C.load_model(), p, C.q0(), warm_start_style=warm_start_style,
                               device=device, **kw)
    return spec, C, trot


def host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def attitude(states, nv: int):
    """``(rpy, z, vx)`` of rollout records (..., T, 43): roll-pitch-yaw from
    the base quaternion, the base height and the forward velocity, as numpy
    arrays (the features are [v(nv), base_wrt_foot(8), q[2:]])."""
    from ..utils.quat import quat_to_rot, rot_to_rpy

    states = torch.as_tensor(states)
    rpy = rot_to_rpy(quat_to_rot(states[..., nv + 9:nv + 13]))
    return host(rpy), host(states[..., nv + 8]), host(states[..., 0])


def checkpoint_dir(out: str) -> str:
    """The checkpoint directory of a demo writing ``out``: ``.ckpt_torch_<stem>``
    at the repository's root, the stem without its ``torch_`` prefix (so a
    run of the port never resumes a checkpoint of the JAX package's
    ``.ckpt_<stem>``)."""
    stem = os.path.splitext(os.path.basename(out))[0]
    stem = stem[len("torch_"):] if stem.startswith("torch_") else stem
    return os.path.join(repo_root(), f".ckpt_torch_{stem}")
