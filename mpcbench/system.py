"""The objects a configuration file describes, built on either side: the
program (``bunmpc_tpu_torch``, the system under test) or the plain
reference (``mpcbench.reference``, a frozen copy of the plain path). Both
packages have the same module layout, so one function builds either from the
same numbers.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np

PROGRAM = "bunmpc_tpu_torch"
REFERENCE = "mpcbench.reference"


def module(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def robot(pkg: str, config: dict):
    """The robot's config class (``load_model``, ``q0``, frame names)."""
    r = config["robot"]
    return getattr(module(pkg, r["module"]), r["class"])


def motion(pkg: str, table: dict):
    """A gait table of the configuration file as the package's
    ``BiconvexMotionParams``: lists become arrays or tuples, as declared."""
    P = module(pkg, "mpc.motions.params").BiconvexMotionParams
    kw = {}
    for f in dataclasses.fields(P):
        if f.name not in table:
            continue
        v = table[f.name]
        if isinstance(v, list):
            v = np.asarray(v, np.float64) if "ndarray" in str(f.type) else tuple(v)
        kw[f.name] = v
    return P(**kw)


def spec(pkg: str, config: dict, table: dict, device):
    """The cyclic MPC spec of the configuration's robot and ``table``."""
    C = robot(pkg, config)
    KD = module(pkg, "mpc.kino_dyn")
    s = KD.make_cyclic_spec(C.load_model(), motion(pkg, table), C.q0(),
                            eff_frames=tuple(C.eff_names), hip_frames=tuple(C.hip_names),
                            foot_size=C.foot_size, ik_hor_ratio=config["spec"]["ik_hor_ratio"],
                            device=device)
    if (s.horizon, s.ik_hor) != (config["horizon"], config["ik_horizon"]):
        raise ValueError(f"the gait gives horizon {s.horizon} and IK horizon {s.ik_hor}, the "
                         f"configuration states {config['horizon']} and {config['ik_horizon']}")
    return s


def admm_config(pkg: str, rho: float, settings: dict):
    """The ADMM settings: the kernel's config on the program's side, the
    plain solver's on the reference's (the same fields and defaults)."""
    if pkg == PROGRAM:
        return module(pkg, "solvers.cuda_admm").CudaAdmmConfig(rho=rho, **settings)
    return module(pkg, "solvers.biconvex").BiconvexConfig(rho=rho, **settings)


def ddp_config(pkg: str, settings: dict):
    kw = dict(settings)
    if "alphas" in kw:
        kw["alphas"] = tuple(kw["alphas"])
    return module(pkg, "solvers.ddp").DdpConfig(**kw)


def sim_params(pkg: str, contact: dict):
    """The simulator: the default ``SimParams`` with the given contact."""
    physics = module(pkg, "sim.physics")
    return physics.SimParams(contact=physics.ContactParams(**contact))
