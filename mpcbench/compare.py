"""The comparison that decides ``correct``: what the timed path produced
against the plain reference, number by number, each beside its limit.

A cell's limits are ``limits/<workload>.json``: each compared number's name
and its limit (``PERF.md`` gives the readings each was set from). A number
that is not finite, or is missing, fails.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# A problem has converged where its dynamics violation is under this (the
# port's converged_frac and the JAX package's).
CONVERGED = 1e-3

# The plan's fields each solve is compared on, by the stage that makes them:
# assembly (the contact plan), K1 (the centroidal trajectory, the forces,
# the scaled dual and the violation), K2 (the IK knots), and the 1 kHz
# interpolation of K1's forces and K2's knots.
PLAN_FIELDS = ("cnt_plan", "X_opt", "F_opt", "P_opt", "dyn_violation", "xs", "us", "xs_int",
               "us_int", "f_int")


def max_gap(a, b) -> float:
    """The largest |a - b|; infinite where either side is not finite."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    d = np.where(np.isfinite(d), d, np.inf)
    return float(d.max()) if d.size else 0.0


def plan_gaps(prog: dict, ref: dict) -> dict:
    """Each plan field's largest gap, the number of problems whose
    converged flag differs, and the number of problems whose two solves
    stopped one ADMM iteration apart (``prog`` and ``ref`` map field names,
    and ``admm_iters``, to arrays with the problems first).

    The contact plan and the flag are compared on every problem; the
    violation and the solvers' values on the problems the reference solves
    to tolerance, save those one iteration apart. A problem that runs to the
    ADMM's iteration cap stops wherever rounding leaves its iterate (the
    Go2's violations after the cap part by up to 2e-2), so only its flag can
    be held. The ADMM exits as soon as its violation is under the
    tolerance, so where it crosses at the threshold a rounding apart, the
    two plans differ by one step, within the solver's tolerance (about one
    problem in a few hundred on the Solo12, one in a hundred on the Go2).
    The count of such problems is itself compared, so that an exit shifted
    by one iteration on many problems cannot leave them all out."""
    conv_p = np.asarray(prog["dyn_violation"]) < CONVERGED
    conv_r = np.asarray(ref["dyn_violation"]) < CONVERGED
    one_apart = np.abs(np.asarray(prog["admm_iters"], np.float64)
                       - np.asarray(ref["admm_iters"], np.float64)) == 1
    out = {}
    for f in PLAN_FIELDS:
        r = slice(None) if f == "cnt_plan" else conv_r & ~one_apart
        out[f] = max_gap(np.asarray(prog[f])[r], np.asarray(ref[f])[r])
    out["converged_mismatch"] = float(np.sum(conv_p != conv_r))
    out["one_apart"] = float(np.sum(one_apart))
    return out


def load(workload: str) -> dict:
    """A cell's limits file: ``limits`` (each compared number's limit),
    the ``readings`` they were set from, and any settings the cell's
    comparison reads."""
    with open(os.path.join(HERE, "limits", f"{workload}.json")) as fh:
        return json.load(fh)


def load_limits(workload: str) -> dict:
    return load(workload)["limits"]


def judge(numbers: dict, limits: dict):
    """``(correct, checks)``: each limit's number beside it; correct where
    every number is finite and at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        v = float(v) if v is not None and math.isfinite(v) else math.inf
        checks[name] = {"value": v, "limit": float(limit)}
        ok &= v <= limit
    return ok, checks
