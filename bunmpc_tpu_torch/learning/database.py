"""Replay database: ring buffer + snapshots.

Copy of ``bunmpc_tpu/learning/database.py`` (reference
examples/iterative_algorithm/database.py:9-230): a fixed-capacity overwrite
ring over (states, vc_goals, cc_goals, actions) in preallocated numpy, with
the input normalization recomputed on append.

Snapshots choose their format by the path's suffix. ``.npz`` is the port's
own (a named deviation from the JAX package, which writes hdf5 alone): the
arrays and names of the hdf5 snapshot (``states``, ``actions`` and, where
the database holds them, ``vc_goals`` and ``cc_goals``), no pickled
objects, numpy only. Any other suffix is the JAX package's hdf5, which
needs h5py (imported where a snapshot is read or written) and raises
``RuntimeError`` without it.
"""

from __future__ import annotations

import numpy as np

_FIELDS = ("states", "actions", "vc_goals", "cc_goals")


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError("h5py unavailable: an hdf5 database snapshot needs it; save and "
                           "load the port's .npz snapshots instead") from e
    return h5py


def _is_npz(path: str) -> bool:
    return str(path).endswith(".npz")


class Database:
    def __init__(self, limit: int, goal_type: str = "cc", norm_input: bool = True):
        assert goal_type in ("vc", "cc"), "Goal type can only be vc or cc"
        self.limit = int(limit)
        self.length = 0
        self.start = 0
        self.goal_type = goal_type
        self.norm_input = norm_input
        self._states = None
        self._vc_goals = None
        self._cc_goals = None
        self._actions = None
        self.states_mean = None
        self.states_std = None
        self.goal_mean = 0.0
        self.goal_std = 1.0

    def __len__(self):
        return self.length

    def set_goal_type(self, goal_type: str):
        assert goal_type in ("vc", "cc")
        self.goal_type = goal_type
        self._recompute_stats()

    def _alloc(self, states, vc_goals, cc_goals, actions):
        self._states = np.zeros((self.limit, states.shape[-1]), np.float32)
        self._actions = np.zeros((self.limit, actions.shape[-1]), np.float32)
        if vc_goals is not None:
            self._vc_goals = np.zeros((self.limit, vc_goals.shape[-1]), np.float32)
        if cc_goals is not None:
            self._cc_goals = np.zeros((self.limit, cc_goals.shape[-1]), np.float32)

    def append(self, states, actions, vc_goals=None, cc_goals=None):
        """Ring append with overwrite (database.py:104-146)."""
        if vc_goals is None and cc_goals is None:
            raise ValueError("both vc_goals and cc_goals cant be empty!")
        states = np.asarray(states, np.float32)
        actions = np.asarray(actions, np.float32)
        n = len(states)
        if self._states is None:
            self._alloc(states, vc_goals, cc_goals, actions)
        idx = (self.start + self.length + np.arange(n)) % self.limit
        overflow = max(0, self.length + n - self.limit)
        self._states[idx] = states
        self._actions[idx] = actions
        if vc_goals is not None:
            self._vc_goals[idx] = np.asarray(vc_goals, np.float32)
        if cc_goals is not None:
            self._cc_goals[idx] = np.asarray(cc_goals, np.float32)
        self.length = min(self.length + n, self.limit)
        self.start = (self.start + overflow) % self.limit
        self._recompute_stats()

    def _valid(self, arr):
        if arr is None:
            return None
        idx = (self.start + np.arange(self.length)) % self.limit
        return arr[idx]

    @property
    def states(self):
        return self._valid(self._states)

    @property
    def actions(self):
        return self._valid(self._actions)

    @property
    def vc_goals(self):
        return self._valid(self._vc_goals)

    @property
    def cc_goals(self):
        return self._valid(self._cc_goals)

    def goals(self):
        return self.vc_goals if self.goal_type == "vc" else self.cc_goals

    def _recompute_stats(self):
        """Normalization payload (database.py:187-213): per-feature state
        mean/std; vc goals pass through unnormalized (phase already in [0,1]);
        cc goals normalized."""
        if self.length == 0:
            return
        s = self.states
        self.states_mean = s.mean(axis=0)
        self.states_std = s.std(axis=0) + 1e-8
        if self.goal_type == "cc" and self._cc_goals is not None:
            g = self.cc_goals
            self.goal_mean = g.mean(axis=0)
            self.goal_std = g.std(axis=0) + 1e-8
        else:
            self.goal_mean = 0.0
            self.goal_std = 1.0

    def get_database_mean_std(self):
        return [self.states_mean, self.states_std, self.goal_mean, self.goal_std]

    def xy(self):
        """Full normalized (x, y) supervision arrays."""
        s = self.states
        g = self.goals()
        if self.norm_input:
            s = (s - self.states_mean) / self.states_std
            g = (g - self.goal_mean) / self.goal_std
        return np.concatenate([s, g], axis=-1), self.actions

    def sample_batches(self, rng: np.random.Generator, batch_size: int, epochs: int = 1):
        """Shuffled mini-batch iterator (torch DataLoader twin)."""
        x, y = self.xy()
        n = (len(x) // batch_size) * batch_size
        for _ in range(epochs):
            perm = rng.permutation(len(x))[:n]
            for i in range(0, n, batch_size):
                sel = perm[i : i + batch_size]
                yield x[sel], y[sel]

    def save(self, path: str):
        """Snapshot of the valid rows in logical order (data_collection.py:
        109-113): ``.npz``, else hdf5."""
        arrays = {f: getattr(self, f) for f in _FIELDS if getattr(self, f) is not None}
        if _is_npz(path):
            with open(path, "wb") as fh:  # np.savez would append .npz to other names
                np.savez(fh, **arrays)
            return
        with _h5py().File(path, "w") as hf:
            for name, a in arrays.items():
                hf.create_dataset(name, data=a)

    def load_saved_database(self, filename: str):
        """Append a snapshot's rows (database.py:148-185)."""
        if _is_npz(filename):
            with np.load(filename, allow_pickle=False) as z:
                arrays = {f: z[f] for f in _FIELDS if f in z.files}
        else:
            with _h5py().File(filename, "r") as hf:
                arrays = {f: hf[f][:] for f in _FIELDS if f in hf}
        self.append(arrays["states"], arrays["actions"], vc_goals=arrays.get("vc_goals"),
                    cc_goals=arrays.get("cc_goals"))
