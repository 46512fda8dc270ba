"""Recorded draws for the data-parallel tests: :class:`RecordingRng` wraps a
key of the port's draw interface (e.g. ``JaxRng``) and keeps every draw by
its place in the key tree, its kind and its shape; :class:`ReplayRng` gives
those draws back.  Spawned ranks import this module (numpy and torch only),
never JAX, so a rank replays JAX's numbers from the table.  A draw the
recorded run never made raises KeyError: a sharded run that asked for a
shape the one-process run did not has drawn differently."""

from typing import Dict, Tuple

import numpy as np
import torch


class ReplayRng:
    def __init__(self, table: Dict[Tuple, np.ndarray], path: Tuple = ()):
        self.table = table
        self.path = path

    def split(self, n):
        return [type(self)(self.table, self.path + (("s", n, i),))
                for i in range(n)]

    def fold_in(self, data):
        return type(self)(self.table, self.path + (("f", int(data)),))

    def _get(self, kind, shape, device):
        return torch.from_numpy(
            self.table[(self.path, kind, tuple(shape))].copy()).to(device)

    def normal(self, shape, device="cpu"):
        return self._get("n", shape, device)

    def uniform(self, shape, device="cpu"):
        return self._get("u", shape, device)

    def randint(self, shape, low, high, device="cpu"):
        return self._get(("i", low, high), shape, device)


class RecordingRng:
    def __init__(self, inner, table=None, path: Tuple = ()):
        self.inner = inner
        self.table = {} if table is None else table
        self.path = path

    def split(self, n):
        return [RecordingRng(k, self.table, self.path + (("s", n, i),))
                for i, k in enumerate(self.inner.split(n))]

    def fold_in(self, data):
        return RecordingRng(self.inner.fold_in(data), self.table,
                            self.path + (("f", int(data)),))

    def _keep(self, kind, shape, value):
        self.table[(self.path, kind, tuple(shape))] = value.cpu().numpy()
        return value

    def normal(self, shape, device="cpu"):
        return self._keep("n", shape, self.inner.normal(shape, device))

    def uniform(self, shape, device="cpu"):
        return self._keep("u", shape, self.inner.uniform(shape, device))

    def randint(self, shape, low, high, device="cpu"):
        return self._keep(("i", low, high), shape,
                          self.inner.randint(shape, low, high, device))

    def replay(self) -> ReplayRng:
        return ReplayRng(self.table)
