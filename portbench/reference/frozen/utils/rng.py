"""Random draws shaped like JAX's key tree.

The JAX package threads ``jax.random`` keys: it splits a key, folds an
integer into it, and draws from a key, and a key drawn from twice gives the
same numbers twice (``gd_main_loss`` relies on that: its G and D routes
augment one fake with one draw).  :class:`Rng` keeps that structure on
torch: a node is a 63-bit seed, ``split`` and ``fold_in`` derive child seeds
by hashing, and each draw comes from a ``torch.Generator`` seeded with the
node's seed on the device asked for.  It cannot reproduce threefry's
numbers; a test that needs JAX's draws hands the port any object with the
same five methods (``split``, ``fold_in``, ``normal``, ``uniform``,
``randint``) backed by ``jax.random``.
"""

from __future__ import annotations

import hashlib
import zlib
from typing import List, Sequence

import torch

_SEED_MASK = (1 << 63) - 1


def name_fold(name: str) -> int:
    """The integer a layer name folds into a key (CRC32, process-stable):
    the JAX package's ``models/stylegan2.py::_name_fold``."""
    return zlib.crc32(name.encode()) % (2 ** 31)


def _mix(seed: int, *data: int) -> int:
    digest = hashlib.blake2b(repr((seed,) + data).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & _SEED_MASK


class Rng:
    """A key of the draw tree; draws are float32 (normal, uniform) or int64
    (randint) tensors on ``device``."""

    def __init__(self, seed: int):
        self.seed = int(seed) & _SEED_MASK

    @classmethod
    def from_generator(cls, gen: torch.Generator) -> "Rng":
        """A key drawn from ``gen`` (advancing it)."""
        return cls(int(torch.randint(0, 2 ** 62, (), generator=gen,
                                     device=gen.device)))

    def split(self, n: int) -> List["Rng"]:
        return [Rng(_mix(self.seed, 0, i)) for i in range(n)]

    def fold_in(self, data: int) -> "Rng":
        return Rng(_mix(self.seed, 1, int(data)))

    def _gen(self, device) -> torch.Generator:
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(self.seed)
        return gen

    def normal(self, shape: Sequence[int], device="cpu") -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._gen(device),
                           device=device)

    def uniform(self, shape: Sequence[int], device="cpu") -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._gen(device),
                          device=device)

    def randint(self, shape: Sequence[int], low: int, high: int,
                device="cpu") -> torch.Tensor:
        return torch.randint(low, high, tuple(shape),
                             generator=self._gen(device), device=device)
