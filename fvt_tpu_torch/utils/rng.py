"""The port's randomness policy (counterpart of ``fvt_tpu/utils/rng.py``).

Randomness is explicit: every consumer draws from a ``torch.Generator``
seeded from ``(seed, name, index)`` through the same process-independent
name hash as ``fvt_tpu`` (crc32), so adding a consumer never perturbs the
others and a run repeats bit for bit.  The bit streams are PyTorch's, not
JAX's: parity tests use dropout 0 or inject their own masks.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

MAX_SEED = 2 ** 32


def _stable_hash(name: str) -> int:
    """Process-independent string hash (Python's hash() is salted)."""
    return zlib.crc32(name.encode('utf-8'))


def derive_seed(seed: int, name: str = '', index: int = 0) -> int:
    """A 63-bit seed for the stream ``(seed, name, index)``."""
    ss = np.random.SeedSequence([seed % MAX_SEED,
                                 _stable_hash(name) % MAX_SEED,
                                 index % MAX_SEED])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, name: str = '', index: int = 0,
              device='cpu') -> torch.Generator:
    """A new generator on ``device`` for the stream
    ``(seed, name, index)``."""
    return torch.Generator(device=device).manual_seed(
        derive_seed(seed, name, index))


def np_rng(seed: int, name: str = '', index: int = 0) -> np.random.Generator:
    """Host-side numpy stream of the same naming (``fvt_tpu``'s
    ``np_rng``, bit for bit)."""
    ss = np.random.SeedSequence([seed % MAX_SEED,
                                 _stable_hash(name) % MAX_SEED,
                                 index % MAX_SEED])
    return np.random.default_rng(ss)


def epoch_seed(default_seed: int, counter: int) -> int:
    """The observable per-epoch derived seed (``fvt_tpu``'s
    ``epoch_seed``; upstream trainer.py:293-297)."""
    return int((default_seed + counter) % MAX_SEED)


def stable_shuffle(items: list, seed: int, rounds: int = 100) -> list:
    """Deterministic multi-round shuffle of the train window list
    (``fvt_tpu``'s ``stable_shuffle``, bit for bit): same list in, same
    order out for a given seed, no global RNG touched."""
    out = list(items)
    rng = np_rng(seed, 'stable_shuffle')
    for _ in range(rounds):
        rng.shuffle(out)
    return out
