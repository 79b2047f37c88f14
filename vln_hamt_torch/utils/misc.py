"""Small shared utilities (finetune_src/utils/misc.py parity), the port's
copy of ``vln_hamt_tpu/utils/misc.py``.

``apply_rng_impl`` deviates from the JAX package's: there the name picks
the PRNG that draws the dropout bits (``threefry2x32``, or the TPU's
hardware ``rbg``, whose bits are not stable across programs, so the JAX
replay update refuses it). The port has one set of streams under either
name: Philox on the card (the CPU's generator on the CPU) for the
dropout masks (``models/layers.py:DropoutRNG.masks``) and the attention
kernels' counter hash keyed by seeds from a CPU generator
(``DropoutRNG.seeds``). It has no cheaper hardware stream to switch to,
and its streams are replayable (``get_state`` / ``set_state``) under
either name, so the port's replay update takes ``rbg`` too. The name is
validated and recorded in the run's config; it changes no draw.
"""

from __future__ import annotations

import random

import numpy as np

#: the JAX package's accepted names and the canonical name of each
RNG_IMPLS = {"threefry2x32": "threefry2x32", "threefry": "threefry2x32",
             "rbg": "rbg", "unsafe_rbg": "unsafe_rbg"}


def set_seed(seed: int) -> None:
    """Host-side seeding (utils/misc.py:5-10). The device draws come from
    the agents' and trainers' own generators, not from global seeds."""
    random.seed(seed)
    np.random.seed(seed)


def apply_rng_impl(impl: str) -> str:
    """Validate a dropout-PRNG name of the JAX package (``cfg.train.
    rng_impl``, ``--rng_impl``) and return its canonical name: raises
    ``ValueError`` on any other. Every name maps to the port's one set of
    streams (module docstring), so nothing else changes."""
    if impl not in RNG_IMPLS:
        raise ValueError(f"unknown rng_impl {impl!r}; one of {sorted(RNG_IMPLS)}")
    return RNG_IMPLS[impl]


def length_mask(lengths, size: int) -> np.ndarray:
    """(B,) lengths -> (B, size) bool validity mask (utils/misc.py:12-17,
    inverted: True = valid)."""
    lengths = np.asarray(lengths)
    return np.arange(size)[None, :] < lengths[:, None]
