"""JAX's threefry2x32 draws in plain PyTorch, bit for bit.

whisper_tpu samples with `jax.random` from raw uint32 key pairs that it
derives on the host (api.window_rng): `split` to advance a key,
`categorical` (argmax of logits + Gumbel noise) to draw a token.  Sampled
windows can equal the reference's only if the port draws the same numbers
from the same keys, so this module computes JAX's functions on tensors, on
the device of the logits: the same bits on the CPU and on the card.

It encodes JAX's partitionable threefry (`jax_threefry_partitionable`
True, JAX's default since 0.5; THREEFRY_PARTITIONABLE below):
  * the counters of an n-element draw are the flat indices as 64-bit
    (hi, lo) pairs (jax/_src/prng.py `iota_2x32_shape`);
  * `split(key, n)` hashes counters 0..n-1 and stacks the two output
    words as the new keys (`_threefry_split_foldlike`);
  * 32-bit random bits are the xor of the two output words
    (`_threefry_random_bits_partitionable`).
`uniform` fills the mantissa of a float in [1, 2) from the top 23 bits
(jax/_src/random.py `_uniform`), `gumbel` is the "low" mode,
-log(-log(uniform(tiny, 1))), and `categorical` the Gumbel-max trick.

torch has no full uint32 arithmetic, so every word is an int64 holding
its 32 bits, masked after each add and rotation.  Keys are (..., 2)
tensors (or arrays) of those words; a leading key axis draws one
independent stream per key, as jax.vmap over the keys does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

THREEFRY_PARTITIONABLE = True   # the JAX semantics encoded here

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def as_key(key, device=None) -> torch.Tensor:
    """uint32 key words (numpy or torch, shape (..., 2)) -> int64 tensor
    of the same words on `device`."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device or key.device, dtype=torch.int64) & _MASK
    words = np.asarray(key, np.uint32).astype(np.int64)
    return torch.as_tensor(words, device=device)


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash, 20 rounds (jax/_src/prng.py
    `_threefry2x32_lowering`): key words k0, k1 and counter words x0, x1,
    int64 tensors of 32-bit values that broadcast -> the two output
    words (new tensors; the rounds run in place on them)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = torch.broadcast_tensors(x0 + ks[0], x1 + ks[1])
    x0, x1 = x0 & _MASK, x1 & _MASK
    hi = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            # x1 <- x0 ^ rotl(x1, r)
            torch.bitwise_left_shift(x1, r, out=hi).bitwise_and_(_MASK)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x0, x1


def _hash_counters(key: torch.Tensor, shape: tuple):
    """Threefry of each key in `key` (..., 2) over the flat indices of
    `shape` -> two words of shape key.shape[:-1] + shape."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    hi = lo >> 32                          # zero below 2^32 elements
    lo, hi = (c.reshape(shape) for c in (lo & _MASK, hi))
    expand = (slice(None),) * (key.dim() - 1) + (None,) * len(shape)
    return threefry2x32(key[..., 0][expand], key[..., 1][expand], hi, lo)


def split(key, num: int = 2) -> torch.Tensor:
    """jax.random.split: (..., 2) keys -> (..., num, 2) new keys."""
    key = as_key(key)
    w0, w1 = _hash_counters(key, (num,))
    return torch.stack([w0, w1], dim=-1)


def random_bits(key, shape: tuple) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2^32)): (..., 2) keys ->
    key.shape[:-1] + shape."""
    key = as_key(key)
    w0, w1 = _hash_counters(key, tuple(shape))
    return w0 ^ w1


def uniform(key, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform in float32: 23 random mantissa bits under the
    exponent of 1.0, minus one, then scaled into [minval, maxval) and
    held at or above minval, every step in f32."""
    bits = random_bits(key, shape)
    words = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = words.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape: tuple) -> torch.Tensor:
    """jax.random.gumbel, mode "low", float32."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0)))


def _noisy_logits(key, logits: torch.Tensor, shape):
    key = as_key(key, logits.device)
    per_key = key.dim() - 1
    batch = tuple(logits.shape[per_key:-1])
    shape = batch if shape is None else tuple(shape)
    if shape[len(shape) - len(batch):] != batch:
        raise ValueError(f"categorical: shape {shape} does not end with the "
                         f"logits' batch shape {batch}")
    prefix = len(shape) - len(batch)
    noise = gumbel(key, shape + (logits.shape[-1],))
    return noise + logits.reshape(logits.shape[:per_key] + (1,) * prefix
                                  + logits.shape[per_key:])


def categorical(key, logits: torch.Tensor, shape: tuple | None = None):
    """jax.random.categorical(key, logits, axis=-1, shape): argmax over the
    last axis of logits + Gumbel noise.

    key (2,): one stream over the whole draw; `shape` must end with
    logits.shape[:-1] (its leading axes are independent draws), default
    logits.shape[:-1].  A key of shape (K, 2) with logits (K, ..., V) is
    jax.vmap of that over the keys: K streams, `shape` per key."""
    return torch.argmax(_noisy_logits(key, logits, shape), dim=-1)


def categorical_margin(key, logits: torch.Tensor,
                       shape: tuple | None = None) -> float:
    """The smallest lead of a winner over its runner-up (logits + Gumbel
    noise) among the draws of categorical(key, logits, shape).  Two
    computations whose logits and noise differ by less than half of it
    draw the same tokens."""
    top2 = torch.topk(_noisy_logits(key, logits, shape), 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())
