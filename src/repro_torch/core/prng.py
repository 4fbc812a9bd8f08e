"""Keyed, counter-based PRNG: threefry2x32 as JAX runs it by default.

The reference simulator draws every random number from ``jax.random``
with the ``threefry2x32`` implementation. This module reproduces the
functions the step calls — ``key``, ``split``, ``fold_in``, ``uniform``
and ``normal`` — word for word, so a port run sees the same uniforms as
the reference run. JAX has two counter schemes, chosen by its
``jax_threefry_partitionable`` flag; both are here (``partitionable``
argument, default True as in the JAX release the reference pins; the
committed x32 golden results were captured under the other one):

* a key is a ``(..., 2)`` tensor of uint32 words;
* ``split(key, n)``, partitionable: new key ``i`` is the two output
  words of counter pair ``(0, i)``; original: the output words of the
  pairs ``(i, n + i)`` concatenated and read two at a time;
* ``fold_in(key, d)`` hashes the single counter pair ``(0, d)``;
* ``random_bits(key, n)``: see ``counter_words``;
* ``uniform`` puts 23 random mantissa bits under the exponent of 1.0
  and subtracts 1 (values in [0, 1));
* ``normal`` maps a uniform on (-1, 1) through ``sqrt(2) * erfinv``,
  with the single-precision erfinv polynomial XLA uses (Giles 2010).
  About 99% of normals equal the reference's bit for bit; the rest are
  within a few ulp, since ``log1p`` differs in its last bit between
  libraries (tests/test_torch_prng.py states the bound).

All uint32 arithmetic runs in int64 tensors masked to 32 bits, which is
exact on the CPU and on CUDA alike. Every function broadcasts over
leading dims, so a whole batch of per-switch keys hashes in one call.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all int64 tensors holding uint32
    values, broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seed, device=None):
    """Raw key(s) of integer seed(s), as ``jax.random.PRNGKey`` builds
    them with 32-bit integers: a seed keeps its low 32 bits (-1 ->
    4294967295, 2**32 + 5 -> 5) and the key is ``(0, seed)``. A
    sequence of seeds gives a ``(B, 2)`` batch of keys."""
    lo = torch.as_tensor(np.asarray(seed, dtype=np.int64) & MASK32,
                         device=device)
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def split(k, num: int = 2, partitionable: bool = True):
    """``jax.random.split``: ``(..., 2)`` keys -> ``(..., num, 2)``."""
    cnt = torch.arange(num, dtype=torch.int64, device=k.device)
    if partitionable:
        a, b = threefry2x32(k[..., 0:1], k[..., 1:2],
                            torch.zeros_like(cnt), cnt)
        return torch.stack([a, b], dim=-1)
    # original scheme: hash the 2*num counters as (i, num + i) pairs and
    # read the concatenated output words two at a time
    a, b = threefry2x32(k[..., 0:1], k[..., 1:2], cnt, cnt + num)
    return torch.cat([a, b], dim=-1).reshape(k.shape[:-1] + (num, 2))


def fold_in(k, data):
    """``jax.random.fold_in``: key(s) ``(..., 2)`` and integer data
    broadcast against the leading dims -> keys ``(..., 2)``. Data is
    taken modulo 2**32, as the reference casts it to uint32. (The same
    in both threefry schemes.)"""
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & MASK32
    a, b = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def counter_words(n: int, partitionable: bool = True, device=None):
    """How word ``i`` of an ``n``-word draw is hashed: counter pair
    ``(x1[i], x2[i])`` and which output word (``take2[i]``).

    Partitionable scheme: pair ``(0, i)``, the XOR of both outputs
    (``take2`` is None). Original scheme: the counters 0..n-1 (padded
    with a 0 to even length) split into halves ``h``; word ``i < h`` is
    the first output of pair ``(i, i + h)``, word ``i >= h`` the second
    output of pair ``(i - h, i)``.
    """
    i = torch.arange(n, dtype=torch.int64, device=device)
    if partitionable:
        return torch.zeros_like(i), i, None
    h = (n + 1) // 2
    take2 = i >= h
    x1 = torch.where(take2, i - h, i)
    x2 = torch.where(take2, i, i + h)
    x2 = torch.where(x2 < n, x2, 0)        # the odd-length pad counter
    return x1, x2, take2


def hash_counters(k, x1, x2, take2=None):
    """32 random bits per word: key(s) ``k`` (``(..., 2)``) broadcast
    against the counter words of ``counter_words`` (or any per-word
    selection of them). One call serves many keys, each with its own
    counters. Returns int64 words in [0, 2**32)."""
    a, b = threefry2x32(k[..., 0], k[..., 1], x1, x2)
    if take2 is None:
        return a ^ b
    return torch.where(take2, b, a)


def random_bits(k, n: int, partitionable: bool = True):
    """``n`` words of 32 random bits: key(s) ``(..., 2)`` -> ``(..., n)``
    int64 words in [0, 2**32)."""
    x1, x2, take2 = counter_words(n, partitionable, k.device)
    return hash_counters(k[..., None, :], x1, x2, take2)


def bits_to_unit(bits):
    """uint32 words -> float32 in [0, 1): the top 23 bits become the
    mantissa of a float in [1, 2), minus 1 (exact)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(k, n: int, partitionable: bool = True):
    """``jax.random.uniform(key, (n,))`` in float32: ``(..., n)``."""
    return bits_to_unit(random_bits(k, n, partitionable))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))

# single-precision erfinv coefficients (Giles 2010), highest power first;
# the two rows are the w < 5 and the w >= 5 branches
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """float32 inverse error function, the polynomial XLA lowers
    ``lax.erf_inv`` to. XLA contracts the Horner steps into fused
    multiply-adds; each step here runs in float64 (the float32 product
    is exact there) and rounds once to float32, which reproduces that.
    ``log1p`` runs in float64 too, so the result does not depend on
    which of PyTorch's vectorised or scalar paths an element takes."""
    w = (-torch.log1p(-(x * x).double())).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, cs, cl)
        p = (c.double() + p.double() * w).float()
    return torch.where(torch.abs(x) < 1.0, p * x, x * float("inf"))


def unit_to_normal(u01):
    """Uniforms in [0, 1) -> standard normals, as ``_normal_real``
    does: rescale to [nextafter(-1, 0), 1) and apply sqrt(2)*erfinv."""
    u = torch.clamp(u01 * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
    return _SQRT2 * erfinv(u)


def normal(k, n: int, partitionable: bool = True):
    """``jax.random.normal(key, (n,))`` in float32: ``(..., n)``."""
    return unit_to_normal(uniform(k, n, partitionable))
