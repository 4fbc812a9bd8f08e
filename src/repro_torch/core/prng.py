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

Under JAX's x64 mode (the sweep's ``x64=True``) three things change, as
``jax.random`` changes them: ``key`` keeps an int64 seed's high word;
``uniform`` draws float64 from 64 random bits a value (52 mantissa
bits); ``normal`` maps them through the float64 erfinv XLA compiles, a
different polynomial (``erfinv64``; tests/test_torch_x64.py states its
band).

All uint32 arithmetic runs in int64 tensors masked to 32 bits, which is
exact on the CPU and on CUDA alike. Every function broadcasts over
leading dims, so a whole batch of per-switch keys hashes in one call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import upload
from repro_torch.kernels.ref import fma as _fma
from repro_torch.kernels.ref import fma64_finite, veltkamp_split

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


def key(seed, device=None, x64: bool = False):
    """Raw key(s) of integer seed(s), as ``jax.random.PRNGKey`` builds
    them. With 32-bit integers (``x64=False``, JAX's default) a seed
    keeps its low 32 bits (-1 -> 4294967295, 2**32 + 5 -> 5) and the key
    is ``(0, seed)``. Under x64 the seed is an int64 and the key keeps
    its high word: ``(seed >> 32, seed & 0xFFFFFFFF)`` of its two's
    complement (-1 -> (4294967295, 4294967295), 2**32 + 5 -> (1, 5)). A
    sequence of seeds gives a ``(B, 2)`` batch of keys."""
    s = np.asarray(seed, dtype=np.int64)
    lo = upload(s & MASK32, device)
    hi = upload((s >> 32) & MASK32 if x64 else np.zeros_like(s), device)
    return torch.stack([hi, lo], dim=-1)


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


def counter_words(n: int, partitionable: bool = True, device=None,
                  bits: int = 32):
    """How word ``i`` of an ``n``-word draw of ``bits``-bit words is
    hashed: counter pair ``(x1[i], x2[i])`` and, for 32-bit words, which
    output word (``take2[i]``).

    32-bit words. Partitionable scheme: pair ``(0, i)``, the XOR of both
    outputs (``take2`` is None). Original scheme: the counters 0..n-1
    (padded with a 0 to even length) split into halves ``h``; word
    ``i < h`` is the first output of pair ``(i, i + h)``, word
    ``i >= h`` the second output of pair ``(i - h, i)``.

    64-bit words (``bits=64``, JAX's draws under x64) take both outputs
    of ONE hash, the first as the high word (``take2`` is None):
    partitionable, pair ``(0, i)``; original, pair ``(i, n + i)``, since
    that scheme draws 2n 32-bit words and makes word ``i`` of the first
    half the high word and word ``i`` of the second half the low one.
    So a 64-bit draw costs as many hashes as a 32-bit one.
    """
    i = torch.arange(n, dtype=torch.int64, device=device)
    if partitionable:
        return torch.zeros_like(i), i, None
    if bits == 64:
        return i, i + n, None
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


def hash_counters64(k, x1, x2):
    """64 random bits per word, as ``hash_counters`` does 32: the
    (high, low) 32-bit halves of each word, int64 tensors in
    [0, 2**32)."""
    return threefry2x32(k[..., 0], k[..., 1], x1, x2)


def random_bits(k, n: int, partitionable: bool = True, bits: int = 32):
    """``n`` random words of ``bits`` (32 or 64) bits: key(s) ``(..., 2)``
    -> ``(..., n)`` int64 words, in [0, 2**32) for 32 bits, and for 64
    bits the two's-complement int64 view of JAX's uint64 words."""
    x1, x2, take2 = counter_words(n, partitionable, k.device, bits)
    if bits == 32:
        return hash_counters(k[..., None, :], x1, x2, take2)
    hi, lo = hash_counters64(k[..., None, :], x1, x2)
    hi = torch.where(hi >= 2 ** 31, hi - 2 ** 32, hi)   # the sign word
    return hi * 2 ** 32 + lo


def bits_to_unit(bits):
    """uint32 words -> float32 in [0, 1): the top 23 bits become the
    mantissa of a float in [1, 2), minus 1 (exact)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


_ONE64 = 0x3FF0000000000000        # the bits of float64 1.0


def words_to_unit64(hi, lo):
    """64-bit words (their high and low 32-bit halves) -> float64 in
    [0, 1): the top 52 bits become the mantissa of a float in [1, 2),
    minus 1 (exact), as ``jax.random.uniform`` does for float64."""
    mant = (hi << 20) | (lo >> 12)
    return (mant | _ONE64).view(torch.float64) - 1.0


def uniform(k, n: int, partitionable: bool = True, dtype=torch.float32,
            minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (n,), dtype, minval, maxval)``:
    ``(..., n)``; float32 from 32 random bits a value, float64 (JAX's
    default dtype under x64) from 64. Other bounds than [0, 1) scale as
    JAX does, ``max(minval, u * (maxval - minval) + minval)`` with the
    bounds in ``dtype``, the product and sum one fused multiply-add as
    XLA compiles it."""
    if dtype == torch.float64:
        x1, x2, _ = counter_words(n, partitionable, k.device, 64)
        u = words_to_unit64(*hash_counters64(k[..., None, :], x1, x2))
    else:
        u = bits_to_unit(random_bits(k, n, partitionable))
    if minval == 0.0 and maxval == 1.0:
        return u                       # u * 1 + 0 and max(0, u) are u
    lo = torch.tensor(minval, dtype=dtype, device=u.device)
    hi = torch.tensor(maxval, dtype=dtype, device=u.device)
    return torch.maximum(lo, _fma(u, hi - lo, lo))


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_LO64 = float(np.nextafter(-1.0, 0.0))
_SQRT2 = float(np.float32(np.sqrt(2)))
_SQRT2_64 = float(np.sqrt(2))

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


# The float64 erfinv and log1p XLA's CPU backend compiles (jax 0.9):
# literals copied from the optimized HLO and LLVM IR that a jitted
# ``jax.lax.erf_inv`` of three float64 zeros writes under
#   JAX_ENABLE_X64=1 XLA_FLAGS=--xla_dump_to=DIR
# (the HLO's f64 constants; the IR's hex doubles for log1p).
# erfinv: Horner coefficients, highest power first, of the branches
# w < 6.25 (23), w < 16 (19) and w >= 16 (17), w = -log1p(-x*x).
_ERFINV64_W625 = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
    6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11,
    -5.415412054294628e-11, 1.0512122733215323e-09, -4.112633980346984e-09,
    -2.9070369957882005e-08, 4.2347877827932404e-07,
    -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
    0.24015818242558962, 1.6536545626831027)
_ERFINV64_W16 = (
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05,
    -4.7318229009055734e-05, 6.828485145957318e-05, 2.4031110387097894e-05,
    -0.0003550375203628475, 0.0009532893797373805, -0.0016882755560235047,
    0.002491442096107851, -0.003751208507569241, 0.005370914553590064,
    1.0052589676941592, 3.0838856104922208)
_ERFINV64_WBIG = (
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477,
    -0.00013871931833623122, 1.0103004648645344, 4.849906401408584)
# log1p(t) = t - t*t/2 + t**3 * P(t) / Q(t) for |t| < sqrt(2) - 1, else
# log(1 + t) (Cephes' coefficients; highest power first)
_LOG1P64_P = (4.52700008624452e-05, 0.49854102823193375, 6.578732594206104,
              29.911919328553072, 60.94966798098779, 57.11296359058554,
              20.039553499201283)
_LOG1P64_Q = (1.0, 15.062909083469192, 83.04756596796722,
              221.76239823732857, 309.09872225312057, 216.42788614495947,
              60.11866049760384)
_LOG1P64_SMALL = 0.41421356237309503


def _log1p64(t):
    """XLA's float64 log1p, with its contractions: the P and Q Horner
    steps and the -t*t/2 term are fused multiply-adds (measured against
    ``jax.random.normal`` under x64); ``1 + t`` of the log branch is
    not."""
    t_split = veltkamp_split(t)
    p = torch.full_like(t, _LOG1P64_P[0])
    q = torch.ones_like(t)
    for cp, cq in zip(_LOG1P64_P[1:], _LOG1P64_Q[1:]):
        p = fma64_finite(p, t, torch.full_like(t, cp), t_split)
        q = fma64_finite(q, t, torch.full_like(t, cq), t_split)
    t2 = t * t
    small = t + fma64_finite(t2, torch.full_like(t, -0.5),
                             (t * t2) * (p / q))
    return torch.where(torch.abs(t) < _LOG1P64_SMALL, small,
                       torch.log(t + 1.0))


def erfinv64(x):
    """float64 inverse error function, the polynomial XLA lowers
    ``lax.erf_inv`` to under x64 (its coefficients above). Every Horner
    step is a fused multiply-add, as XLA's CPU backend contracts them
    (``kernels.ref.fma64_finite``: the steps' operands are finite); on
    uniforms in (-1, 1) the normals it makes match
    ``jax.random.normal``'s to a few ulp, almost all bit for bit
    (tests/test_torch_x64.py states the band)."""
    w = -_log1p64(x * (-x))
    lt625, lt16 = w < 6.25, w < 16.0
    w = torch.where(lt625, w - 3.125,
                    torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))
    w_split = veltkamp_split(w)
    n16, nbig = len(_ERFINV64_W16), len(_ERFINV64_WBIG)

    def coef(i):
        # a float64 tensor first: where() of two Python floats is float32
        c = torch.full_like(x, _ERFINV64_W625[i])
        if i < n16:
            c = torch.where(lt625, c, _ERFINV64_W16[i])
        if i < nbig:
            c = torch.where(lt16, c, _ERFINV64_WBIG[i])
        return c

    p = coef(0)
    for i in range(1, len(_ERFINV64_W625)):
        step = fma64_finite(p, w, coef(i), w_split)
        if i >= n16:
            step = torch.where(lt625, step, p)
        elif i >= nbig:
            step = torch.where(lt16, step, p)
        p = step
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def unit_to_normal(u01):
    """Uniforms in [0, 1) -> standard normals of the same dtype, as
    ``_normal_real`` does: rescale to [nextafter(-1, 0), 1) and apply
    sqrt(2)*erfinv (float32, or float64 under x64)."""
    if u01.dtype == torch.float64:
        u = torch.clamp(u01 * 2.0 + _NORMAL_LO64, min=_NORMAL_LO64)
        return _SQRT2_64 * erfinv64(u)
    u = torch.clamp(u01 * 2.0 + _NORMAL_LO, min=_NORMAL_LO)
    return _SQRT2 * erfinv(u)


def normal(k, n: int, partitionable: bool = True, dtype=torch.float32):
    """``jax.random.normal(key, (n,), dtype)``: ``(..., n)``."""
    return unit_to_normal(uniform(k, n, partitionable, dtype))
