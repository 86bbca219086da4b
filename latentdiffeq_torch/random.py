"""JAX's threefry PRNG keys in PyTorch (the key semantics of
``jax.random`` under ``jax_threefry_partitionable=True``).

The SDE solvers key every cell of the virtual Brownian tree with
``fold_in`` (solve/brownian.py); this module computes those keys and the
standard normals drawn from them with the same integers as JAX, so the same
key gives the same Brownian path in both packages.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words. The
arithmetic runs in int64 masked to 32 bits after every add and shift, so no
intermediate reaches 2^63 and the integers are the same on every device.
Every function is vectorised over the leading (batch) dimensions of its
keys and runs on the keys' device.

- ``PRNGKey(seed)`` = ``[seed >> 32, seed & 0xffffffff]``.
- ``fold_in(key, d)`` = threefry-2x32 (20 rounds) of the counter ``(0, d)``
  under ``key``; ``split(key, n)[i]`` = ``fold_in(key, i)``.
- ``normal(key, shape)``: threefry of the flat index ``i`` as the counter
  ``(0, i)``; 32-bit draws take ``bits1 ^ bits2``, 64-bit draws
  ``bits1 << 32 | bits2``; the top mantissa bits make a float in [1, 2),
  minus 1, mapped to a uniform on [nextafter(-1, 0), 1), then
  ``sqrt(2) * erfinv`` with XLA's erfinv polynomials (Giles, "Approximating
  the erfinv function"), written out: ``torch.special.erfinv`` is a
  different approximation and misses JAX's float32 normals by ~9e-6. Every
  operation of a draw is correctly rounded (its log1p is built from such
  operations, its sqrt is :func:`sqrt_rn`), so a draw has the same bits on
  the CPU and on the card.
- ``randint(key, shape, minval, maxval)``: JAX's int32 draw, two words of
  32 bits from ``split(key)`` and a remainder by the span, with JAX's
  multiplier for the upper word.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["PRNGKey", "as_key", "fold_in", "split", "normal", "randint",
           "threefry2x32", "sqrt_rn"]

_M32 = 0xFFFFFFFF
_NP = {torch.float32: np.float32, torch.float64: np.float64}
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32 with 20 rounds of the counter ``(c0, c1)`` under the
    key ``(k0, k1)``; int64 tensors of uint32 words, broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _M32
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of ``jax.random.PRNGKey(seed)``: (2,) int64, its words
    filled on ``device`` (no copy from the host)."""
    seed = int(seed)
    key = torch.full((2,), seed & _M32, dtype=torch.int64, device=device)
    key[0] = (seed >> 32) & _M32
    return key


def as_key(key, device=None) -> torch.Tensor:
    """A key (..., 2) as int64 words on ``device``: from a tensor, or from
    the uint32 words of a numpy (or JAX) key array."""
    if not isinstance(key, torch.Tensor):
        key = torch.from_numpy(np.asarray(key).astype(np.int64))
    if key.dtype != torch.int64 or key.shape[-1:] != (2,):
        raise ValueError(f"a key is an int64 tensor (..., 2) of uint32 "
                         f"words, got {key.dtype} {tuple(key.shape)}")
    return key.to(device) if device is not None else key


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2), data an int or an integer tensor
    broadcastable to the keys' batch shape; returns (batch..., 2). An int
    enters the arithmetic as a number (nothing is copied to the device, so
    a CUDA graph can capture it)."""
    if isinstance(data, torch.Tensor) or np.ndim(data):
        data = torch.as_tensor(data).to(device=key.device, dtype=torch.int64)
        c0, c1 = torch.zeros_like(data), data & _M32
    else:
        c0, c1 = 0, int(data) & _M32
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], c0, c1)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: key (..., 2) -> (..., num, 2)."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[..., None, :], idx)


def _bits(key, n: int):
    """The threefry output words of the flat counters 0..n-1 under each key:
    two (..., n) int64 tensors."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(idx), idx)


# XLA's ErfInv32: w = -log1p(-x^2); w < 5: w - 2.5, else sqrt(w) - 3.
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# XLA's ErfInv64: w < 6.25: w - 3.125 (23 terms); w < 16: sqrt(w) - 3.25
# (19 terms); else sqrt(w) - 5 (17 terms).
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


@functools.lru_cache(maxsize=None)
def _tables(device, dtype):
    """XLA's erfinv coefficients for ``dtype`` as a (regions, terms) tensor
    on ``device`` (rows padded with zeros past each region's degree), and
    the normal's constants nextafter(-1, 0), 1 and sqrt(2). Copied to the
    device once, at the first draw (a block's eager first epoch: a CUDA
    graph captured after it reads the cached tensors)."""
    regions = ((_ERFINV32_LT5, _ERFINV32_GE5) if dtype == torch.float32
               else (_ERFINV64_LT625, _ERFINV64_LT16, _ERFINV64_GE16))
    width = len(regions[0])
    tab = torch.tensor([r + (0.0,) * (width - len(r)) for r in regions],
                       dtype=dtype, device=device)
    npt = _NP[dtype]
    lo = np.nextafter(np.array(-1.0, npt), np.array(0.0, npt))
    consts = torch.tensor([lo, 1.0, np.sqrt(2.0)], dtype=dtype,
                          device=device)
    return tab, consts


# log(m) = 2 atanh(s), s = (m - 1) / (m + 1), for m in [sqrt(1/2), sqrt(2)):
# 2 s (1 + s^2/3 + s^4/5 + ...), |s| <= 0.1716, to below each type's ulp
_ATANH_TERMS = {torch.float32: 6, torch.float64: 13}
# ln 2 split so that e * _LN2[0] is exact (fdlibm's split for float64)
_LN2 = {torch.float32: (0.693145751953125, 1.428606765330187e-06),
        torch.float64: (6.93147180369123816490e-01,
                        1.90821492927058770002e-10)}


def log1p_exact(y: torch.Tensor) -> torch.Tensor:
    """log(1 + y) for y > -1 from additions, products, quotients and
    frexp only, each correctly rounded on every device, so its bits are
    the same on the CPU and on the card (``torch.log1p`` is not: the two
    devices' versions differ by an ulp). Accurate to a few ulps."""
    u = 1.0 + y
    m, e = torch.frexp(u)                     # u = m 2^e, m in [1/2, 1)
    low = m < 0.7071067811865476
    m = torch.where(low, m * 2.0, m)
    e = (e - low.to(e.dtype)).to(y.dtype)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    n = _ATANH_TERMS[y.dtype]
    p = torch.full_like(s2, 1.0 / (2 * n - 1))
    for k in range(n - 2, 0, -1):
        p = 1.0 / (2 * k + 1) + s2 * p
    log_m = 2.0 * s + 2.0 * s * (s2 * p)
    hi, lo = _LN2[y.dtype]
    log_u = e * hi + (e * lo + log_m)
    # u rounds 1 + y: add back what the rounding dropped
    return log_u + (y - (u - 1.0)) / u


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root on every device. PyTorch's float32
    sqrt on the card is not (about 1 in 140 values is an ulp off the CPU's);
    the float64 root rounded to float32 is, as 53 >= 2 * 24 + 2 bits."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.double()).to(torch.float32)
    return torch.sqrt(x)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 / float64 erfinv on ``x`` in (-1, 1), its Horner steps
    each a product then a sum; w = -log1p(-x^2) by :func:`log1p_exact`."""
    if x.dtype not in _NP:
        raise TypeError(f"erfinv_xla takes float32 or float64, not {x.dtype}")
    tab, _ = _tables(x.device, x.dtype)
    w = -log1p_exact(-(x * x))
    if x.dtype == torch.float32:
        lt = w < 5.0
        ws = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)
        p = torch.where(lt, tab[0, 0], tab[1, 0])
        for i in range(1, 9):
            p = torch.where(lt, tab[0, i], tab[1, i]) + p * ws
        return p * x
    lt625, lt16 = w < 6.25, w < 16.0
    sw = sqrt_rn(w)
    ws = torch.where(lt625, w - 3.125,
                     torch.where(lt16, sw - 3.25, sw - 5.0))

    def coef(i):
        c = tab[0, i]
        if i < 19:
            c = torch.where(lt625, c, tab[1, i])
        if i < 17:
            c = torch.where(lt16, c, tab[2, i])
        return c

    p = coef(0)
    for i in range(1, 17):
        p = coef(i) + p * ws
    for i in range(17, 19):
        p = torch.where(lt16, coef(i) + p * ws, p)
    for i in range(19, 23):
        p = torch.where(lt625, coef(i) + p * ws, p)
    return p * x


def normal(key: torch.Tensor, shape=(), dtype=torch.float32) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` for each key of ``key``
    (..., 2): returns (..., *shape) on the keys' device."""
    shape = tuple(shape)
    n = math.prod(shape)
    b1, b2 = _bits(key, n)
    # the float in [1, 2) whose mantissa is the draw's top bits, as 1 + m
    # 2^-bits: exact in the float type (m has as many bits as its
    # mantissa), and no reinterpreting view, which torch.func.vmap may
    # not batch
    if dtype == torch.float32:
        mant, bits = (b1 ^ b2) >> 9, 23
    elif dtype == torch.float64:
        # the top 52 of the 64 bits b1 << 32 | b2, without passing 2^63
        mant, bits = (b1 << 20) | (b2 >> 12), 52
    else:
        raise TypeError(f"normal draws float32 or float64, not {dtype}")
    one_two = 1.0 + mant.to(dtype) * (2.0 ** -bits)
    _, (lo, hi, sqrt2) = _tables(key.device, dtype)
    u = torch.maximum(lo, (one_two - 1.0) * (hi - lo) + lo)
    z = sqrt2 * erfinv_xla(u)
    return z.reshape(key.shape[:-1] + shape)


_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _mul32(a, b):
    """a * b mod 2^32 for uint32 words in int64, in 16-bit halves so that
    no product passes 2^63."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _rem(a, span):
    """XLA's unsigned remainder: by 0 it leaves ``a``."""
    return torch.where(span == 0, a, a % torch.clamp(span, min=1))


def randint(key: torch.Tensor, shape=(), minval=0, maxval=1) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` in its default
    int32 for a key (2,): int64 values in [minval, maxval) on the key's
    device (``minval`` alone when ``maxval <= minval``), the same integers
    as JAX's (random.py ``_randint``)."""
    shape = tuple(shape)
    dev = key.device

    def bound(v):   # a number is filled on the device, not copied there
        if isinstance(v, torch.Tensor) or np.ndim(v):
            return torch.as_tensor(v).to(device=dev, dtype=torch.int64)
        return torch.full((), int(v), dtype=torch.int64, device=dev)

    lo, hi = bound(minval), bound(maxval)
    out_of_range = hi > _I32_MAX
    lo, hi = lo.clamp(_I32_MIN, _I32_MAX), hi.clamp(_I32_MIN, _I32_MAX)
    k1, k2 = split(key)
    n = math.prod(shape)
    words = []
    for k in (k1, k2):
        b1, b2 = _bits(k, n)
        words.append((b1 ^ b2).reshape(shape))
    higher, lower = words
    span = (hi - lo) & _M32
    span = torch.where(hi <= lo, torch.ones_like(span), span)
    span = torch.where(out_of_range & (hi > lo), (span + 1) & _M32, span)
    mult = _rem(torch.full_like(span, 2 ** 16), span)
    mult = _rem(_mul32(mult, mult), span)
    offset = (_mul32(_rem(higher, span), mult) + _rem(lower, span)) & _M32
    offset = _rem(offset, span)
    # minval + offset wraps in int32, as the JAX sum does
    return ((lo + offset + 2 ** 31) & _M32) - 2 ** 31
