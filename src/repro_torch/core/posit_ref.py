"""Exact posit oracle — pure Python integers / fractions (a copy of
``repro.core.posit_ref``: the port imports nothing of the JAX package).

softposit (which the paper validates against) is not installable offline, so
this module re-implements its semantics exactly and serves as the ground
truth for the port's posit arithmetic (``core.posit``) and the TALU
simulator (``core.talu``):

  * two's-complement handling of negative posits,
  * regime/exponent/fraction field extraction with right-zero-filled
    truncated exponents,
  * bit-level round-to-nearest-even (guard/sticky on the assembled code),
  * saturation to maxpos/minpos (posit results never round to 0 or NaR).

Everything here is exact: decode produces `fractions.Fraction`; encode
consumes a Fraction (or float, converted exactly) and performs integer-only
RNE assembly.  NaR is represented as Python ``None`` at the value level.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "decode_fields", "to_fraction", "to_float", "encode", "encode_fraction",
    "add", "mul", "sub", "fma", "all_values", "minpos", "maxpos", "nar_code",
]


def nar_code(n: int) -> int:
    return 1 << (n - 1)


def _mask(b: int) -> int:
    return (1 << b) - 1


def decode_fields(code: int, n: int, es: int) -> Tuple[int, int, int, int, int]:
    """Return (sign, K, E, f_len, F) for a non-zero, non-NaR code.

    Fields are extracted from |code| (two's complement magnitude), per the
    posit standard.  Truncated exponent bits are zero-filled on the right.
    """
    code &= _mask(n)
    s = code >> (n - 1)
    mag = code if s == 0 else ((-code) & _mask(n))
    body = mag & _mask(n - 1)
    assert body != 0, "zero/NaR have no fields"
    lead = (body >> (n - 2)) & 1
    # run length of leading bits equal to `lead`
    r = 0
    for i in range(n - 2, -1, -1):
        if (body >> i) & 1 == lead:
            r += 1
        else:
            break
    K = (r - 1) if lead == 1 else -r
    rem = (n - 1) - r - 1  # bits after the stop bit; -1 if regime fills body
    rem = max(rem, 0)
    rest = body & _mask(rem)
    e_have = min(es, rem)
    E = (rest >> (rem - e_have)) << (es - e_have)  # right zero-fill
    f_len = max(rem - es, 0)
    F = rest & _mask(f_len)
    return s, K, E, f_len, F


def to_fraction(code: int, n: int, es: int) -> Optional[Fraction]:
    """Exact value of a posit code; 0 -> Fraction(0); NaR -> None."""
    code &= _mask(n)
    if code == 0:
        return Fraction(0)
    if code == nar_code(n):
        return None
    s, K, E, f_len, F = decode_fields(code, n, es)
    t = (K << es) + E
    mant = Fraction((1 << f_len) + F, 1 << f_len)
    val = mant * (Fraction(2) ** t)
    return -val if s else val


def to_float(code: int, n: int, es: int) -> float:
    f = to_fraction(code, n, es)
    if f is None:
        return float("nan")
    return float(f)  # exact for n<=32 (<=27 frac bits, |t|<=120)


def minpos(n: int, es: int) -> Fraction:
    return Fraction(2) ** (-(1 << es) * (n - 2))


def maxpos(n: int, es: int) -> Fraction:
    return Fraction(2) ** ((1 << es) * (n - 2))


def encode_fraction(x: Optional[Fraction], n: int, es: int) -> int:
    """Exact bit-RNE encoding of a Fraction; None -> NaR. Saturating."""
    if x is None:
        return nar_code(n)
    if x == 0:
        return 0
    s = 1 if x < 0 else 0
    a = -x if s else x
    # t = floor(log2(a)) exactly
    num, den = a.numerator, a.denominator
    t = num.bit_length() - den.bit_length()
    if (num >> t if t >= 0 else num << -t) < den:  # 2^t > a ?
        t -= 1
    # a = 2^t * (1 + frac), frac in [0, 1)
    frac = a / (Fraction(2) ** t) - 1
    assert 0 <= frac < 1
    K = t >> es
    E = t - (K << es)
    # regime saturation: K = n-2 already fills the body with ones (the stop
    # bit is cut), so every value with K >= n-2 is >= maxpos.
    if K >= n - 2:
        body = _mask(n - 1)  # maxpos
    elif K <= -(n - 1):
        body = 1  # minpos
    else:
        if K >= 0:
            reg, w0 = ((_mask(K + 1)) << 1), K + 2  # K+1 ones then stop 0
        else:
            reg, w0 = 1, -K + 1  # -K zeros then stop 1
        avail = (n - 1) - w0  # bits available for exponent+fraction
        # exponent+fraction as an exact binary expansion with avail+1 bits
        # kept (last bit = guard) and a sticky for the rest.
        if avail + 1 - es >= 0:
            ef_shift = avail + 1 - es  # fraction bits incl. guard
            scaled = frac * (1 << ef_shift)
            fbits = int(scaled)  # floor
            sticky = 1 if (scaled - fbits) != 0 else 0
            efg = (E << ef_shift) | fbits  # es + avail+1 - es = avail+1 bits
        else:
            # even the exponent is cut: keep avail+1 top bits of E
            cut = es - (avail + 1)
            efg = E >> cut
            sticky = 1 if ((E & _mask(cut)) != 0 or frac != 0) else 0
        guard = efg & 1
        kept = efg >> 1
        body = (reg << avail) | kept
        if guard and (sticky or (body & 1)):
            body += 1
        # never round to 0 / NaR; saturate
        body = max(1, min(body, _mask(n - 1)))
    code = body if s == 0 else ((-body) & _mask(n))
    return code


def encode(x, n: int, es: int) -> int:
    """Encode a Python/numpy float with exact semantics (float -> Fraction)."""
    if isinstance(x, Fraction):
        return encode_fraction(x, n, es)
    xf = float(x)
    if np.isnan(xf) or np.isinf(xf):
        return nar_code(n)
    return encode_fraction(Fraction(xf), n, es)


def _binop(a: int, b: int, n: int, es: int, op) -> int:
    if a == nar_code(n) or b == nar_code(n):
        return nar_code(n)
    va, vb = to_fraction(a, n, es), to_fraction(b, n, es)
    return encode_fraction(op(va, vb), n, es)


def add(a: int, b: int, n: int, es: int) -> int:
    return _binop(a, b, n, es, lambda x, y: x + y)


def sub(a: int, b: int, n: int, es: int) -> int:
    return _binop(a, b, n, es, lambda x, y: x - y)


def mul(a: int, b: int, n: int, es: int) -> int:
    return _binop(a, b, n, es, lambda x, y: x * y)


def fma(a: int, b: int, c: int, n: int, es: int) -> int:
    """Fused multiply-add: round(a*b + c) with a single rounding (quire-like)."""
    if nar_code(n) in (a, b, c):
        return nar_code(n)
    va, vb, vc = (to_fraction(x, n, es) for x in (a, b, c))
    return encode_fraction(va * vb + vc, n, es)


def all_values(n: int, es: int) -> np.ndarray:
    """float64 value of every code 0..2^n-1 (NaR -> nan). Exact for n<=32."""
    out = np.empty(1 << n, dtype=np.float64)
    for c in range(1 << n):
        out[c] = to_float(c, n, es)
    return out
