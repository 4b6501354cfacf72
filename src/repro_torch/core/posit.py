"""Vectorized posit codec and exact posit arithmetic in plain PyTorch
(port of ``repro.core.posit``).

``decode_to_f32`` / ``encode_f32`` convert between posit codes and float32
with bit-exact softposit semantics: two's-complement negatives,
right-zero-filled truncated exponents, bit-level RNE, maxpos/minpos
saturation.  ``encode_f32`` normalises float32 subnormals; the kernel
encoder ``kernels.posit_encode.encode_tile`` flushes them instead.

The regime is found with Algorithm 1's n-1 parallel threshold compares
(``_regime_run``), the same form as the CUDA codec, so the plain version and
the kernels share one algorithm; ``thermometer_decode`` returns the compare
matrix itself.

``mul`` / ``add`` / ``sub`` / ``dot_exact`` / ``matmul_exact`` are *exact*
posit arithmetic for n <= 16 (codes in, codes out), the software analogue
of TALU's compute mode, with the reference's operand order and widths.
They compute where their inputs live; ``dot_exact`` is a chain rounded at
every step, k = 0 .. K-1, over whole tensors.

Bit work: torch's unsigned 16/32-bit types have thin op coverage, so every
"uint32" field here is an int64 tensor holding a value in [0, 2**32).  The
shift helpers are clamped (a shift by >= 32 gives 0), as in the reference;
neither C++ nor torch define such shifts.
"""
from __future__ import annotations

import torch

from .formats import PositFormat

M32 = 0xFFFFFFFF


def _u(x):
    """Wrap to uint32 (an int64 tensor, or a Python int)."""
    if isinstance(x, int):
        return x & M32
    return x.to(torch.int64) & M32


def _mask(b):
    """(1 << b) - 1 as uint32, valid for b in [0, 32]; b int or tensor."""
    b = _u(b)
    if isinstance(b, int):
        return M32 if b >= 32 else (1 << b) - 1
    return torch.where(b >= 32, M32, (1 << b.clamp(max=31)) - 1)


def _shl(x, k):
    """uint32 left shift, clamped: k >= 32 -> 0."""
    k = _u(k)
    if isinstance(k, int):
        return torch.zeros_like(x) if k >= 32 else (x << k) & M32
    return torch.where(k >= 32, 0, (x << k.clamp(max=31)) & M32)


def _shr(x, k):
    """uint32 logical right shift, clamped: k >= 32 -> 0."""
    k = _u(k)
    x = _u(x)
    if isinstance(k, int):
        return torch.zeros_like(x) if k >= 32 else x >> k
    return torch.where(k >= 32, 0, x >> k.clamp(max=31))


def _negate_code(u, n):
    """Two's-complement negation within n bits."""
    return (~u + 1) & _mask(n)


def f32_bits(x):
    """float32 tensor -> its IEEE-754 bits as uint32 (int64 tensor)."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & M32


def f32_from_bits(bits):
    """uint32 bits (int64 tensor) -> float32 tensor."""
    b = torch.where(bits >= (1 << 31), bits - (1 << 32), bits)
    return b.to(torch.int32).view(torch.float32)


def to_storage(code, fmt: PositFormat):
    """uint32 code values (< 2**bits) -> the format's storage dtype, keeping
    the bit pattern (int16/int32 storage wraps the top bit)."""
    dt = fmt.storage_dtype
    if dt != torch.uint8:
        width = 8 * torch.empty((), dtype=dt).element_size()
        code = torch.where(code >= (1 << (width - 1)), code - (1 << width),
                           code)
    return code.to(dt)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _bit_length(x):
    """Bits of a non-negative integer tensor below 2**53 (``int.bit_length``;
    0 -> 0): float64's exponent is exact there, and torch has no clz."""
    return torch.frexp(x.to(torch.float64)).exponent.to(torch.int64)


def thermometer_decode(codes, fmt: PositFormat):
    """Algorithm 1's Find_R, verbatim: parallel threshold comparisons.

    Returns (V, r, K): V is the (..., n-1) thermometer matrix of
    Q-function outputs ``V_i = T[n-2:0] >= 2^{n-1}-1-(2^i-1)``, r =
    popcount(V) the regime run length and K the regime value.  Operates on
    the raw code the way the TALU does (magnitude handling happens
    upstream)."""
    n = fmt.bits
    body = _u(codes) & _mask(n - 1)
    lead = _shr(body, n - 2) & 1
    t_val = torch.where(lead == 1, body, (~body) & _mask(n - 1))
    i = torch.arange(n - 1, dtype=torch.int64, device=t_val.device)
    v = (t_val[..., None] >= (1 << (n - 1)) - (1 << i)).to(torch.int64)
    r = v.sum(dim=-1)
    return v, r, torch.where(lead == 1, r - 1, -r)


def regime_lut(fmt: PositFormat) -> torch.Tensor:
    """The paper's LUT: thermometer popcount -> K (for the lead=1 plane)."""
    return torch.arange(fmt.bits, dtype=torch.int32) - 1


def _regime_run(t_val, n: int):
    """Algorithm 1's Find_R: the regime run length as the count of n-1
    parallel threshold compares ``t_val >= 2^{n-1} - 2^i``."""
    r = torch.zeros_like(t_val)
    for i in range(n - 1):
        r = r + (t_val >= (1 << (n - 1)) - (1 << i)).to(torch.int64)
    return r


def _decode_parts(codes, fmt: PositFormat):
    """codes -> (s, t, f_len, F, is_zero, is_nar).

    t is the total binary exponent 2^es*K + E; F the fraction field."""
    n, es = fmt.bits, fmt.es
    u = _u(codes) & _mask(n)
    is_zero = u == 0
    is_nar = u == (1 << (n - 1))
    s = _shr(u, n - 1) & 1
    mag = torch.where(s == 1, _negate_code(u, n), u)
    body = mag & _mask(n - 1)
    lead = _shr(body, n - 2) & 1
    t_pat = torch.where(lead == 1, body, (~body) & _mask(n - 1))
    r = _regime_run(t_pat, n)
    k = torch.where(lead == 1, r - 1, -r)
    rem = (n - 1 - r - 1).clamp(min=0)
    rest = body & _mask(rem)
    e_have = rem.clamp(max=es)
    e_field = _shl(_shr(rest, rem - e_have), es - e_have)
    f_len = (rem - es).clamp(min=0)
    f_field = rest & _mask(f_len)
    t = k * (1 << es) + e_field + fmt.bias
    return s, t, f_len, f_field, is_zero, is_nar


def decode_to_f32(codes, fmt: PositFormat):
    """Posit codes -> float32.  Exact for n<=16; RNE on the fraction for
    n=32."""
    n = fmt.bits
    s, t, f_len, f_field, is_zero, is_nar = _decode_parts(codes, fmt)
    if n <= 16:
        man = _shl(f_field, 23 - f_len)   # f_len <= 13 <= 23: exact
        t_adj = t
    else:
        # f_len can reach 27 > 23: RNE into 23 mantissa bits
        cut = (f_len - 23).clamp(min=0)
        kept = _shr(f_field, cut)
        guard = _shr(f_field, (cut - 1).clamp(min=0)) & 1
        guard = torch.where(cut > 0, guard, 0)
        sticky = ((f_field & _mask((cut - 1).clamp(min=0))) != 0).to(
            torch.int64)
        kept = kept + (guard & (sticky | (kept & 1)))
        carry = _shr(kept, 23) & 1      # mantissa overflow -> bump exponent
        man_full = torch.where(carry == 1, 0,
                               _shl(kept, (23 - f_len).clamp(min=0)))
        man = torch.where(f_len > 23,
                          torch.where(carry == 1, 0, kept & _mask(23)),
                          man_full)
        t_adj = t + carry * (f_len > 23).to(torch.int64)
    bits = _shl(s, 31) | _shl(_u(t_adj + 127), 23) | man
    val = f32_from_bits(bits)
    val = torch.where(is_zero, 0.0, val)
    return torch.where(is_nar, float("nan"), val)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _encode_parts(s, t, frac, fw: int, sticky, is_zero, is_nar,
                  fmt: PositFormat):
    """Assemble a posit code from sign, total exponent t and a fraction
    field ``frac`` (value frac/2^fw in [0,1)).  Bit-exact RNE with
    guard/sticky; saturates to maxpos/minpos.  Returns storage codes."""
    n, es = fmt.bits, fmt.es
    t = t - fmt.bias
    k = t >> es                         # arithmetic: floor division by 2^es
    e_field = _u(t - k * (1 << es))
    sat_hi = k >= n - 2                 # regime fills the body: >= maxpos
    sat_lo = k <= -(n - 1)
    k_c = k.clamp(-(n - 2), n - 3)
    pos = k_c >= 0
    w0 = torch.where(pos, k_c + 2, 1 - k_c)
    reg = torch.where(pos, _shl(_mask(k_c + 1), 1), 1)
    avail = (n - 1) - w0
    ef_shift = avail + 1 - es           # fraction bits incl. guard position
    # --- case ef_shift >= 0 ---
    efp = ef_shift.clamp(min=0)
    take = efp.clamp(max=fw)            # bits taken from frac
    fbits = _shl(_shr(frac, fw - take), efp - take)
    st_a = sticky | ((frac & _mask(fw - take)) != 0)
    efg_a = _shl(e_field, efp) | fbits
    # --- case ef_shift < 0 (exponent itself is cut) ---
    cut = (-ef_shift).clamp(min=0)
    efg_b = _shr(e_field, cut)
    st_b = sticky | ((e_field & _mask(cut)) != 0) | (frac != 0)
    neg_case = ef_shift < 0
    efg = torch.where(neg_case, efg_b, efg_a)
    st = torch.where(neg_case, st_b, st_a).to(torch.int64)
    guard = efg & 1
    kept = _shr(efg, 1)
    body = _shl(reg, avail) | kept
    body = body + (guard & (st | (body & 1)))
    body = torch.where(sat_hi, _mask(n - 1), body)
    body = torch.where(sat_lo, 1, body)
    body = body.clamp(1, _mask(n - 1))  # never round to 0/NaR
    code = torch.where(s == 1, _negate_code(body, n), body)
    code = torch.where(is_zero, 0, code)
    code = torch.where(is_nar, 1 << (n - 1), code)
    return to_storage(code, fmt)


def f32_fields(x):
    """float32 -> (bits, s, exp_raw, man_raw, is_zero, is_nar)."""
    bits = f32_bits(x)
    s = _shr(bits, 31)
    exp_raw = _shr(bits, 23) & 0xFF
    man_raw = bits & _mask(23)
    is_zero = (bits & _mask(31)) == 0
    is_nar = exp_raw == 255             # inf/nan -> NaR
    return bits, s, exp_raw, man_raw, is_zero, is_nar


def encode_f32(x, fmt: PositFormat):
    """float32 -> posit codes, bit-exact RNE; subnormals are normalised."""
    _, s, exp_raw, man_raw, is_zero, is_nar = f32_fields(x)
    subn = (exp_raw == 0) & (~is_zero)
    # leading zeros of the 23-bit field, plus one for the hidden bit
    nz_shift = 24 - _bit_length(man_raw)
    man_n = torch.where(subn, _shl(man_raw, nz_shift) & _mask(23), man_raw)
    t = torch.where(subn, -126 - nz_shift, exp_raw - 127)
    return _encode_parts(s, t, man_n, 23, False, is_zero, is_nar, fmt)


# ---------------------------------------------------------------------------
# Exact arithmetic (n <= 16; every field below 2**31)
# ---------------------------------------------------------------------------

_FW = 14  # working fraction bits; >= max f_len (13 for P(16,0))


def _check_exact(fmt: PositFormat) -> None:
    if fmt.bits > 16:
        raise NotImplementedError("exact posit arithmetic supports n<=16")


def _dec_norm(codes, fmt: PositFormat):
    """Decode to (s, t, mant) with mant = 1.f at _FW fraction bits."""
    s, t, f_len, f_field, is_zero, is_nar = _decode_parts(codes, fmt)
    mant = _shl(f_field, _FW - f_len) | (1 << _FW)
    return s, t, mant, is_zero, is_nar


def mul(a, b, fmt: PositFormat):
    """Exact posit multiply (codes x codes -> storage codes), n <= 16."""
    _check_exact(fmt)
    sa, ta, ma, za, na = _dec_norm(a, fmt)
    sb, tb, mb, zb, nb = _dec_norm(b, fmt)
    prod = ma * mb                      # < 2^(2FW+2) = 2^30
    hi = _shr(prod, 2 * _FW + 1) & 1
    t = ta + tb + hi - 2 * fmt.bias     # undo double bias; encode re-adds one
    frac = _shr(prod, hi) & _mask(2 * _FW)  # normalized: [2^2FW, 2^(2FW+1))
    return _encode_parts(sa ^ sb, t, frac, 2 * _FW, False, za | zb, na | nb,
                         fmt)


def add(a, b, fmt: PositFormat):
    """Exact posit add (codes x codes -> storage codes), n <= 16.

    Classic guard/round/sticky alignment with 3 guard bits; a subtraction
    borrows its sticky as a -1 so the kept bits stay a truncation of the
    true result.  Where exactly one operand is zero, the other operand's
    code comes back unchanged."""
    _check_exact(fmt)
    G = 3
    sa, ta, ma, za, na = _dec_norm(a, fmt)
    sb, tb, mb, zb, nb = _dec_norm(b, fmt)
    swap = (tb > ta) | ((tb == ta) & (mb > ma))
    sl, ss = torch.where(swap, sb, sa), torch.where(swap, sa, sb)
    tl, ts = torch.where(swap, tb, ta), torch.where(swap, ta, tb)
    ml, ms = torch.where(swap, mb, ma), torch.where(swap, ma, mb)
    d = (tl - ts).clamp(0, _FW + G + 2)
    msg_full = _shl(ms, G)
    sticky = (msg_full & _mask(d)) != 0
    mlg, msg = _shl(ml, G), _shr(msg_full, d)
    mag = torch.where((sl ^ ss) == 1, mlg - msg - sticky.to(torch.int64),
                      mlg + msg)
    res_zero = (mag == 0) & ~sticky
    mag = mag.clamp(min=1)              # masked out by res_zero
    # normalize to 1.f at (FW+G) fraction bits
    shift = _bit_length(mag) - 1 - (_FW + G)
    mnorm = torch.where(shift >= 0, _shr(mag, shift), _shl(mag, -shift))
    lost = (shift > 0) & ((mag & _mask(shift.clamp(min=0))) != 0)
    t = tl + shift - fmt.bias           # one bias gets re-applied in encode
    out = _encode_parts(torch.where(res_zero, 0, sl), t,
                        mnorm & _mask(_FW + G), _FW + G, sticky | lost,
                        (za & zb) | res_zero, na | nb, fmt)
    out = torch.where(zb & ~za, to_storage(_u(a) & _mask(fmt.bits), fmt), out)
    return torch.where(za & ~zb, to_storage(_u(b) & _mask(fmt.bits), fmt),
                       out)


def sub(a, b, fmt: PositFormat):
    """a - b: b negated within n bits (zero and NaR map to themselves)."""
    n = fmt.bits
    bu = _u(b) & _mask(n)
    nb = torch.where(bu == 0, bu, _negate_code(bu, n))
    return add(a, to_storage(nb, fmt), fmt)


def fma_f32(acc_f32, a_codes, b_codes, fmt: PositFormat):
    """Decode-multiply-accumulate in f32 (posit as storage, float
    compute)."""
    return acc_f32 + decode_to_f32(a_codes, fmt) * decode_to_f32(b_codes,
                                                                 fmt)


def dot_exact(a_codes, b_codes, fmt: PositFormat):
    """Exact posit dot product over the last axis: a sequential chain
    ``acc = add(acc, mul(a_k, b_k))`` from a zero code, k = 0 .. K-1, each
    step rounded (the TALU-V execution model).  Not a sum: a reordered or
    tree reduction gives other codes."""
    _check_exact(fmt)
    a_t, b_t = a_codes.movedim(-1, 0), b_codes.movedim(-1, 0)
    acc = torch.zeros(torch.broadcast_shapes(a_t.shape[1:], b_t.shape[1:]),
                      dtype=fmt.storage_dtype, device=a_codes.device)
    for ak, bk in zip(a_t, b_t):
        acc = add(acc, mul(ak, bk, fmt), fmt)
    return acc


def matmul_exact(a_codes, b_codes, fmt: PositFormat):
    """(M, K) x (K, N) exact posit matmul (TALU-V semantics)."""
    return dot_exact(a_codes[:, None, :], b_codes.T[None, :, :], fmt)
