// Posit codec for Hopper: device-inline decode and encode, templated on
// <N, ES>, shared by every kernel of the port (K1..K4).
//
// Port of the Pallas bodies repro/kernels/posit_decode.py::decode_tile and
// repro/kernels/posit_encode.py::encode_tile.  Decode keeps Algorithm 1's
// form: the regime run length is the count of n-1 parallel threshold
// compares (no __clz), so this code and the plain PyTorch version
// (repro_torch/core/posit.py) run the same algorithm.  Encode is bit-exact
// RNE with guard/sticky, saturating to maxpos/minpos; NaN/inf -> NaR; float32
// subnormals are flushed to zero.
//
// Shifts by >= 32 are undefined in C++; every variable shift goes through
// the clamped helpers below (a shift by >= 32 gives 0), as in the reference.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace posit {

__device__ __forceinline__ uint32_t mask(uint32_t b) {
  return b >= 32u ? 0xFFFFFFFFu : ((1u << b) - 1u);
}
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t k) {
  return k >= 32u ? 0u : (x << k);
}
__device__ __forceinline__ uint32_t shr(uint32_t x, uint32_t k) {
  return k >= 32u ? 0u : (x >> k);
}
template <int N>
__device__ __forceinline__ uint32_t negate_code(uint32_t u) {
  return (~u + 1u) & mask(N);
}

// Storage type of one code: uint8 up to 8 bits, else the 16-bit pattern.
template <int N>
struct Code {
  using type = typename std::conditional<(N <= 8), uint8_t, uint16_t>::type;
};

// Posit code (low N bits of `code`) -> float32.  Exact for N <= 16.
template <int N, int ES>
__device__ __forceinline__ float decode(uint32_t code, int bias) {
  static_assert(N >= 3 && N <= 16, "decode is exact for 3 <= N <= 16");
  const uint32_t u = code & mask(N);
  if (u == 0u) return 0.0f;
  if (u == (1u << (N - 1))) return __uint_as_float(0x7FC00000u);  // NaR
  const uint32_t s = (u >> (N - 1)) & 1u;
  const uint32_t mag = s ? negate_code<N>(u) : u;
  const uint32_t body = mag & mask(N - 1);
  const uint32_t lead = (body >> (N - 2)) & 1u;
  const uint32_t t_val = lead ? body : (~body & mask(N - 1));
  // Algorithm 1: n-1 parallel threshold compares V_i = T >= 2^{n-1} - 2^i
  int r = 0;
#pragma unroll
  for (int i = 0; i < N - 1; ++i)
    r += t_val >= ((1u << (N - 1)) - (1u << i)) ? 1 : 0;
  const int k = lead ? r - 1 : -r;
  const int rem_i = max(N - 1 - r - 1, 0);
  const uint32_t rem = (uint32_t)rem_i;
  const uint32_t rest = body & mask(rem);
  const uint32_t e_have = min(rem, (uint32_t)ES);
  const uint32_t e_field = shl(shr(rest, rem - e_have), (uint32_t)ES - e_have);
  const uint32_t f_len = (uint32_t)max(rem_i - ES, 0);
  const uint32_t f_field = rest & mask(f_len);
  const int t = k * (1 << ES) + (int)e_field + bias;
  // IEEE-754 assembly (f_len <= 13 <= 23: exact)
  const uint32_t man = shl(f_field, 23u - f_len);
  return __uint_as_float(shl(s, 31) | shl((uint32_t)(t + 127), 23) | man);
}

// float32 -> posit code (low N bits), RNE; float32 subnormals flushed.
template <int N, int ES>
__device__ __forceinline__ uint32_t encode(float x, int bias) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t s = bits >> 31;
  const int exp_raw = (int)((bits >> 23) & 0xFFu);
  const uint32_t frac = bits & 0x7FFFFFu;
  if (exp_raw == 255) return 1u << (N - 1);  // inf/NaN -> NaR
  if (exp_raw == 0) return 0u;               // zero and flushed subnormals
  const int t = exp_raw - 127 - bias;
  const int fw = 23;
  // floor division by 2^ES (written out: >> of a negative int is
  // implementation-defined before C++20)
  const int k = t >= 0 ? (t >> ES) : -((-t + (1 << ES) - 1) >> ES);
  const uint32_t e_field = (uint32_t)(t - k * (1 << ES));
  const bool sat_hi = k >= N - 2;   // regime fills the body: >= maxpos
  const bool sat_lo = k <= -(N - 1);
  const int k_c = min(max(k, -(N - 2)), N - 3);
  const bool pos = k_c >= 0;
  const int w0 = pos ? k_c + 2 : 1 - k_c;
  const uint32_t reg = pos ? shl(mask((uint32_t)(k_c + 1)), 1) : 1u;
  const int avail = N - 1 - w0;
  const int ef_shift = avail + 1 - ES;   // fraction bits incl. guard
  uint32_t efg;
  bool st;
  if (ef_shift >= 0) {
    const uint32_t efp = (uint32_t)ef_shift;
    const uint32_t take = min(efp, (uint32_t)fw);
    const uint32_t fbits = shl(shr(frac, (uint32_t)fw - take), efp - take);
    st = (frac & mask((uint32_t)fw - take)) != 0u;
    efg = shl(e_field, efp) | fbits;
  } else {                               // the exponent itself is cut
    const uint32_t cut = (uint32_t)(-ef_shift);
    efg = shr(e_field, cut);
    st = ((e_field & mask(cut)) != 0u) || (frac != 0u);
  }
  const uint32_t guard = efg & 1u;
  const uint32_t kept = efg >> 1;
  uint32_t body = shl(reg, (uint32_t)avail) | kept;
  body = body + (guard & ((st ? 1u : 0u) | (body & 1u)));
  if (sat_hi) body = mask(N - 1);
  if (sat_lo) body = 1u;
  body = min(max(body, 1u), mask(N - 1));  // never round to 0/NaR
  return s ? negate_code<N>(body) : body;
}

}  // namespace posit

// The formats every kernel is instantiated for: X(N, ES).
#define POSIT_FORMATS(X) \
  X(4, 1) X(8, 0) X(8, 1) X(8, 2) X(16, 0) X(16, 1) X(16, 2)
