// Posit codec for Hopper: device-inline decode and encode, templated on
// <N, ES>, shared by every kernel of the port (K1..K7).
//
// Port of the Pallas bodies repro/kernels/posit_decode.py::decode_tile and
// repro/kernels/posit_encode.py::encode_tile.  Decode keeps Algorithm 1's
// form: the regime run length is the count of n-1 parallel threshold
// compares (no __clz), so this code and the plain PyTorch version
// (repro_torch/core/posit.py) run the same algorithm.  Encode is bit-exact
// RNE with guard/sticky, saturating to maxpos/minpos; NaN/inf -> NaR; float32
// subnormals are flushed to zero.  Encode is branch-free (one 64-bit word,
// one rounding add, one clamp), so the encodes a thread holds overlap: it
// is the write path of K2, K3 and K5.  Its static SASS per element
// (sm_90a, scripts/encoder_sass.py: a one-element kernel less its
// skeleton) is 29 for posit8_2 and posit16_2, 26 for ES = 0, 30 for
// posit4_1; the branching encoder it replaced took 84-85 (ES > 0) and
// 65-66 (ES = 0).
//
// Shifts by >= 32 are undefined in C++; every variable shift of the decoder
// goes through the clamped helpers below (a shift by >= 32 gives 0), as in
// the reference; the encoder's one variable shift is at most N - 2.
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
//
// Branch-free: every input takes one straight-line path of integer ops and
// selects.  The regime k = floor(t / 2^ES) of the total exponent t is
// clamped to [-(N-1), N-2], where the result is already minpos or maxpos,
// so the posit string fits one 64-bit word: a head of 10 (k >= 0) or 01
// (k < 0), then the ES exponent bits, then the 23 fraction bits, in the
// word's high half; an arithmetic shift right by k (or by -k - 1) turns the
// head into the regime run and its terminator.  The body is the word's top
// N - 1 bits, rounded to nearest even by one add of (half - 1) + lsb below
// the cut (the guard and the sticky bits carry into the body exactly when
// RNE rounds up) and one shift; one clamp to [1, 2^(N-1) - 1] keeps
// minpos/maxpos (never 0 or NaR), then the sign is applied.  Zero,
// subnormals and NaN/inf are selects at the end.
// tests/test_torch_encoder.py models these integer steps in numpy.
template <int N, int ES>
__device__ __forceinline__ uint32_t encode(float x, int bias) {
  static_assert(N >= 3 && N <= 16 && ES >= 0 && ES <= 7,
                "the posit string fits 64 bits");
  constexpr int kCut = 65 - N;                 // word bits below the body
  const uint32_t bits = __float_as_uint(x);
  const uint32_t s = bits >> 31;
  const uint32_t exp_raw = (bits >> 23) & 0xFFu;
  const int t = (int)exp_raw - 127 - bias;
  // floor division by 2^ES: nvcc compiles >> of a signed int as an
  // arithmetic shift (shr.s32)
  const int k = min(max(t >> ES, -(N - 1)), N - 2);
  const uint32_t ef = (((uint32_t)t & ((1u << ES) - 1u)) << 23) |
                      (bits & 0x7FFFFFu);      // exponent, fraction
  const int neg = k >> 31;                     // -1 for k < 0, else 0
  const uint32_t hi = ((uint32_t)(2 + neg) << 30) | (ef << (7 - ES));
  // arithmetic shift (shr.s64): 10.. by k gives k + 1 ones then 0; 01.. by
  // -k - 1 gives -k zeros then 1
  const uint64_t word =
      (uint64_t)((int64_t)((uint64_t)hi << 32) >> (k ^ neg));
  const uint64_t lsb = (word >> kCut) & 1u;
  uint32_t body =
      (uint32_t)((word + ((1ull << (kCut - 1)) - 1u) + lsb) >> kCut);
  body = min(max(body, 1u), (1u << (N - 1)) - 1u);
  const uint32_t code = ((body ^ (0u - s)) + s) & ((1u << N) - 1u);
  return exp_raw == 255u ? 1u << (N - 1)       // inf/NaN -> NaR
         : exp_raw == 0u ? 0u                  // zero and flushed subnormals
                         : code;
}

}  // namespace posit

// The formats every kernel is instantiated for: X(N, ES).
#define POSIT_FORMATS(X) \
  X(4, 1) X(8, 0) X(8, 1) X(8, 2) X(16, 0) X(16, 1) X(16, 2)
