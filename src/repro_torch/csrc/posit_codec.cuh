// Posit codec for Hopper: device-inline decode and encode, templated on
// <N, ES>, shared by every kernel of the port (K1..K7).
//
// Port of the Pallas bodies repro/kernels/posit_decode.py::decode_tile and
// repro/kernels/posit_encode.py::encode_tile.  Both are branch-free: every
// code or value takes one straight-line path of integer ops and selects, so
// the decodes or encodes a thread holds overlap.
//
// Decode (the read path of K1, K4, K6 and K7) finds the regime's run length
// with one count of leading zeros (__clz) where Algorithm 1 runs n-1
// threshold compares; the function is the same bit for bit.  The compares
// mirror the TALU datapath, where they run in parallel in silicon; on an SM
// they would be n-1 dependent instructions.  The plain PyTorch version
// (repro_torch/core/posit.py decode_to_f32) and the reference keep
// Algorithm 1, and tests/test_torch_decoder.py holds a numpy model of this
// decoder's integer steps to both on every code of every built format
// (chip_smoke.py holds K1 to the plain version on the card).  Encode is
// bit-exact RNE with guard/sticky, saturating to maxpos/minpos; NaN/inf ->
// NaR; float32 subnormals are flushed to zero: the write path of K2, K3
// and K5.  K2's wire mode (the gradient wire of optim/compression.py)
// encodes them as core.posit.encode_f32 does.
//
// Static SASS per element (sm_90a, scripts/encoder_sass.py: a one-element
// kernel less its skeleton, NVIDIA H100): decode 20 for posit8_2, 21 for
// posit16_2, 19 for posit8_0, 20 for posit4_1, 23 for decode_es<16> (es at
// run time); the decoder it replaced (Algorithm 1's compares, two early
// returns, clamped shifts) took 70, 95, 58 and 56.  Encode 29 for posit8_2
// and posit16_2, 26 for ES = 0, 30 for posit4_1; the branching encoder it
// replaced took 84-85 (ES > 0) and 65-66 (ES = 0).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace posit {

// Storage type of one code: uint8 up to 8 bits, else the 16-bit pattern.
template <int N>
struct Code {
  using type = typename std::conditional<(N <= 8), uint8_t, uint16_t>::type;
};

// Posit code (low N bits of `code`; higher bits are ignored) -> float32,
// with the exponent size `es` a run-time argument (K7 takes the format at
// run time).  Exact for N <= 16.
//
// One shift puts the code at the top of a 32-bit word, so the sign is bit
// 31 and the bits above N drop out; |code| by two's complement (the
// arithmetic sign mask); one more shift left-aligns the N - 1 body bits.
// The regime run r is the count of leading zeros of the body, or of its
// complement when the body leads with a one (body XOR its arithmetic sign
// mask); k is r - 1 or -r by one select.  r <= N - 1 for every code but 0
// and NaR (whose body is 0), so it needs no clamp.  The clamped funnel
// shift (shf.l.clamp: 0 at a shift >= 32) drops the run and its
// terminator, leaving exponent then fraction at the top of `rest`; the
// exponent is its top es bits (0 for es = 0: the same clamped shift), and
// exponent bits the regime cut off read as zeros, which is the posit rule.
// The fraction (at most N - 3 <= 13 bits) goes into the mantissa with one
// shift.  0 -> +0 and NaR -> the quiet NaN 0x7FC00000 are one select on a
// zero body at the end.
template <int N>
__device__ __forceinline__ float decode_es(uint32_t code, int es, int bias) {
  static_assert(N >= 3 && N <= 16, "decode is exact for 3 <= N <= 16");
  const uint32_t x = code << (32 - N);                   // sign at bit 31
  const uint32_t sx = (uint32_t)((int32_t)x >> 31);      // 0 or all ones
  const uint32_t body = ((x ^ sx) - sx) << 1;            // |code|'s body
  const uint32_t lead = body >> 31;
  const int r = __clz(body ^ (uint32_t)((int32_t)body >> 31));
  const int k = lead ? r - 1 : -r;
  const uint32_t rest = __funnelshift_lc(0u, body, (uint32_t)(r + 1));
  const uint32_t e = __funnelshift_rc(rest, 0u, (uint32_t)(32 - es));
  const int t = k * (1 << es) + (int)e + bias;
  const uint32_t v = (x & 0x80000000u) | ((uint32_t)(t + 127) << 23) |
                     ((rest << es) >> 9);
  return __uint_as_float(body == 0u ? sx & 0x7FC00000u : v);
}

// The same decoder with ES a template constant, which the compiler folds.
template <int N, int ES>
__device__ __forceinline__ float decode(uint32_t code, int bias) {
  return decode_es<N>(code, ES, bias);
}

// float32 -> posit code (low N bits), RNE; float32 subnormals flushed, or
// with kNormalize (K2's wire mode alone) encoded as core.posit.encode_f32
// encodes them.
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
// subnormals and NaN/inf are selects at the end.  A posit has no
// underflow, so a normalised subnormal rounds to +-minpos whenever its
// regime saturates, k = (-127 - bias) >> ES <= -(N - 1) at the largest
// one: with kNormalize a nonzero subnormal gives +-minpos (body 1 with the
// sign applied), which is encode_f32's code under that condition (the
// wrapper refuses a bias that breaks it).  Without kNormalize the select
// is the one the flush has always compiled to.
// tests/test_torch_encoder.py models these integer steps in numpy.
template <int N, int ES, bool kNormalize = false>
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
  uint32_t tiny = 0u;                          // zero and flushed subnormals
  if constexpr (kNormalize)                    // +-minpos for a subnormal
    tiny = (bits << 1) == 0u ? 0u : ((1u ^ (0u - s)) + s) & ((1u << N) - 1u);
  return exp_raw == 255u ? 1u << (N - 1)       // inf/NaN -> NaR
         : exp_raw == 0u ? tiny
                         : code;
}

}  // namespace posit

// The formats every kernel is instantiated for: X(N, ES).
#define POSIT_FORMATS(X) \
  X(4, 1) X(8, 0) X(8, 1) X(8, 2) X(16, 0) X(16, 1) X(16, 2)
