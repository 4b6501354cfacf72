// K3 and K4: the posit-coded KV ring of serving decode.
//
// K3 kv_append_rows_kernel replaces repro/kernels/kv_cache.py::kv_append_rows
// (Pallas; kv_append is its T=1 case).  K4 decode_attention_kernel replaces
// repro/kernels/kv_cache.py::decode_attention (Pallas).
//
// Layouts (row-major, contiguous):
//   k/v_new   (B, T, H, hd) f32          q    (B*nkv, grp, hd) f32, pre-scaled
//   k/v_codes (B, W, H, Dc) codes        out  (B*nkv, grp, hd) f32
//   k/v_scale (B, W, H) f32              pos, cache_len  (B,) int32
// Dc = hd, or hd/2 for 4-bit codes nibble-packed split-half (byte j holds
// element j in its low nibble and element j + hd/2 in its high nibble).
#include "posit_codec.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// K3: encode-on-write ring append.
//
// Bound on the H100: at T=1 (every decode layer) it moves a few KB, so
// launch latency, not bytes or operations, sets its time; at prefill
// (T = bucket) it is bytes-bound (4 B read per element, 1-2 B written).
// Design: one warp per (b, t, head) row of K or V -- each lane owns hd/32
// elements, a shuffle reduction gives the row's sum |x| in f32, the pow2
// scale is the exponent bits of max(mean, 1e-30), and every lane encodes its
// elements with the flushing encoder.  4-bit codes meet their split-half
// partner through the warp's slice of shared memory.  Only ring row
// (pos[b] + t) mod W is written; nothing else in the ring moves.
// ---------------------------------------------------------------------------
constexpr int kAppendWarps = 4;
constexpr int kMaxHd = 256;

template <int N, int ES>
__global__ void kv_append_rows_kernel(
    const float* __restrict__ k_new, const float* __restrict__ v_new,
    typename posit::Code<N>::type* __restrict__ k_codes,
    float* __restrict__ k_scale,
    typename posit::Code<N>::type* __restrict__ v_codes,
    float* __restrict__ v_scale, const int* __restrict__ pos, int B, int T,
    int H, int hd, int W, int bias) {
  using CodeT = typename posit::Code<N>::type;
  constexpr bool kPacked = N <= 4;
  __shared__ uint8_t nib[kAppendWarps][kMaxHd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long rows = (long long)B * T * H;
  const long long row = (long long)blockIdx.x * kAppendWarps + warp;
  if (row >= 2 * rows) return;             // whole warp leaves together
  const bool is_v = row >= rows;
  const long long r = is_v ? row - rows : row;  // (b, t, h) row index
  const int h = (int)(r % H);
  const int t = (int)((r / H) % T);
  const int b = (int)(r / ((long long)H * T));
  const float* x = (is_v ? v_new : k_new) + r * hd;

  float sum = 0.f;
  for (int j = lane; j < hd; j += 32) sum += fabsf(x[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
  const float mean = sum / (float)hd;
  const float m = isnan(mean) ? mean : fmaxf(mean, 1e-30f);  // NaN propagates
  const float scale = __uint_as_float(__float_as_uint(m) & 0x7F800000u);

  const int ring = (pos[b] + t) % W;
  const long long dst = ((long long)b * W + ring) * H + h;
  const int dc = kPacked ? hd / 2 : hd;
  CodeT* out = (is_v ? v_codes : k_codes) + dst * dc;
  for (int j = lane; j < hd; j += 32) {
    const uint32_t c = posit::encode<N, ES>(x[j] / scale, bias);
    if (kPacked)
      nib[warp][j] = (uint8_t)c;
    else
      out[j] = (CodeT)c;
  }
  if (kPacked) {
    __syncwarp();
    for (int j = lane; j < dc; j += 32)
      out[j] = (CodeT)(nib[warp][j] | (nib[warp][j + dc] << 4));
  }
  if (lane == 0) (is_v ? v_scale : k_scale)[dst] = scale;
}

// ---------------------------------------------------------------------------
// K4: fused decode-on-read one-token GQA attention.
//
// Bound on the H100: device-memory bytes -- every live K/V code and scale is
// read once (~2 * B * len * nkv * (Dc + 4) bytes per layer) against ~4 flops
// per decoded element.  Design: one CTA per (slot, kv-head) row holds that
// row's grp query rows in shared memory and walks the ring in blocks of 64
// rows, stopping at the block that holds cache_len[b] (later rows would
// only add exact zeros).  Each block's codes are decoded x scale into shared
// memory (K rows padded by one float against bank conflicts), scores and the
// online softmax (m, l, acc) are kept in f32 in shared memory; full-precision
// K/V never touch device memory.  One CTA per row leaves SMs idle at small
// batch: splitting the walk across CTAs (flash-decoding) is later work.
// A slot with cache_len <= 0 has every row masked: as in the dense masked
// softmax, all W rows then weigh equally and the output is the mean of V.
// ---------------------------------------------------------------------------
constexpr int kAttnThreads = 128;
constexpr int kBlockRows = 64;

template <int N, int ES>
__global__ void decode_attention_kernel(
    const float* __restrict__ q,
    const typename posit::Code<N>::type* __restrict__ k_codes,
    const float* __restrict__ k_scale,
    const typename posit::Code<N>::type* __restrict__ v_codes,
    const float* __restrict__ v_scale, const int* __restrict__ cache_len,
    float* __restrict__ out, int nkv, int grp, int hd, int W, int bias) {
  constexpr bool kPacked = N <= 4;
  extern __shared__ float sm[];
  const int ldk = hd + 1;
  float* ks = sm;                               // kBlockRows x ldk
  float* vs = ks + kBlockRows * ldk;            // kBlockRows x hd
  float* qs = vs + kBlockRows * hd;             // grp x hd
  float* ps = qs + grp * hd;                    // grp x kBlockRows
  float* acc = ps + grp * kBlockRows;           // grp x hd
  float* ms = acc + grp * hd;                   // grp
  float* ls = ms + grp;                         // grp
  float* corr = ls + grp;                       // grp

  const int rowid = blockIdx.x;                 // b * nkv + h
  const int b = rowid / nkv, h = rowid % nkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nwarps = kAttnThreads / 32;
  const int dc = kPacked ? hd / 2 : hd;

  for (int e = tid; e < grp * hd; e += kAttnThreads) {
    qs[e] = q[(long long)rowid * grp * hd + e];
    acc[e] = 0.f;
  }
  for (int g = tid; g < grp; g += kAttnThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  const bool masked = cache_len[b] <= 0;        // every score is kNegInf
  const int len = masked ? W : min(cache_len[b], W);

  for (int base = 0; base < len; base += kBlockRows) {
    const int nb = min(kBlockRows, len - base);   // live rows this block
    __syncthreads();   // previous block's readers are done with ks/vs/ps
    // decode-on-read: codes x scale -> f32 tiles in shared memory
    for (int e = tid; e < nb * dc; e += kAttnThreads) {
      const int j = e / dc, c = e % dc;
      const long long off = ((long long)b * W + base + j) * nkv + h;
      const float sk = k_scale[off], sv = v_scale[off];
      const uint32_t kc = k_codes[off * dc + c], vc = v_codes[off * dc + c];
      if (kPacked) {
        ks[j * ldk + c] = posit::decode<N, ES>(kc & 0xFu, bias) * sk;
        ks[j * ldk + c + dc] = posit::decode<N, ES>(kc >> 4, bias) * sk;
        vs[j * hd + c] = posit::decode<N, ES>(vc & 0xFu, bias) * sv;
        vs[j * hd + c + dc] = posit::decode<N, ES>(vc >> 4, bias) * sv;
      } else {
        ks[j * ldk + c] = posit::decode<N, ES>(kc, bias) * sk;
        vs[j * hd + c] = posit::decode<N, ES>(vc, bias) * sv;
      }
    }
    __syncthreads();
    // scores s[g][j] = q_g . k_j over the live rows
    for (int e = tid; e < grp * kBlockRows; e += kAttnThreads) {
      const int g = e / kBlockRows, j = e % kBlockRows;
      float s = kNegInf;
      if (j < nb && !masked) {
        s = 0.f;
        for (int d = 0; d < hd; ++d) s += qs[g * hd + d] * ks[j * ldk + d];
      }
      ps[e] = s;
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int g = warp; g < grp; g += nwarps) {
      float mx = kNegInf;
      for (int j = lane; j < kBlockRows; j += 32) mx = fmaxf(mx, ps[g * kBlockRows + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
      const float m_new = fmaxf(ms[g], mx);
      float psum = 0.f;
      for (int j = lane; j < kBlockRows; j += 32) {
        const float p = j < nb ? expf(ps[g * kBlockRows + j] - m_new) : 0.f;
        ps[g * kBlockRows + j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xFFFFFFFFu, psum, o);
      if (lane == 0) {
        const float c = expf(ms[g] - m_new);
        corr[g] = c;
        ls[g] = ls[g] * c + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ V
    for (int e = tid; e < grp * hd; e += kAttnThreads) {
      const int g = e / hd, d = e % hd;
      float a = 0.f;
      for (int j = 0; j < nb; ++j) a += ps[g * kBlockRows + j] * vs[j * hd + d];
      acc[e] = acc[e] * corr[g] + a;
    }
  }
  __syncthreads();
  for (int e = tid; e < grp * hd; e += kAttnThreads)
    out[(long long)rowid * grp * hd + e] = acc[e] / fmaxf(ls[e / hd], 1e-30f);
}

}  // namespace

extern "C" int kv_append_rows(const void* k_new, const void* v_new,
                              void* k_codes, void* k_scale, void* v_codes,
                              void* v_scale, const void* pos, int B, int T,
                              int H, int hd, int W, int nbits, int es,
                              int bias, void* stream) {
  if (hd > kMaxHd) return (int)cudaErrorInvalidValue;
  const long long warps = 2LL * B * T * H;
  const long long blocks = (warps + kAppendWarps - 1) / kAppendWarps;
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define APPEND_CASE(N, ES)                                                    \
  if (nbits == N && es == ES) {                                               \
    using CodeT = posit::Code<N>::type;                                       \
    kv_append_rows_kernel<N, ES><<<(int)blocks, 32 * kAppendWarps, 0, st>>>(  \
        (const float*)k_new, (const float*)v_new, (CodeT*)k_codes,            \
        (float*)k_scale, (CodeT*)v_codes, (float*)v_scale, (const int*)pos,   \
        B, T, H, hd, W, bias);                                                \
    return (int)cudaGetLastError();                                           \
  }
  POSIT_FORMATS(APPEND_CASE)
#undef APPEND_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int decode_attention(const void* q, const void* k_codes,
                                const void* k_scale, const void* v_codes,
                                const void* v_scale, const void* cache_len,
                                void* out, int B, int nkv, int grp, int hd,
                                int W, int nbits, int es, int bias,
                                void* stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBlockRows * (hd + 1) + (size_t)kBlockRows * hd +
       2 * (size_t)grp * hd + (size_t)grp * kBlockRows + 3 * (size_t)grp);
  if (B * nkv == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define ATTN_CASE(N, ES)                                                      \
  if (nbits == N && es == ES) {                                               \
    using CodeT = posit::Code<N>::type;                                       \
    auto kern = decode_attention_kernel<N, ES>;                               \
    if (smem > 48 * 1024) {                                                   \
      cudaError_t err = cudaFuncSetAttribute(                                 \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);      \
      if (err != cudaSuccess) return (int)err;                                \
    }                                                                         \
    kern<<<B * nkv, kAttnThreads, smem, st>>>(                                \
        (const float*)q, (const CodeT*)k_codes, (const float*)k_scale,        \
        (const CodeT*)v_codes, (const float*)v_scale,                         \
        (const int*)cache_len, (float*)out, nkv, grp, hd, W, bias);           \
    return (int)cudaGetLastError();                                           \
  }
  POSIT_FORMATS(ATTN_CASE)
#undef ATTN_CASE
  return (int)cudaErrorInvalidValue;
}
