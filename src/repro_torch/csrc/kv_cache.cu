// K3 and K4: the posit-coded KV ring of serving decode.
//
// K3 kv_append_rows_kernel replaces repro/kernels/kv_cache.py::kv_append_rows
// (Pallas; kv_append is its T=1 case).  K4, kv_rows.cuh's split_kernel +
// combine_kernel over ring rows, replaces
// repro/kernels/kv_cache.py::decode_attention (Pallas).  Their bodies are
// kv_rows.cuh's encode_row and attention_split / attention_combine; K6
// (paged_kv.cu) runs the same split walk through its page table.  This
// file holds the ring addressing.
//
// Layouts (row-major, contiguous):
//   k/v_new   (B, T, H, hd) f32          q    (B*nkv, grp, hd) f32 or bf16
//   k/v_codes (B, W, H, Dc) codes        out  (B*nkv, grp, hd) q's type
//   k/v_scale (B, W, H) f32              pos, cache_len  (B,) int32
// Dc = hd, or hd/2 for 4-bit codes nibble-packed split-half (byte j holds
// element j in its low nibble and element j + hd/2 in its high nibble).
#include "kv_rows.cuh"

namespace {

// ---------------------------------------------------------------------------
// K3: encode-on-write ring append.
//
// Bound on the H100: at T=1 (every decode layer) it moves a few KB, so
// launch latency, not bytes or operations, sets its time; at prefill
// (T = bucket) it is bytes-bound (4 B read per element, 1-2 B written).
// Design: one warp per (b, t, head) row of K or V (kv::encode_row).  Only
// ring row (pos[b] + t) mod W is written; nothing else in the ring moves.
// ---------------------------------------------------------------------------
template <int N, int ES>
__global__ void kv_append_rows_kernel(
    const float* __restrict__ k_new, const float* __restrict__ v_new,
    typename posit::Code<N>::type* __restrict__ k_codes,
    float* __restrict__ k_scale,
    typename posit::Code<N>::type* __restrict__ v_codes,
    float* __restrict__ v_scale, const int* __restrict__ pos, int B, int T,
    int H, int hd, int W, int bias) {
  __shared__ uint8_t nib[kv::kAppendWarps][kv::kMaxHd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long rows = (long long)B * T * H;
  const long long row = (long long)blockIdx.x * kv::kAppendWarps + warp;
  if (row >= 2 * rows) return;             // whole warp leaves together
  const bool is_v = row >= rows;
  const long long r = is_v ? row - rows : row;  // (b, t, h) row index
  const int h = (int)(r % H);
  const int t = (int)((r / H) % T);
  const int b = (int)(r / ((long long)H * T));
  const int ring = (pos[b] + t) % W;
  const long long dst = ((long long)b * W + ring) * H + h;
  const int dc = N <= 4 ? hd / 2 : hd;
  kv::encode_row<N, ES>((is_v ? v_new : k_new) + r * hd, hd,
                        (is_v ? v_codes : k_codes) + dst * dc,
                        (is_v ? v_scale : k_scale) + dst, nib[warp], lane,
                        bias);
}

// ---------------------------------------------------------------------------
// K4: fused decode-on-read one-token GQA attention over the ring, as a split
// walk across CTAs (flash-decoding) and a combine.
//
// Bound on the H100: device-memory bytes -- every live K/V code and scale is
// read once (~2 * B * len * nkv * (Dc + 4) bytes per layer) against ~4 flops
// per decoded element; at B=8 and a few thousand live rows that is under a
// microsecond, so the two launches and a round trip of loads set the floor.
// Design: K6's (kv::launch_split_walk), with ring rows in place of the page
// table: a CTA per (slot, kv-head, SR-row split) reads ring rows [0,
// min(cache_len[b], W)) -- all W, every score masked, where cache_len[b] <=
// 0 -- so no table load sits in front of a row's loads; splits past the
// live length leave at once.  q is scaled by hd^-0.5 in q's type inside,
// and the combine writes the output in q's type.
// ---------------------------------------------------------------------------
struct RingRows {
  long long first;   // b * W: the slot's first ring row
  int nkv, h;
  __device__ long long operator()(int j) const {
    return (first + j) * nkv + h;
  }
};

struct RingLayout {
  int W, nkv;
  __device__ RingRows rows(int b, int h) const {
    return RingRows{(long long)b * W, nkv, h};
  }
};

}  // namespace

extern "C" int kv_append_rows(const void* k_new, const void* v_new,
                              void* k_codes, void* k_scale, void* v_codes,
                              void* v_scale, const void* pos, int B, int T,
                              int H, int hd, int W, int nbits, int es,
                              int bias, void* stream) {
  if (hd > kv::kMaxHd) return (int)cudaErrorInvalidValue;
  const long long blocks = kv::append_blocks(B, T, H);
  if (blocks == 0) return 0;
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define APPEND_CASE(N, ES)                                                    \
  if (nbits == N && es == ES) {                                               \
    using CodeT = posit::Code<N>::type;                                       \
    kv_append_rows_kernel<N, ES>                                              \
        <<<(int)blocks, 32 * kv::kAppendWarps, 0, st>>>(                      \
            (const float*)k_new, (const float*)v_new, (CodeT*)k_codes,        \
            (float*)k_scale, (CodeT*)v_codes, (float*)v_scale,                \
            (const int*)pos, B, T, H, hd, W, bias);                           \
    return (int)cudaGetLastError();                                           \
  }
  POSIT_FORMATS(APPEND_CASE)
#undef APPEND_CASE
  return (int)cudaErrorInvalidValue;
}

// q (B, nkv, grp, hd) and out in q's type (f32, or bf16 with q_bf16), part
// a (B * nkv, S, grp, hd + 2) f32 workspace, S = ceil(W / SR).  Rows of
// codes must be 4 * 2^i bytes, at most 512.
extern "C" int decode_attention(const void* q, const void* k_codes,
                                const void* k_scale, const void* v_codes,
                                const void* v_scale, const void* cache_len,
                                void* out, void* part, int B, int nkv,
                                int grp, int hd, int W, int nbits, int es,
                                int bias, int q_bf16, int SR, float qscale,
                                void* stream) {
  return kv::launch_split_walk(
      RingLayout{W, nkv}, q, k_codes, k_scale, v_codes, v_scale, cache_len,
      out, part, B, nkv, grp, hd, W, nbits, es, bias, q_bf16, SR, qscale,
      (cudaStream_t)stream);
}
