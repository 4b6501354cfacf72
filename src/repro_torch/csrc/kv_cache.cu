// K3 and K4: the posit-coded KV ring of serving decode.
//
// K3, kv_rows.cuh's append_kernel with ring destinations, replaces
// repro/kernels/kv_cache.py::kv_append_rows (Pallas; kv_append is its T=1
// case).  K4, kv_rows.cuh's split_kernel + combine_kernel over ring rows,
// replaces repro/kernels/kv_cache.py::decode_attention (Pallas).  K5 and K6
// (paged_kv.cu) run the same append and split walk through their page
// table: this file holds the ring addressing.
//
// Layouts (row-major; k/v_new with the strides given, the rest contiguous):
//   k/v_new   (B, T, H, hd) f32 or bf16  q    (B*nkv, grp, hd) f32 or bf16
//   k/v_codes (B, W, H, Dc) codes        out  (B*nkv, grp, hd) q's type
//   k/v_scale (B, W, H) f32              pos, cache_len  (B,) int32
// Dc = hd, or hd/2 for 4-bit codes nibble-packed split-half (byte j holds
// element j in its low nibble and element j + hd/2 in its high nibble).
#include "kv_rows.cuh"

namespace {

// ---------------------------------------------------------------------------
// K3: encode-on-write ring append.
//
// Bound on the H100: at T=1 (every decode layer; B=8, nkv=4, hd=64, posit8)
// it moves ~12.6 KB from the model's bf16 rows (~20.8 KB from f32), 0.004-
// 0.006 us at 3.35 TB/s, so launch latency and the chain of dependent loads
// set its time; at prefill (T = bucket) it is bytes-bound.  Design: K5's
// (kv::launch_append): a group of (row bytes) / 16 lanes per (b, t, head)
// row, read in the model's dtype at its strides, so the caller launches no
// cast; RingDst computes ring row (pos[b] + t) mod W from one int per slot,
// loaded beside the row.  A ring row is always in range; nothing else in
// the ring moves.
// ---------------------------------------------------------------------------
struct RingDst {
  const int* pos;   // (B,)
  int W;
  __device__ long long operator()(int b, int t, bool live) const {
    int r = (pos[b] + t) % W;     // pos + t < 2^31; a floor mod, as the
    r += r < 0 ? W : 0;           // reference's
    return live ? (long long)b * W + r : -1;
  }
};

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

// k/v_new rows of hd f32 (x_bf16 0) or bf16 (x_bf16 1) elements at the
// element strides given (kv::launch_append has the limits).  Returns a
// CUDA error code, 0 on success.
extern "C" int kv_append_rows(
    const void* k_new, const void* v_new, void* k_codes, void* k_scale,
    void* v_codes, void* v_scale, const void* pos, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, int B, int T, int H, int hd, int W, int nbits, int es,
    int bias, int x_bf16, void* stream) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  return kv::launch_append(RingDst{(const int*)pos, W}, k_new, v_new,
                           k_codes, k_scale, v_codes, v_scale,
                           kv::RowStrides{ksb, kst, ksh},
                           kv::RowStrides{vsb, vst, vsh}, B, T, H, hd, nbits,
                           es, bias, x_bf16, (cudaStream_t)stream);
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
