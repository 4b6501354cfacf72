// K5 and K6: the paged posit-KV pool of serving decode.
//
// K5 paged_kv_append_rows_kernel replaces
// repro/kernels/paged_kv.py::paged_kv_append_rows (Pallas; paged_kv_append
// is its T=1 case).  K6 paged_decode_split_kernel + paged_decode_combine_
// kernel replace repro/kernels/paged_kv.py::paged_decode_attention
// (Pallas).  Their bodies are kv_rows.cuh's encode_row (shared with the
// ring's K3, kv_cache.cu) and attention_split / attention_combine; this
// file holds the pool addressing.
//
// Layouts (row-major, contiguous):
//   k/v_new    (B, T, H, hd) f32         q    (B*nkv, grp, hd) f32 or bf16
//   k/v_codes  (R, H, Dc) codes          out  (B*nkv, grp, hd) q's type
//   k/v_scale  (R, H) f32                page_table (B, Pmax) int32
//   dst        (B, T) int32 flat rows    seq_lens   (B,) int32
// R = num_pages * ps; page p owns flat rows [p*ps, (p+1)*ps); page 0 is the
// trash page that idle slots and unallocated table entries point at.
#include "kv_rows.cuh"

namespace {

// ---------------------------------------------------------------------------
// K5: encode-on-write append into table-addressed pool rows.
//
// Bound on the H100: at T=1 (every decode layer; B=8, nkv=4, hd=64, posit8)
// it moves ~20.8 KB, 0.006 us at 3.35 TB/s, so launch latency sets its time;
// at T=16 ~0.33 MB (0.10 us), bytes-bound.  Design: K3's, one warp per
// (b, t, head) row of K or V (kv::encode_row), with the destination taken
// from dst[b, t] instead of the ring position.  Idle slots all point at the
// trash page, so several warps may write one trash row in no set order:
// benign, and no check compares trash rows.  A dst row outside [0, R) is
// skipped rather than written out of bounds.
// ---------------------------------------------------------------------------
template <int N, int ES>
__global__ void paged_kv_append_rows_kernel(
    const float* __restrict__ k_new, const float* __restrict__ v_new,
    typename posit::Code<N>::type* __restrict__ k_codes,
    float* __restrict__ k_scale,
    typename posit::Code<N>::type* __restrict__ v_codes,
    float* __restrict__ v_scale, const int* __restrict__ dst, int B, int T,
    int H, int hd, int R, int bias) {
  __shared__ uint8_t nib[kv::kAppendWarps][kv::kMaxHd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long rows = (long long)B * T * H;
  const long long row = (long long)blockIdx.x * kv::kAppendWarps + warp;
  if (row >= 2 * rows) return;             // whole warp leaves together
  const bool is_v = row >= rows;
  const long long r = is_v ? row - rows : row;  // (b, t, h) row index
  const int h = (int)(r % H);
  const int flat = dst[r / H];                  // dst[b, t]
  if (flat < 0 || flat >= R) return;
  const long long off = (long long)flat * H + h;
  const int dc = N <= 4 ? hd / 2 : hd;
  kv::encode_row<N, ES>((is_v ? v_new : k_new) + r * hd, hd,
                        (is_v ? v_codes : k_codes) + off * dc,
                        (is_v ? v_scale : k_scale) + off, nib[warp], lane,
                        bias);
}

// ---------------------------------------------------------------------------
// K6: page-walking fused decode-on-read one-token GQA attention, as a split
// walk across CTAs (flash-decoding) and a combine.
//
// Bound on the H100: device-memory bytes, as K4 -- each live row's codes and
// scale are read once (at B=8, nkv=4, hd=64, posit8 and seq_lens
// {1,17,128,129,500,1000,1023,1024}: 3,822 rows, 2.08 MB, 0.62 us), so the
// latency of the two launches sets the floor.  Design: not the Pallas grid
// (B, nkv, Pmax) carried over -- blocks run in no order, so nothing can
// carry (m, l, acc) across a grid axis.  Kernel A has a CTA per (slot,
// kv-head, SR-row split): it scales its q rows by hd^-0.5 in q's type, loads
// its own page-table entries (no scalar prefetch on Hopper; clipped to
// [0, num_pages), as in the reference) and runs kv::attention_split, so a
// slot's rows are walked by ceil(len / SR) SMs at once with many rows in
// flight on each; kernel B merges a slot's live splits with log-sum-exp
// weights and writes the output in q's type.  seq_lens[b] <= 0 walks all
// Pmax pages with every score masked, which gives the mean of V over the
// listed pages, trash included.
// ---------------------------------------------------------------------------
struct PageRows {
  const int* table;  // the slot's (Pmax,) page-table row
  int ps, num_pages, nkv, h;
  __device__ long long operator()(int j) const {
    const int p = min(max(table[j / ps], 0), num_pages - 1);
    return ((long long)p * ps + j % ps) * nkv + h;
  }
};

template <int N, int ES, int VB, typename QT>
__global__ void __launch_bounds__(kv::kSplitThreads)
    paged_decode_split_kernel(
        const QT* __restrict__ q,
        const typename posit::Code<N>::type* __restrict__ k_codes,
        const float* __restrict__ k_scale,
        const typename posit::Code<N>::type* __restrict__ v_codes,
        const float* __restrict__ v_scale,
        const int* __restrict__ page_table, const int* __restrict__ seq_lens,
        float* __restrict__ part, int nkv, int grp, int hd, int ps, int pmax,
        int num_pages, int bias, float qscale, int SR, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowid = blockIdx.x, split = blockIdx.y;   // rowid = b * nkv + h
  const int b = rowid / nkv, h = rowid % nkv;
  kv::attention_split<N, ES, VB>(
      q + (long long)rowid * grp * hd, qscale, k_codes, k_scale, v_codes,
      v_scale, seq_lens[b], pmax * ps, split * SR, SR,
      PageRows{page_table + (long long)b * pmax, ps, num_pages, nkv, h},
      part + ((long long)rowid * S + split) * grp * (hd + 2), grp, hd, bias,
      smem);
}

template <typename OT>
__global__ void __launch_bounds__(kv::kSplitThreads)
    paged_decode_combine_kernel(const float* __restrict__ part,
                                const int* __restrict__ seq_lens,
                                OT* __restrict__ out, int nkv, int grp,
                                int hd, int W, int SR, int S) {
  const int rowid = blockIdx.x;
  kv::attention_combine<OT>(part + (long long)rowid * S * grp * (hd + 2),
                            seq_lens[rowid / nkv], W, SR, S,
                            out + (long long)rowid * grp * hd, grp, hd);
}

template <int N, int ES, int VB, typename QT>
int launch_split(const void* q, const void* k_codes, const void* k_scale,
                 const void* v_codes, const void* v_scale,
                 const void* page_table, const void* seq_lens, void* out,
                 void* part, int B, int nkv, int grp, int hd, int ps,
                 int pmax, int num_pages, int bias, float qscale, int SR,
                 cudaStream_t st) {
  using CodeT = typename posit::Code<N>::type;
  const int S = (pmax * ps + SR - 1) / SR;
  const size_t smem = kv::split_smem_bytes(grp, hd, SR);
  auto kern = paged_decode_split_kernel<N, ES, VB, QT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<dim3(B * nkv, S), kv::kSplitThreads, smem, st>>>(
      (const QT*)q, (const CodeT*)k_codes, (const float*)k_scale,
      (const CodeT*)v_codes, (const float*)v_scale, (const int*)page_table,
      (const int*)seq_lens, (float*)part, nkv, grp, hd, ps, pmax, num_pages,
      bias, qscale, SR, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<QT><<<B * nkv, kv::kSplitThreads, 0, st>>>(
      (const float*)part, (const int*)seq_lens, (QT*)out, nkv, grp, hd,
      pmax * ps, SR, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_kv_append_rows(const void* k_new, const void* v_new,
                                    void* k_codes, void* k_scale,
                                    void* v_codes, void* v_scale,
                                    const void* dst, int B, int T, int H,
                                    int hd, int R, int nbits, int es,
                                    int bias, void* stream) {
  if (hd > kv::kMaxHd) return (int)cudaErrorInvalidValue;
  const long long blocks = kv::append_blocks(B, T, H);
  if (blocks == 0) return 0;
  if (blocks < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define APPEND_CASE(N, ES)                                                    \
  if (nbits == N && es == ES) {                                               \
    using CodeT = posit::Code<N>::type;                                       \
    paged_kv_append_rows_kernel<N, ES>                                        \
        <<<(int)blocks, 32 * kv::kAppendWarps, 0, st>>>(                      \
            (const float*)k_new, (const float*)v_new, (CodeT*)k_codes,        \
            (float*)k_scale, (CodeT*)v_codes, (float*)v_scale,                \
            (const int*)dst, B, T, H, hd, R, bias);                           \
    return (int)cudaGetLastError();                                           \
  }
  POSIT_FORMATS(APPEND_CASE)
#undef APPEND_CASE
  return (int)cudaErrorInvalidValue;
}

// q (B, nkv, grp, hd) and out in q's type (f32, or bf16 with q_bf16), part
// a (B * nkv, S, grp, hd + 2) f32 workspace, S = ceil(Pmax * ps / SR).  Rows
// of codes must be 4 * 2^i bytes, at most 512.
extern "C" int paged_decode_attention(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, const void* page_table,
    const void* seq_lens, void* out, void* part, int B, int nkv, int grp,
    int hd, int ps, int pmax, int num_pages, int nbits, int es, int bias,
    int q_bf16, int SR, float qscale, void* stream) {
  if (ps < 1 || pmax < 1 || num_pages < 1 || SR < 1 || grp < 1 || grp > 128)
    return (int)cudaErrorInvalidValue;
  if (B * nkv == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int row_bytes = nbits <= 4 ? hd / 2 : hd * (nbits / 8);
  const bool al16 = (((uintptr_t)k_codes | (uintptr_t)v_codes) & 15) == 0;
  const bool al4 = (((uintptr_t)k_codes | (uintptr_t)v_codes) & 3) == 0;
  const int vb = row_bytes % 16 == 0 && al16 ? 16
                 : row_bytes % 4 == 0 && al4 ? 4 : 0;
  const int lpr = vb ? row_bytes / vb : 0;
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) || (nbits <= 4 && hd % 2))
    return (int)cudaErrorInvalidValue;
#define SPLIT_CASE(N, ES)                                                     \
  if (nbits == N && es == ES) {                                               \
    auto go = [&](auto vbt, auto qt) {                                        \
      return launch_split<N, ES, decltype(vbt)::value, decltype(qt)>(         \
          q, k_codes, k_scale, v_codes, v_scale, page_table, seq_lens, out,   \
          part, B, nkv, grp, hd, ps, pmax, num_pages, bias, qscale, SR, st);   \
    };                                                                        \
    using V16 = std::integral_constant<int, 16>;                              \
    using V4 = std::integral_constant<int, 4>;                                \
    if (vb == 16)                                                             \
      return q_bf16 ? go(V16{}, __nv_bfloat16{}) : go(V16{}, float{});        \
    return q_bf16 ? go(V4{}, __nv_bfloat16{}) : go(V4{}, float{});            \
  }
  POSIT_FORMATS(SPLIT_CASE)
#undef SPLIT_CASE
  return (int)cudaErrorInvalidValue;
}
