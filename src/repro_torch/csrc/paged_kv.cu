// K5 and K6: the paged posit-KV pool of serving decode.
//
// K5 paged_kv_append_rows_kernel replaces
// repro/kernels/paged_kv.py::paged_kv_append_rows (Pallas; paged_kv_append
// is its T=1 case).  K6 paged_decode_attention_kernel replaces
// repro/kernels/paged_kv.py::paged_decode_attention (Pallas).  Their bodies
// are kv_rows.cuh's encode_row and attention_walk, shared with the ring's
// K3 and K4 (kv_cache.cu); this file holds the pool addressing.
//
// Layouts (row-major, contiguous):
//   k/v_new    (B, T, H, hd) f32         q    (B*nkv, grp, hd) f32, pre-scaled
//   k/v_codes  (R, H, Dc) codes          out  (B*nkv, grp, hd) f32
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
// K6: page-walking fused decode-on-read one-token GQA attention.
//
// Bound on the H100: device-memory bytes, as K4 -- each live row's codes and
// scale are read once (at B=8, nkv=4, hd=64, posit8 and seq_lens
// {1,17,128,129,500,1000,1023,1024}: 3,822 rows, 2.08 MB, 0.62 us).
// Design: not the Pallas grid (B, nkv, Pmax) carried over -- blocks run in
// no order, so nothing can carry (m, l, acc) across a grid axis.  One CTA per
// (slot, kv-head) loads its own page-table row (no scalar prefetch on
// Hopper) and runs kv::attention_walk over logical rows
// [0, min(seq_lens[b], Pmax*ps)).  Pages are only 16 rows, so each 64-row
// block gathers 64/ps table entries into shared memory and keeps K4's block
// loop instead of four times its barriers.  Table entries are clipped to
// [0, num_pages), as in the reference; seq_lens[b] <= 0 walks all Pmax pages
// with every score masked, which gives the mean of V over the listed pages,
// trash included.
// ---------------------------------------------------------------------------
struct PageRows {
  const int* table;  // the slot's (Pmax,) page-table row
  int ps, num_pages, nkv, h;
  __device__ long long operator()(int j) const {
    const int p = min(max(table[j / ps], 0), num_pages - 1);
    return ((long long)p * ps + j % ps) * nkv + h;
  }
};

template <int N, int ES>
__global__ void __launch_bounds__(kv::kAttnThreads)
    paged_decode_attention_kernel(
        const float* __restrict__ q,
        const typename posit::Code<N>::type* __restrict__ k_codes,
        const float* __restrict__ k_scale,
        const typename posit::Code<N>::type* __restrict__ v_codes,
        const float* __restrict__ v_scale,
        const int* __restrict__ page_table, const int* __restrict__ seq_lens,
        float* __restrict__ out, int nkv, int grp, int hd, int ps, int pmax,
        int num_pages, int bias) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowid = blockIdx.x;                 // b * nkv + h
  const int b = rowid / nkv, h = rowid % nkv;
  const long long qo = (long long)rowid * grp * hd;
  kv::attention_walk<N, ES>(
      q + qo, k_codes, k_scale, v_codes, v_scale, seq_lens[b], pmax * ps,
      PageRows{page_table + (long long)b * pmax, ps, num_pages, nkv, h},
      out + qo, grp, hd, bias, smem);
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

extern "C" int paged_decode_attention(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, const void* page_table,
    const void* seq_lens, void* out, int B, int nkv, int grp, int hd, int ps,
    int pmax, int num_pages, int nbits, int es, int bias, void* stream) {
  if (ps < 1 || pmax < 1 || num_pages < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define ATTN_CASE(N, ES)                                                      \
  if (nbits == N && es == ES) {                                               \
    using CodeT = posit::Code<N>::type;                                       \
    return kv::launch_attention(                                              \
        paged_decode_attention_kernel<N, ES>, B * nkv, grp, hd, st,           \
        (const float*)q, (const CodeT*)k_codes, (const float*)k_scale,        \
        (const CodeT*)v_codes, (const float*)v_scale,                         \
        (const int*)page_table, (const int*)seq_lens, (float*)out, nkv, grp,  \
        hd, ps, pmax, num_pages, bias);                                       \
  }
  POSIT_FORMATS(ATTN_CASE)
#undef ATTN_CASE
  return (int)cudaErrorInvalidValue;
}
