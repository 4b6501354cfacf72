// K5 and K6: the paged posit-KV pool of serving decode.
//
// K5, kv_rows.cuh's append_kernel with table-addressed destinations,
// replaces repro/kernels/paged_kv.py::paged_kv_append_rows (Pallas;
// paged_kv_append is its T=1 case).  K6, kv_rows.cuh's split_kernel +
// combine_kernel over page-table rows, replaces
// repro/kernels/paged_kv.py::paged_decode_attention (Pallas).  Both are
// shared with the ring's K3 and K4 (kv_cache.cu); this file holds the pool
// addressing.
//
// Layouts (row-major; k/v_new with the strides given, the rest contiguous):
//   k/v_new    (B, T, H, hd) f32 or bf16 q    (B*nkv, grp, hd) f32 or bf16
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
// it moves ~20.8 KB from f32 rows (~12.6 KB from bf16), 0.006 us at 3.35
// TB/s, so launch latency and the chain of dependent loads set its time;
// at T=1024 (a paged prefill) ~1.6 MB, bytes-bound.  Design:
// kv::launch_append, shared with the ring's K3: a lane group of (row bytes)
// / 16 lanes per (b, t, head) row of K or V (kv::encode_row_group): the row
// is read in the model's dtype (f32 or bf16, any row strides), so the
// caller launches no cast; PageDst's dst[b, t] load is in flight beside the
// row's 16-B loads; the row's sum is a shuffle reduction within the group;
// each lane stores its codes in one vector store.  One launch covers K and
// V of every row.  Idle slots all point at the trash page, so several
// groups may write one trash row in no set order: benign, and no check
// compares trash rows.  A dst row outside [0, R) is skipped rather than
// written out of bounds.
// ---------------------------------------------------------------------------
struct PageDst {
  const int* dst;   // (B, T) flat pool rows
  int T, R;
  __device__ long long operator()(int b, int t, bool live) const {
    const int f = live ? dst[(long long)b * T + t] : -1;
    return f >= 0 && f < R ? f : -1;
  }
};

// ---------------------------------------------------------------------------
// K6: page-walking fused decode-on-read one-token GQA attention, as a split
// walk across CTAs (flash-decoding) and a combine.
//
// Bound on the H100: device-memory bytes, as K4 -- each live row's codes and
// scale are read once (at B=8, nkv=4, hd=64, posit8 and seq_lens
// {1,17,128,129,500,1000,1023,1024}: 3,822 rows, 2.08 MB, 0.62 us), so the
// latency of the two launches sets the floor.  Design: not the Pallas grid
// (B, nkv, Pmax) carried over -- blocks run in no order, so nothing can
// carry (m, l, acc) across a grid axis.  kv::launch_split_walk: a CTA per
// (slot, kv-head, SR-row split) scales its q rows by hd^-0.5 in q's type,
// resolves its rows through its own page-table entries (no scalar prefetch
// on Hopper; clipped to [0, num_pages), as in the reference) and runs
// kv::attention_split, so a slot's rows are walked by ceil(len / SR) SMs at
// once with many rows in flight on each; the combine merges a slot's live
// splits with log-sum-exp weights and writes the output in q's type.
// seq_lens[b] <= 0 walks all Pmax pages with every score masked, which
// gives the mean of V over the listed pages, trash included.  The ring's K4
// differs only in its Rows functor.
// ---------------------------------------------------------------------------
struct PageRows {
  const int* table;  // the slot's (Pmax,) page-table row
  int ps, num_pages, nkv, h;
  __device__ long long operator()(int j) const {
    const int p = min(max(table[j / ps], 0), num_pages - 1);
    return ((long long)p * ps + j % ps) * nkv + h;
  }
};

struct PageLayout {
  const int* table;  // (B, Pmax)
  int ps, pmax, num_pages, nkv;
  __device__ PageRows rows(int b, int h) const {
    return PageRows{table + (long long)b * pmax, ps, num_pages, nkv, h};
  }
};

}  // namespace

// k/v_new rows of hd f32 (x_bf16 0) or bf16 (x_bf16 1) elements at the
// element strides given (kv::launch_append has the limits).  Returns a
// CUDA error code, 0 on success.
extern "C" int paged_kv_append_rows(
    const void* k_new, const void* v_new, void* k_codes, void* k_scale,
    void* v_codes, void* v_scale, const void* dst, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, int B, int T, int H, int hd, int R, int nbits, int es,
    int bias, int x_bf16, void* stream) {
  return kv::launch_append(PageDst{(const int*)dst, T, R}, k_new, v_new,
                           k_codes, k_scale, v_codes, v_scale,
                           kv::RowStrides{ksb, kst, ksh},
                           kv::RowStrides{vsb, vst, vsh}, B, T, H, hd, nbits,
                           es, bias, x_bf16, (cudaStream_t)stream);
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
  if (ps < 1 || pmax < 1 || num_pages < 1) return (int)cudaErrorInvalidValue;
  return kv::launch_split_walk(
      PageLayout{(const int*)page_table, ps, pmax, num_pages, nkv}, q,
      k_codes, k_scale, v_codes, v_scale, seq_lens, out, part, B, nkv, grp,
      hd, pmax * ps, nbits, es, bias, q_bf16, SR, qscale,
      (cudaStream_t)stream);
}
