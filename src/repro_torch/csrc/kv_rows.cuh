// Device bodies shared by the posit KV-cache kernels of both layouts:
//
//   encode_row_group  a group of (row bytes) / 16 lanes scales and encodes
//                     one f32 or bf16 row, 16 B per lane --
//   append_kernel     one launch over every (b, t, head) row of K and V;
//                     together the write path of K3 (ring, kv_cache.cu) and
//                     K5 (paged, paged_kv.cu), launched by launch_append.
//                     A Dst functor maps (b, t) to the flat destination
//                     row: the two layouts differ only there.
//   attention_split   one CTA's share of a split walk (flash-decoding): the
//                     fused decode-on-read one-token GQA over one R-row
//                     split of a (slot, kv-head)'s logical rows, written as
//                     (m, l, acc) partials --
//   attention_combine merged per (slot, kv-head) with log-sum-exp weights;
//                     together the read path of K4 (ring) and K6 (paged),
//                     launched by launch_split_walk.  A Layout maps (slot,
//                     kv-head) to a Rows functor that maps logical row j to
//                     its (row, head) entry: the two layouts differ only
//                     there.
//
// Codes are posit<N, ES> (posit_codec.cuh); 4-bit codes are nibble-packed
// split-half (byte j holds element j low, element j + hd/2 high).
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "posit_codec.cuh"
#include "smem_opt_in.cuh"

namespace kv {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHd = 256;

// ---------------------------------------------------------------------------
// Lane-group row encode (K3, K5).  A group of G = min(32, row bytes / 16)
// lanes holds one row of x (f32 or bf16; bf16 -> f32 is exact), each lane C
// = (row bytes) / (16 G) 16-B loads of E = 16 / sizeof(x) elements: chunk
// li + k G of the row for k < C.  The row's sum |x| is each lane's own sum
// (chunk by chunk, element by element) then a butterfly over the group,
// which every lane ends with bit-identical (f32 addition commutes); the
// pow2 scale is the exponent bits of max(mean, 1e-30) (NaN propagates),
// and every element is encoded by the branch-free posit::encode, so a
// lane's C E encodes overlap.  Each lane writes its chunk's codes in one
// vector store.  Packed 4-bit codes: element j < hd/2 pairs
// with j + hd/2, which is chunk li + G/2 of the group (C = 1: its codes
// come by one shuffle) or this lane's own second chunk (C = 2).
// `ok` (the destination row lies in the pool) is only read at the stores,
// so the caller's load of that row and the row's loads are in flight
// together; a row that is not ok is skipped.
// ---------------------------------------------------------------------------
constexpr int kGroupThreads = 128;

template <int Bytes>
struct VecBytes;
template <>
struct VecBytes<4> {
  using type = uint32_t;
};
template <>
struct VecBytes<8> {
  using type = uint2;
};
template <>
struct VecBytes<16> {
  using type = uint4;
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {       // element 2i sits in the low half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// x: this group's row (16-B aligned); codes / scale: the destination
// entry's codes and scale, written only when `ok`.
template <int N, int ES, int C, typename XT>
__device__ __forceinline__ void encode_row_group(
    const XT* __restrict__ x, int hd, int G, int li, bool ok,
    typename posit::Code<N>::type* __restrict__ codes,
    float* __restrict__ scale_out, int bias) {
  using CodeT = typename posit::Code<N>::type;
  constexpr int E = 16 / (int)sizeof(XT);
  constexpr bool kPacked = N <= 4;
  float v[C][E];
#pragma unroll
  for (int k = 0; k < C; ++k) load16(x + (li + k * G) * E, v[k]);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < C; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) sum += fabsf(v[k][e]);
  for (int o = G / 2; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
  const float mean = sum / (float)hd;
  const float m = isnan(mean) ? mean : fmaxf(mean, 1e-30f);
  const float scale = __uint_as_float(__float_as_uint(m) & 0x7F800000u);
  uint32_t c[C][E];
#pragma unroll
  for (int k = 0; k < C; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e)
      c[k][e] = posit::encode<N, ES>(v[k][e] / scale, bias);
  if constexpr (kPacked) {
    // the high nibbles: chunk li + G/2's codes (C = 1) or chunk li + G's
    // (C = 2, this lane's own)
    uint32_t hi[E];
    if constexpr (C == 1) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) word |= c[0][e] << (4 * e);
      word = __shfl_xor_sync(0xFFFFFFFFu, word, G / 2);
#pragma unroll
      for (int e = 0; e < E; ++e) hi[e] = (word >> (4 * e)) & 0xFu;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) hi[e] = c[1][e];
    }
    union {
      typename VecBytes<E>::type vec;
      uint8_t b[E];
    } u;
#pragma unroll
    for (int e = 0; e < E; ++e) u.b[e] = (uint8_t)(c[0][e] | (hi[e] << 4));
    if (ok && (C == 2 || li < G / 2))
      *reinterpret_cast<typename VecBytes<E>::type*>(codes + li * E) = u.vec;
  } else {
    union {
      typename VecBytes<E * sizeof(CodeT)>::type vec;
      CodeT b[E];
    } u;
#pragma unroll
    for (int k = 0; k < C; ++k) {
#pragma unroll
      for (int e = 0; e < E; ++e) u.b[e] = (CodeT)c[k][e];
      if (ok)
        *reinterpret_cast<typename VecBytes<E * sizeof(CodeT)>::type*>(
            codes + (li + k * G) * E) = u.vec;
    }
  }
  if (ok && li == 0) *scale_out = scale;
}

// ---------------------------------------------------------------------------
// The append kernel and its launcher, shared by K3 and K5.  One launch
// covers K and V of every (b, t, head) row: a group of G lanes per row
// (encode_row_group), K rows first.  k/v_new are (B, T, H, hd) rows at the
// element strides given (each row contiguous and 16-B aligned), in the
// model's dtype.  A Dst is a small struct passed by value whose
// operator()(b, t, live) gives the flat destination row, or -1 for a row
// not to write; its loads are only tested at the stores, so they and the
// row's 16-B loads are in flight together.  Codes land at flat row * H +
// head.
// ---------------------------------------------------------------------------
struct RowStrides {   // elements between rows of k/v_new along b, t, head
  long long b, t, h;
};

template <int N, int ES, int C, typename XT, class Dst>
__global__ void __launch_bounds__(kGroupThreads) append_kernel(
    const XT* __restrict__ k_new, const XT* __restrict__ v_new,
    typename posit::Code<N>::type* __restrict__ k_codes,
    float* __restrict__ k_scale,
    typename posit::Code<N>::type* __restrict__ v_codes,
    float* __restrict__ v_scale, Dst dst, RowStrides ks, RowStrides vs,
    int T, int H, int hd, int G, long long rows, int bias) {
  const long long tid = (long long)blockIdx.x * kGroupThreads + threadIdx.x;
  if ((tid & ~31LL) / G >= 2 * rows) return;   // whole warp leaves together
  const bool live = tid / G < 2 * rows;
  const long long row = live ? tid / G : 2 * rows - 1;
  const bool is_v = row >= rows;
  const long long r = is_v ? row - rows : row;  // (b, t, h) row index
  const int h = (int)(r % H);
  const long long bt = r / H;                   // b * T + t
  const int b = (int)(bt / T), t = (int)(bt % T);
  const long long flat = dst(b, t, live);       // tested after the loads
  const RowStrides st = is_v ? vs : ks;
  const long long xo = b * st.b + t * st.t + h * st.h;
  const long long off = flat * H + h;
  const int dc = N <= 4 ? hd / 2 : hd;
  encode_row_group<N, ES, C>((is_v ? v_new : k_new) + xo, hd, G,
                             (int)(tid % G), flat >= 0,
                             (is_v ? v_codes : k_codes) + off * dc,
                             (is_v ? v_scale : k_scale) + off, bias);
}

// Rows of hd f32 (x_bf16 0) or bf16 (x_bf16 1) elements, 32 * 2^i bytes up
// to 1024 (so hd <= 256), 16-B aligned, at the element strides given;
// codes 16-B aligned.  Returns a CUDA error code, 0 on success.
template <class Dst>
int launch_append(const Dst& dst, const void* k_new, const void* v_new,
                  void* k_codes, void* k_scale, void* v_codes, void* v_scale,
                  RowStrides ks, RowStrides vs, int B, int T, int H, int hd,
                  int nbits, int es, int bias, int x_bf16, cudaStream_t st) {
  const int esize = x_bf16 ? 2 : 4;
  const int chunks = hd * esize / 16;           // 16-B loads per row
  if (hd > kMaxHd || hd * esize % 16 || chunks < 2 || chunks > 64 ||
      (chunks & (chunks - 1)))
    return (int)cudaErrorInvalidValue;
  const long long strides[6] = {ks.b, ks.t, ks.h, vs.b, vs.t, vs.h};
  for (long long sd : strides)
    if (sd * esize % 16) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k_new | (uintptr_t)v_new | (uintptr_t)k_codes |
       (uintptr_t)v_codes) & 15)
    return (int)cudaErrorMisalignedAddress;
  const long long rows = (long long)B * T * H;
  const int G = chunks < 32 ? chunks : 32, C = chunks / G;
  const long long blocks = (2 * rows * G + kGroupThreads - 1) / kGroupThreads;
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
#define APPEND_CASE(N, ES)                                                    \
  if (nbits == N && es == ES) {                                               \
    using CodeT = typename posit::Code<N>::type;                              \
    auto go = [&](auto ct, auto xt) {                                         \
      using XT = decltype(xt);                                                \
      append_kernel<N, ES, decltype(ct)::value, XT, Dst>                      \
          <<<(int)blocks, kGroupThreads, 0, st>>>(                            \
              (const XT*)k_new, (const XT*)v_new, (CodeT*)k_codes,            \
              (float*)k_scale, (CodeT*)v_codes, (float*)v_scale, dst, ks, vs, \
              T, H, hd, G, rows, bias);                                       \
      return (int)cudaGetLastError();                                         \
    };                                                                        \
    using C1 = std::integral_constant<int, 1>;                                \
    using C2 = std::integral_constant<int, 2>;                                \
    if (x_bf16) return go(C1{}, __nv_bfloat16{});  /* hd <= 256: C = 1 */    \
    return C == 1 ? go(C1{}, float{}) : go(C2{}, float{});                    \
  }
  POSIT_FORMATS(APPEND_CASE)
#undef APPEND_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Split walk.  The rows of one (slot, kv-head) are cut into splits of R
// logical rows, one CTA of kSplitThreads each, so a slot's rows are read by
// many SMs at once.  A CTA whose split starts at or past the live length
// leaves at once.  Lanes work in groups of lpr = (row bytes) / VB: each lane
// loads VB bytes of a row's K codes and of its V codes in one access, plus
// the row's two scales, so a warp has 32 / lpr rows and a CTA kUnroll times
// that many in flight.  Codes of n <= 8 decode through a 2^n-entry table in
// shared memory (posit::decode, so bit-exact), 16-bit codes inline.  A lane
// dots its elements with the scaled q rows (shared memory) and the group
// sums across its lanes by shuffles; decoded V rows go to shared memory.
// The split's scores then get a plain max/exp/sum per query row, P @ V
// runs from shared memory, and the CTA writes (acc[grp][hd], m, l).
// `len_raw <= 0` masks every score with the finite kNegInf: each of the W
// listed rows then has weight exp(0) in every split, and the combine gives
// the mean of V over all of them, as the dense masked softmax does.
// ---------------------------------------------------------------------------
constexpr int kSplitThreads = 128;
constexpr int kSplitUnroll = 4;

// shared memory of a split CTA: decode table, scaled q, scores, decoded V
// (rows padded by 4 floats against bank conflicts)
inline size_t split_smem_bytes(int grp, int hd, int R) {
  return sizeof(float) * (256 + (size_t)grp * hd + (size_t)grp * R +
                          (size_t)R * (hd + 4));
}

template <int VB>
struct VecOf;
template <>
struct VecOf<16> {
  using type = uint4;
};
template <>
struct VecOf<4> {
  using type = uint32_t;
};

// x * qscale in the type of x (bf16 rounds, as a bf16 tensor times a
// Python float does)
__device__ __forceinline__ float q_scaled(float v, float qscale) {
  return v * qscale;
}
__device__ __forceinline__ float q_scaled(__nv_bfloat16 v, float qscale) {
  return __bfloat162float(__float2bfloat16_rn(__bfloat162float(v) * qscale));
}

// q: this (slot, kv-head)'s grp x hd rows, unscaled, in q's type.  Rows r0
// .. of logical rows; part: grp x (hd + 2) floats, acc then m, l per row.
template <int N, int ES, int VB, typename QT, class Rows>
__device__ __forceinline__ void attention_split(
    const QT* __restrict__ q, float qscale,
    const typename posit::Code<N>::type* __restrict__ k_codes,
    const float* __restrict__ k_scale,
    const typename posit::Code<N>::type* __restrict__ v_codes,
    const float* __restrict__ v_scale, int len_raw, int W, int r0, int R,
    const Rows& rows, float* __restrict__ part, int grp, int hd, int bias,
    unsigned char* smem) {
  using CodeT = typename posit::Code<N>::type;
  using Vec = typename VecOf<VB>::type;
  constexpr bool kPacked = N <= 4;
  constexpr int kUnits = VB / (int)sizeof(CodeT);   // code units per load
  constexpr int E = kPacked ? 2 * kUnits : kUnits;  // elements per load
  const bool masked = len_raw <= 0;
  const int len = masked ? W : min(len_raw, W);
  if (r0 >= len) return;                            // the whole CTA
  const int nr = min(R, len - r0);

  float* tab = reinterpret_cast<float*>(smem);      // 256
  float* qs = tab + 256;                            // grp x hd
  float* ps = qs + grp * hd;                        // grp x R
  float* vs = ps + grp * R;                         // R x ldv
  const int ldv = hd + 4;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int dc = kPacked ? hd / 2 : hd;             // code units per row
  const int lpr = dc / kUnits;                      // lanes per row
  const int li = lane % lpr;
  const int gi = warp * (32 / lpr) + lane / lpr;    // row group in the CTA
  const int ng = (kSplitThreads / 32) * (32 / lpr);

  if (N <= 8)
    for (int i = tid; i < (1 << N); i += kSplitThreads)
      tab[i] = posit::decode<N, ES>(i, bias);
  for (int e = tid; e < grp * hd; e += kSplitThreads)
    qs[e] = q_scaled(q[e], qscale);
  __syncthreads();

  auto decode = [&](const Vec& raw, float (&out)[E]) {
    union {
      Vec v;
      CodeT c[kUnits];
    } u;
    u.v = raw;
#pragma unroll
    for (int e = 0; e < kUnits; ++e) {
      if constexpr (kPacked) {
        out[e] = tab[u.c[e] & 0xFu];
        out[e + kUnits] = tab[u.c[e] >> 4];
      } else if constexpr (N <= 8) {
        out[e] = tab[u.c[e]];
      } else {
        out[e] = posit::decode<N, ES>(u.c[e], bias);
      }
    }
  };
  // element e of a lane's load sits at dim dim0 + e (+ dc - kUnits for the
  // high nibbles of packed codes)
  const int dim0 = li * kUnits;
  auto dim = [&](int e) {
    return kPacked && e >= kUnits ? dim0 + dc + (e - kUnits) : dim0 + e;
  };

  for (int j0 = 0; j0 < nr; j0 += ng * kSplitUnroll) {
    Vec kr[kSplitUnroll], vr[kSplitUnroll];
    float sk[kSplitUnroll], sv[kSplitUnroll];
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {   // every load in flight first
      const int j = j0 + u * ng + gi;
      if (j < nr) {
        const long long off = rows(r0 + j);
        sk[u] = k_scale[off];
        sv[u] = v_scale[off];
        kr[u] = *reinterpret_cast<const Vec*>(k_codes + off * dc + dim0);
        vr[u] = *reinterpret_cast<const Vec*>(v_codes + off * dc + dim0);
      } else {
        sk[u] = sv[u] = 0.f;
        kr[u] = vr[u] = Vec{};
      }
    }
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const int j = j0 + u * ng + gi;
      float d[E];
      decode(kr[u], d);
      for (int g = 0; g < grp; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qs[g * hd + dim(e)] * d[e];
        for (int o = lpr / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
        if (li == 0 && j < nr) ps[g * R + j] = masked ? kNegInf : s * sk[u];
      }
      if (j < nr) {
        decode(vr[u], d);
#pragma unroll
        for (int e = 0; e < E; ++e) vs[j * ldv + dim(e)] = d[e] * sv[u];
      }
    }
  }
  __syncthreads();
  // the split's softmax: one warp per query row
  float* ml = tab;          // the table is no longer read: m, l per row
  for (int g = warp; g < grp; g += kSplitThreads / 32) {
    float mx = kNegInf;
    for (int j = lane; j < nr; j += 32) mx = fmaxf(mx, ps[g * R + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
    float psum = 0.f;
    for (int j = lane; j < nr; j += 32) {
      const float p = expf(ps[g * R + j] - mx);
      ps[g * R + j] = p;
      psum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xFFFFFFFFu, psum, o);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = psum;
    }
  }
  __syncthreads();
  for (int e = tid; e < grp * hd; e += kSplitThreads) {
    const int g = e / hd, dd = e % hd;
    float a = 0.f;
    for (int j = 0; j < nr; ++j) a += ps[g * R + j] * vs[j * ldv + dd];
    part[g * (hd + 2) + dd] = a;
  }
  for (int g = tid; g < grp; g += kSplitThreads) {
    part[g * (hd + 2) + hd] = ml[2 * g];
    part[g * (hd + 2) + hd + 1] = ml[2 * g + 1];
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Merge the live splits of one (slot, kv-head): part holds S splits of
// grp x (hd + 2); out its grp x hd rows in q's type.  The splits are summed
// in order, so the result does not depend on which CTA finished first.
template <typename OT>
__device__ __forceinline__ void attention_combine(
    const float* __restrict__ part, int len_raw, int W, int R, int S,
    OT* __restrict__ out, int grp, int hd) {
  const int len = len_raw <= 0 ? W : min(len_raw, W);
  const int n = min((len + R - 1) / R, S);
  const int stride = grp * (hd + 2);
  for (int e = threadIdx.x; e < grp * hd; e += blockDim.x) {
    const int g = e / hd, dd = e % hd;
    const float* pg = part + g * (hd + 2);
    float m = kNegInf;
    for (int s = 0; s < n; ++s) m = fmaxf(m, pg[s * stride + hd]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n; ++s) {
      const float wgt = expf(pg[s * stride + hd] - m);
      l += wgt * pg[s * stride + hd + 1];
      a += wgt * pg[s * stride + dd];
    }
    store_out(out + e, a / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// The split walk's two kernels and their launcher, shared by K4 and K6.  A
// Layout is a small struct passed by value whose rows(b, h) gives the Rows
// functor of slot b's kv-head h; W is the number of logical rows listed per
// slot (the ring's width, or Pmax * page size).
// ---------------------------------------------------------------------------
template <int N, int ES, int VB, typename QT, class Layout>
__global__ void __launch_bounds__(kSplitThreads) split_kernel(
    const QT* __restrict__ q,
    const typename posit::Code<N>::type* __restrict__ k_codes,
    const float* __restrict__ k_scale,
    const typename posit::Code<N>::type* __restrict__ v_codes,
    const float* __restrict__ v_scale, const int* __restrict__ lens,
    float* __restrict__ part, Layout lay, int nkv, int grp, int hd, int W,
    int bias, float qscale, int SR, int S) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rowid = blockIdx.x, split = blockIdx.y;   // rowid = b * nkv + h
  const int b = rowid / nkv, h = rowid % nkv;
  attention_split<N, ES, VB>(
      q + (long long)rowid * grp * hd, qscale, k_codes, k_scale, v_codes,
      v_scale, lens[b], W, split * SR, SR, lay.rows(b, h),
      part + ((long long)rowid * S + split) * grp * (hd + 2), grp, hd, bias,
      smem);
}

template <typename OT>
__global__ void __launch_bounds__(kSplitThreads) combine_kernel(
    const float* __restrict__ part, const int* __restrict__ lens,
    OT* __restrict__ out, int nkv, int grp, int hd, int W, int SR, int S) {
  const int rowid = blockIdx.x;
  attention_combine<OT>(part + (long long)rowid * S * grp * (hd + 2),
                        lens[rowid / nkv], W, SR, S,
                        out + (long long)rowid * grp * hd, grp, hd);
}

template <int N, int ES, int VB, typename QT, class Layout>
int launch_split(const Layout& lay, const void* q, const void* k_codes,
                 const void* k_scale, const void* v_codes,
                 const void* v_scale, const void* lens, void* out, void* part,
                 int B, int nkv, int grp, int hd, int W, int bias,
                 float qscale, int SR, cudaStream_t st) {
  using CodeT = typename posit::Code<N>::type;
  const int S = (W + SR - 1) / SR;
  const size_t smem = split_smem_bytes(grp, hd, SR);
  auto kern = split_kernel<N, ES, VB, QT, Layout>;
  if (smem > 48 * 1024) {
    static SmemOptIn opt_in;
    const cudaError_t err = opt_in_smem(opt_in, kern, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<dim3(B * nkv, S), kSplitThreads, smem, st>>>(
      (const QT*)q, (const CodeT*)k_codes, (const float*)k_scale,
      (const CodeT*)v_codes, (const float*)v_scale, (const int*)lens,
      (float*)part, lay, nkv, grp, hd, W, bias, qscale, SR, S);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<QT><<<B * nkv, kSplitThreads, 0, st>>>(
      (const float*)part, (const int*)lens, (QT*)out, nkv, grp, hd, W, SR,
      S);
  return (int)cudaGetLastError();
}

// Split walk + combine: q (B, nkv, grp, hd) and out in q's type (f32, or
// bf16 with q_bf16), lens (B,) int32, part a (B * nkv, S, grp, hd + 2) f32
// workspace, S = ceil(W / SR).  Rows of codes must be 4 * 2^i bytes, at
// most 512 (16-B loads where the row and the pointers allow, else 4-B).
// Returns a CUDA error code, 0 on success.
template <class Layout>
int launch_split_walk(const Layout& lay, const void* q, const void* k_codes,
                      const void* k_scale, const void* v_codes,
                      const void* v_scale, const void* lens, void* out,
                      void* part, int B, int nkv, int grp, int hd, int W,
                      int nbits, int es, int bias, int q_bf16, int SR,
                      float qscale, cudaStream_t st) {
  if (W < 1 || SR < 1 || grp < 1 || grp > 128)
    return (int)cudaErrorInvalidValue;
  if (B * nkv == 0) return 0;
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
          lay, q, k_codes, k_scale, v_codes, v_scale, lens, out, part, B,     \
          nkv, grp, hd, W, bias, qscale, SR, st);                             \
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

}  // namespace kv
