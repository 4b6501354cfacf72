// Device bodies shared by the posit KV-cache kernels of both layouts:
//
//   encode_row      one warp scales and encodes one K or V row -- the write
//                   path of K3 (ring, kv_cache.cu) and K5 (paged,
//                   paged_kv.cu); only the destination row differs.
//   attention_walk  one CTA's fused decode-on-read one-token GQA over the
//                   logical rows of one (slot, kv-head) -- the read path of
//                   K4 (ring); a Rows functor maps logical row j to its
//                   (row, head) entry, so only the addressing differs.
//   attention_split one CTA's share of a split walk (flash-decoding): the
//                   same attention over one R-row split of a (slot,
//                   kv-head)'s rows, written as (m, l, acc) partials --
//   attention_combine  merged per (slot, kv-head) with log-sum-exp weights;
//                   together the read path of K6 (paged).
//
// Codes are posit<N, ES> (posit_codec.cuh); 4-bit codes are nibble-packed
// split-half (byte j holds element j low, element j + hd/2 high).
#pragma once

#include <cuda_bf16.h>

#include "posit_codec.cuh"

namespace kv {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHd = 256;

// ---------------------------------------------------------------------------
// Row encode.  The warp's lanes own hd/32 elements each: a shuffle
// reduction gives the row's sum |x| in f32, the pow2 scale is the exponent
// bits of max(mean, 1e-30) (NaN propagates), and every lane encodes its
// elements with the flushing encoder.  4-bit codes meet their split-half
// partner in `nib`, the warp's kMaxHd-byte slice of shared memory.
// ---------------------------------------------------------------------------
constexpr int kAppendWarps = 4;   // rows (warps) per block of an append

// Blocks of an append of T rows per slot into H heads, K and V: one warp
// per row; 0 when there is nothing to write, -1 past the grid's limit.
inline long long append_blocks(int B, int T, int H) {
  const long long blocks = (2LL * B * T * H + kAppendWarps - 1) / kAppendWarps;
  return blocks > 0x7FFFFFFFLL ? -1 : blocks;
}

template <int N, int ES>
__device__ __forceinline__ void encode_row(
    const float* __restrict__ x, int hd,
    typename posit::Code<N>::type* __restrict__ out,
    float* __restrict__ scale_out, uint8_t* nib, int lane, int bias) {
  using CodeT = typename posit::Code<N>::type;
  constexpr bool kPacked = N <= 4;
  float sum = 0.f;
  for (int j = lane; j < hd; j += 32) sum += fabsf(x[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, o);
  const float mean = sum / (float)hd;
  const float m = isnan(mean) ? mean : fmaxf(mean, 1e-30f);
  const float scale = __uint_as_float(__float_as_uint(m) & 0x7F800000u);
  for (int j = lane; j < hd; j += 32) {
    const uint32_t c = posit::encode<N, ES>(x[j] / scale, bias);
    if (kPacked)
      nib[j] = (uint8_t)c;
    else
      out[j] = (CodeT)c;
  }
  if (kPacked) {
    __syncwarp();
    const int dc = hd / 2;
    for (int j = lane; j < dc; j += 32)
      out[j] = (CodeT)(nib[j] | (nib[j + dc] << 4));
  }
  if (lane == 0) *scale_out = scale;
}

// ---------------------------------------------------------------------------
// Attention walk.  One CTA of kAttnThreads holds its grp query rows in
// shared memory and walks the logical rows in blocks of kBlockRows,
// stopping at the block that holds `len` (later rows would only add exact
// zeros).  Per block it first resolves the rows' (row, head) entries into
// shared memory (the paged walk gathers 64/ps page-table entries there),
// then decodes codes x scale into shared f32 tiles (K rows padded by one
// float against bank conflicts), and keeps scores and the online softmax
// (m, l, acc) in f32; full-precision K/V never touch device memory.
// `len_raw <= 0` masks every score: as in the dense masked softmax, all W
// logical rows then weigh equally and the output is the mean of V.
// ---------------------------------------------------------------------------
constexpr int kAttnThreads = 128;
constexpr int kBlockRows = 64;

inline size_t attention_smem_bytes(int grp, int hd) {
  return sizeof(long long) * kBlockRows +
         sizeof(float) * ((size_t)kBlockRows * (hd + 1) +
                          (size_t)kBlockRows * hd + 2 * (size_t)grp * hd +
                          (size_t)grp * kBlockRows + 3 * (size_t)grp);
}

// q, out: this CTA's (grp, hd) f32 rows; q pre-scaled by hd^-0.5.
// rows(j): index of logical row j's entry in the (rows, nkv) scale arrays
// (its codes start at that index times Dc).
template <int N, int ES, class Rows>
__device__ __forceinline__ void attention_walk(
    const float* __restrict__ q,
    const typename posit::Code<N>::type* __restrict__ k_codes,
    const float* __restrict__ k_scale,
    const typename posit::Code<N>::type* __restrict__ v_codes,
    const float* __restrict__ v_scale, int len_raw, int W, const Rows& rows,
    float* __restrict__ out, int grp, int hd, int bias,
    unsigned char* smem) {
  constexpr bool kPacked = N <= 4;
  long long* roff = reinterpret_cast<long long*>(smem);   // kBlockRows
  float* ks = reinterpret_cast<float*>(roff + kBlockRows);  // kBlockRows x ldk
  const int ldk = hd + 1;
  float* vs = ks + kBlockRows * ldk;            // kBlockRows x hd
  float* qs = vs + kBlockRows * hd;             // grp x hd
  float* ps = qs + grp * hd;                    // grp x kBlockRows
  float* acc = ps + grp * kBlockRows;           // grp x hd
  float* ms = acc + grp * hd;                   // grp
  float* ls = ms + grp;                         // grp
  float* corr = ls + grp;                       // grp

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nwarps = kAttnThreads / 32;
  const int dc = kPacked ? hd / 2 : hd;

  for (int e = tid; e < grp * hd; e += kAttnThreads) {
    qs[e] = q[e];
    acc[e] = 0.f;
  }
  for (int g = tid; g < grp; g += kAttnThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }
  const bool masked = len_raw <= 0;             // every score is kNegInf
  const int len = masked ? W : min(len_raw, W);

  for (int base = 0; base < len; base += kBlockRows) {
    const int nb = min(kBlockRows, len - base);   // live rows this block
    __syncthreads();   // previous block's readers are done with the tiles
    for (int j = tid; j < nb; j += kAttnThreads) roff[j] = rows(base + j);
    __syncthreads();
    // decode-on-read: codes x scale -> f32 tiles in shared memory
    for (int e = tid; e < nb * dc; e += kAttnThreads) {
      const int j = e / dc, c = e % dc;
      const long long off = roff[j];
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
      for (int j = lane; j < kBlockRows; j += 32)
        mx = fmaxf(mx, ps[g * kBlockRows + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
      const float m_new = fmaxf(ms[g], mx);
      float psum = 0.f;
      for (int j = lane; j < kBlockRows; j += 32) {
        const float p = j < nb ? expf(ps[g * kBlockRows + j] - m_new) : 0.f;
        ps[g * kBlockRows + j] = p;
        psum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xFFFFFFFFu, psum, o);
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
    out[e] = acc[e] / fmaxf(ls[e / hd], 1e-30f);
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

// Launch an attention_walk kernel: one CTA per (slot, kv-head), dynamic
// shared memory past 48 KB opted in first.  Returns cudaGetLastError().
template <class... KArgs, class... Args>
inline int launch_attention(void (*kern)(KArgs...), int ctas, int grp,
                            int hd, cudaStream_t st, Args... args) {
  if (ctas == 0) return 0;
  const size_t smem = attention_smem_bytes(grp, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<ctas, kAttnThreads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace kv
