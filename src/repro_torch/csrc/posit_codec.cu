// K1 and K2: standalone posit decode / encode over flat arrays.
//
// K1 posit_decode_kernel replaces repro/kernels/posit_decode.py::posit_decode
// (Pallas, body decode_tile); K2 posit_encode_kernel replaces
// repro/kernels/posit_encode.py::posit_encode (Pallas, body encode_tile).
//
// K1.  Bound on the H100: device-memory bytes (1-2 B of codes read and 4 B
// of f32 or 2 B of bf16 written per element: 3.13 us at 2^21 posit8 codes
// to f32), as long as the decode issues few enough instructions per
// element.  Design: each load takes the codes of one 16-B store of values
// (4 f32 or 8 bf16: 4, 8 or 16 B of codes), so every lane decodes what it
// loaded and stores it whole, neighbouring lanes on neighbouring bytes;
// kDecodeLoads loads per thread are in flight before the first decode.
// Codes of n <= 8 decode through a 256-entry f32 table in shared memory
// that each CTA fills with posit::decode (one entry per thread): with the
// lookup K1 to f32 takes as long as the same kernel with no decode at all
// (~3.8 us for 2^21 codes; ~0.3 us more to bf16), where the inline decoder
// (20 instructions per code) adds ~1.1 us to bf16 (scripts/k1_ablation.py).
// 16-bit codes decode inline, in straight-line code, so the chains
// overlap.  16-B loads of codes staged through shared memory, so that each
// 16-B store instruction still writes 512 contiguous bytes, were 7-17 %
// slower (the same script).
// The grid covers the array at kDecodeLoads loads per thread.  A start
// that is not aligned to a load (a view with an offset) is a scalar head
// of up to 7 codes, a length that is not a multiple of a load's codes a
// scalar tail, both in the same kernel; where the head leaves the values
// misaligned for the vector store, each value is stored on its own
// (kVecStore false).
//
// K2.  Bound on the H100: the larger of the bytes (4 B read, 1-2 B written
// per element: 3.13 us at 2^21 elements) and the integer issue rate (the
// branch-free posit::encode's instructions per element over 132 SMs x 64
// INT32 lanes per clock).  Design: each thread makes kEncodeLoads 16-B
// loads of 4 f32 (neighbouring threads on neighbouring 16 B), all in flight
// before the first encode, encodes their 4 kEncodeLoads elements (straight-
// line code, so the chains overlap) and stores each load's 4 codes in one
// 4-B (8-bit codes) or 8-B (16-bit codes) store; the grid covers the array
// at about 8 elements per thread.  A start that is not 16-B aligned (a view
// with an offset) is a scalar head of up to 3 elements, a length that is
// not a multiple of 4 a scalar tail, both in the same kernel; where the
// head leaves the codes misaligned for the vector store, the codes of each
// load are stored one by one (kVecStore false).  K2 has two modes, two
// instantiations of one kernel: subnormals flushed (kNormalize false, the
// kernels' rule, as K3 and K5 encode) or encoded as core.posit.encode_f32
// does (kNormalize true: the gradient wire, optim/compression.py, which
// runs K2 then K1 on every gradient leaf of a train step).
#include <cuda_bf16.h>

#include "posit_codec.cuh"

namespace {

constexpr int kThreads = 256;
// Each load takes the codes of one 16-B store of values (4 B of 8-bit
// codes to f32, 8 B to bf16; 8 B of 16-bit codes to f32, 16 B to bf16),
// kDecodeLoads of them in flight per thread; scripts/k1_ablation.py timed
// 1, 2, 4 and 8 loads, and 16-B loads staged through shared memory
template <typename CodeT, typename OutT>
constexpr int kCodesPerLoad = 16 / sizeof(OutT);
constexpr int kDecodeLoads = 4;

// kBytes of codes in 32-bit words, loaded in one instruction
template <int kBytes>
struct alignas(kBytes) Words {
  uint32_t w[kBytes / 4];
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// 32 bits of a 16-B store of values: one f32, or two bf16 (the first in
// the low half)
template <typename OutT>
__device__ __forceinline__ uint32_t out_bits(const float* v, int i) {
  if constexpr (std::is_same<OutT, float>::value)
    return __float_as_uint(v[i]);
  else
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
            << 16);
}

// Decodes (through `dec`) the kPer codes packed little-endian in `w` (code
// e in bits kBits e up) and stores them at `dst`: one 16-B store, or one
// value at a time.
template <int kBits, typename OutT, bool kVecStore, int kPer, int kWords,
          typename Dec>
__device__ __forceinline__ void decode_store(const uint32_t (&w)[kWords],
                                             OutT* dst, const Dec& dec) {
  float v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e)
    v[e] = dec(w[e * kBits / 32] >> (e * kBits % 32));
  if constexpr (kVecStore) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(out_bits<OutT>(v, 0), out_bits<OutT>(v, 1),
                   out_bits<OutT>(v, 2), out_bits<OutT>(v, 3));
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) store(dst + e, v[e]);
  }
}

template <int N, int ES, typename OutT, bool kVecStore>
__global__ void __launch_bounds__(kThreads) posit_decode_kernel(
    const typename posit::Code<N>::type* __restrict__ codes,
    OutT* __restrict__ out, int count, int head, int bias) {
  using CodeT = typename posit::Code<N>::type;
  constexpr int kBits = 8 * sizeof(CodeT);
  constexpr int kPerLoad = kCodesPerLoad<CodeT, OutT>;
  constexpr int kPerStore = 16 / sizeof(OutT);     // values per 16-B store
  using Load = Words<kPerLoad * sizeof(CodeT)>;
  static_assert(kThreads == 256, "one table entry per thread");
  // codes of n <= 8: every code's value in shared memory (posit::decode, so
  // bit-exact); 16-bit codes inline
  __shared__ float tab[N <= 8 ? 256 : 1];
  if constexpr (N <= 8) {
    tab[threadIdx.x] = posit::decode<N, ES>(threadIdx.x, bias);
    __syncthreads();
  }
  auto dec = [&](uint32_t c) {
    if constexpr (N <= 8) return tab[c & 0xFFu];
    else return posit::decode<N, ES>(c, bias);
  };
  const int nvec = (count - head) / kPerLoad;      // whole loads
  const Load* cv = reinterpret_cast<const Load*>(codes + head);
  OutT* dst = out + head;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  for (int g = tid; g < nvec; g += kDecodeLoads * stride) {
    Load c[kDecodeLoads];
#pragma unroll
    for (int u = 0; u < kDecodeLoads; ++u)
      c[u] = g + u * stride < nvec ? cv[g + u * stride] : Load{};
#pragma unroll
    for (int u = 0; u < kDecodeLoads; ++u)
      if (g + u * stride < nvec)
        decode_store<kBits, OutT, kVecStore, kPerStore>(
            c[u].w, dst + (size_t)(g + u * stride) * kPerLoad, dec);
  }
  const int tail = head + kPerLoad * nvec;         // first code of the tail
  if (tid < head) store(out + tid, dec(codes[tid]));
  if (tid < count - tail) store(out + tail + tid, dec(codes[tail + tid]));
}

template <int N, int ES, typename OutT>
int launch_decode(const void* codes, void* out, int count, int bias,
                  cudaStream_t st) {
  using CodeT = typename posit::Code<N>::type;
  constexpr int kPerLoad = kCodesPerLoad<CodeT, OutT>;
  constexpr int kLoadBytes = kPerLoad * sizeof(CodeT);
  // codes before a load's boundary
  const int lead = (int)(((kLoadBytes - (uintptr_t)codes % kLoadBytes) %
                          kLoadBytes) / sizeof(CodeT));
  const int head = lead < count ? lead : count;
  const int threads =
      ((count - head) / kPerLoad + kDecodeLoads - 1) / kDecodeLoads;
  const int grid = threads > kThreads ? (threads + kThreads - 1) / kThreads
                                      : 1;
  if (((uintptr_t)((OutT*)out + head) & 15) == 0)
    posit_decode_kernel<N, ES, OutT, true><<<grid, kThreads, 0, st>>>(
        (const CodeT*)codes, (OutT*)out, count, head, bias);
  else
    posit_decode_kernel<N, ES, OutT, false><<<grid, kThreads, 0, st>>>(
        (const CodeT*)codes, (OutT*)out, count, head, bias);
  return (int)cudaGetLastError();
}

constexpr int kEncodeLoads = 2;     // 16-B loads in flight per thread

template <int Bytes>
struct StoreVec;
template <>
struct StoreVec<4> {
  using type = uint32_t;
};
template <>
struct StoreVec<8> {
  using type = uint2;
};

template <int N, int ES, bool kVecStore, bool kNormalize>
__global__ void __launch_bounds__(kThreads) posit_encode_kernel(
    const float* __restrict__ x,
    typename posit::Code<N>::type* __restrict__ codes, int count, int head,
    int bias) {
  using CodeT = typename posit::Code<N>::type;
  using Vec = typename StoreVec<4 * sizeof(CodeT)>::type;
  const int nvec = (count - head) / 4;          // whole 16-B loads
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  CodeT* out = codes + head;
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  for (int g = tid; g < nvec; g += kEncodeLoads * stride) {
    float4 v[kEncodeLoads];
#pragma unroll
    for (int u = 0; u < kEncodeLoads; ++u)
      v[u] = g + u * stride < nvec ? xv[g + u * stride]
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kEncodeLoads; ++u) {
      union {
        Vec vec;
        CodeT c[4];
      } w;
      w.c[0] = (CodeT)posit::encode<N, ES, kNormalize>(v[u].x, bias);
      w.c[1] = (CodeT)posit::encode<N, ES, kNormalize>(v[u].y, bias);
      w.c[2] = (CodeT)posit::encode<N, ES, kNormalize>(v[u].z, bias);
      w.c[3] = (CodeT)posit::encode<N, ES, kNormalize>(v[u].w, bias);
      const int gu = g + u * stride;
      if (gu < nvec) {
        if constexpr (kVecStore) {
          *reinterpret_cast<Vec*>(out + 4 * gu) = w.vec;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) out[4 * gu + e] = w.c[e];
        }
      }
    }
  }
  const int tail = head + 4 * nvec;             // first element of the tail
  if (tid < head)
    codes[tid] = (CodeT)posit::encode<N, ES, kNormalize>(x[tid], bias);
  if (tid < count - tail)
    codes[tail + tid] =
        (CodeT)posit::encode<N, ES, kNormalize>(x[tail + tid], bias);
}

template <int N, int ES, bool kNormalize>
void launch_encode(const void* x, void* codes, int count, int head, int bias,
                   int grid, cudaStream_t st) {
  using CodeT = typename posit::Code<N>::type;
  const bool vec_store =
      ((uintptr_t)((CodeT*)codes + head) & (4 * sizeof(CodeT) - 1)) == 0;
  if (vec_store)
    posit_encode_kernel<N, ES, true, kNormalize><<<grid, kThreads, 0, st>>>(
        (const float*)x, (CodeT*)codes, count, head, bias);
  else
    posit_encode_kernel<N, ES, false, kNormalize><<<grid, kThreads, 0, st>>>(
        (const float*)x, (CodeT*)codes, count, head, bias);
}

}  // namespace

// codes: count codes (any 16-B offset); out: count values.
extern "C" int posit_decode(const void* codes, void* out, int count, int nbits,
                            int es, int bias, int out_bf16, void* stream) {
  if (count <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define DECODE_CASE(N, ES)                                                    \
  if (nbits == N && es == ES)                                                 \
    return out_bf16 ? launch_decode<N, ES, __nv_bfloat16>(codes, out, count,  \
                                                          bias, st)           \
                    : launch_decode<N, ES, float>(codes, out, count, bias, st);
  POSIT_FORMATS(DECODE_CASE)
#undef DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

// x: count f32 (4-B aligned, any 16-B offset); codes: count codes;
// normalize: 0 flushes subnormals, 1 encodes them as encode_f32 does (the
// caller guarantees that every subnormal's regime saturates at this bias).
extern "C" int posit_encode(const void* x, void* codes, int count, int nbits,
                            int es, int bias, int normalize, void* stream) {
  if ((uintptr_t)x & 3) return (int)cudaErrorMisalignedAddress;
  if (count <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  // elements before x is 16-B aligned
  const int lead = (int)(((16 - ((uintptr_t)x & 15)) & 15) / 4);
  const int head = lead < count ? lead : count;
  const int threads = ((count - head) / 4 + kEncodeLoads - 1) / kEncodeLoads;
  const int grid = threads > kThreads ? (threads + kThreads - 1) / kThreads
                                      : 1;
#define ENCODE_CASE(N, ES)                                                    \
  if (nbits == N && es == ES) {                                               \
    if (normalize)                                                            \
      launch_encode<N, ES, true>(x, codes, count, head, bias, grid, st);      \
    else                                                                      \
      launch_encode<N, ES, false>(x, codes, count, head, bias, grid, st);     \
    return (int)cudaGetLastError();                                           \
  }
  POSIT_FORMATS(ENCODE_CASE)
#undef ENCODE_CASE
  return (int)cudaErrorInvalidValue;
}
