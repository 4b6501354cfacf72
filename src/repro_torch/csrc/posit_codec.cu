// K1 and K2: standalone posit decode / encode over flat arrays.
//
// K1 posit_decode_kernel replaces repro/kernels/posit_decode.py::posit_decode
// (Pallas, body decode_tile); K2 posit_encode_kernel replaces
// repro/kernels/posit_encode.py::posit_encode (Pallas, body encode_tile).
//
// K1.  Bound on the H100: device-memory bytes or the integer issue rate
// (1-2 bytes of codes and 4 of f32 per element against a few dozen integer
// instructions).  Design: a grid-stride elementwise loop, one element per
// thread per step with neighbouring threads on neighbouring addresses
// (coalesced), at most 132 x 16 blocks.
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
// load are stored one by one (kVecStore false).
#include <cuda_bf16.h>

#include "posit_codec.cuh"

namespace {

constexpr int kThreads = 256;

int grid_for(int count) {
  long long blocks = ((long long)count + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int N, int ES, typename OutT>
__global__ void posit_decode_kernel(const typename posit::Code<N>::type* __restrict__ codes,
                                    OutT* __restrict__ out, int count, int bias) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x)
    store(out + i, posit::decode<N, ES>(codes[i], bias));
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

template <int N, int ES, bool kVecStore>
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
      w.c[0] = (CodeT)posit::encode<N, ES>(v[u].x, bias);
      w.c[1] = (CodeT)posit::encode<N, ES>(v[u].y, bias);
      w.c[2] = (CodeT)posit::encode<N, ES>(v[u].z, bias);
      w.c[3] = (CodeT)posit::encode<N, ES>(v[u].w, bias);
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
  if (tid < head) codes[tid] = (CodeT)posit::encode<N, ES>(x[tid], bias);
  if (tid < count - tail)
    codes[tail + tid] = (CodeT)posit::encode<N, ES>(x[tail + tid], bias);
}

}  // namespace

extern "C" int posit_decode(const void* codes, void* out, int count, int nbits,
                            int es, int bias, int out_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = grid_for(count);
#define DECODE_CASE(N, ES)                                                    \
  if (nbits == N && es == ES) {                                               \
    using CodeT = posit::Code<N>::type;                                       \
    if (out_bf16)                                                             \
      posit_decode_kernel<N, ES><<<grid, kThreads, 0, st>>>(                  \
          (const CodeT*)codes, (__nv_bfloat16*)out, count, bias);             \
    else                                                                      \
      posit_decode_kernel<N, ES><<<grid, kThreads, 0, st>>>(                  \
          (const CodeT*)codes, (float*)out, count, bias);                     \
    return (int)cudaGetLastError();                                           \
  }
  POSIT_FORMATS(DECODE_CASE)
#undef DECODE_CASE
  return (int)cudaErrorInvalidValue;
}

// x: count f32 (4-B aligned, any 16-B offset); codes: count codes.
extern "C" int posit_encode(const void* x, void* codes, int count, int nbits,
                            int es, int bias, void* stream) {
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
    using CodeT = posit::Code<N>::type;                                       \
    const bool vec_store =                                                    \
        ((uintptr_t)((CodeT*)codes + head) & (4 * sizeof(CodeT) - 1)) == 0;   \
    if (vec_store)                                                            \
      posit_encode_kernel<N, ES, true><<<grid, kThreads, 0, st>>>(            \
          (const float*)x, (CodeT*)codes, count, head, bias);                 \
    else                                                                      \
      posit_encode_kernel<N, ES, false><<<grid, kThreads, 0, st>>>(           \
          (const float*)x, (CodeT*)codes, count, head, bias);                 \
    return (int)cudaGetLastError();                                           \
  }
  POSIT_FORMATS(ENCODE_CASE)
#undef ENCODE_CASE
  return (int)cudaErrorInvalidValue;
}
