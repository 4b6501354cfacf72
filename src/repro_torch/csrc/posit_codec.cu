// K1 and K2: standalone posit decode / encode over flat arrays.
//
// K1 posit_decode_kernel replaces repro/kernels/posit_decode.py::posit_decode
// (Pallas, body decode_tile); K2 posit_encode_kernel replaces
// repro/kernels/posit_encode.py::posit_encode (Pallas, body encode_tile).
//
// Bound on the H100: device-memory bytes.  Each element costs 1-2 bytes of
// codes and 4 bytes of f32 against ~40 integer ops, far below the ~295 ops
// per byte where the card stops being memory-bound.  Design: a grid-stride
// elementwise loop, one element per thread per step with neighbouring
// threads on neighbouring addresses (coalesced), enough blocks to fill every
// SM; the codec itself is branch-light integer code in registers.
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

template <int N, int ES>
__global__ void posit_encode_kernel(const float* __restrict__ x,
                                    typename posit::Code<N>::type* __restrict__ codes,
                                    int count, int bias) {
  using CodeT = typename posit::Code<N>::type;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += gridDim.x * blockDim.x)
    codes[i] = (CodeT)posit::encode<N, ES>(x[i], bias);
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

extern "C" int posit_encode(const void* x, void* codes, int count, int nbits,
                            int es, int bias, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = grid_for(count);
#define ENCODE_CASE(N, ES)                                                    \
  if (nbits == N && es == ES) {                                               \
    posit_encode_kernel<N, ES><<<grid, kThreads, 0, st>>>(                    \
        (const float*)x, (posit::Code<N>::type*)codes, count, bias);          \
    return (int)cudaGetLastError();                                           \
  }
  POSIT_FORMATS(ENCODE_CASE)
#undef ENCODE_CASE
  return (int)cudaErrorInvalidValue;
}
