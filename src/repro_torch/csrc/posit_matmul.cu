// K7: activations x posit-coded weights, out = (x @ decode(W)) * scale.
//
// Replaces repro/kernels/posit_matmul.py::posit_matmul (Pallas; a
// (M/bm, N/bn, K/bk) grid with K innermost, the f32 accumulator in the
// output block, decode_tile of each W tile in VMEM right before jnp.dot and
// the scale multiplied in on the last K step).
//
// Bound on the H100: at the main path's shapes (M = 8192 tokens, K = 768)
// float32 operations: 2*M*K*N FMAs against 1-2 bytes per weight and 2-4
// bytes per activation.  At M = 8 it is bytes (the codes of W).
//
// Design (simple and right first; wgmma/TMA is later work): one CTA of 256
// threads owns a 64x64 output tile and walks K in steps of 32.  Each step
// stages the x tile in shared memory (converted to f32, transposed so a
// thread reads its 4 rows from one shared row) and the W code tile decoded
// with posit::decode<N,ES> into shared memory, so every decoded weight
// serves 64 rows.  Each thread keeps a 4x4 block of f32 accumulators in
// registers (rows ty + 16i, columns tx + 16j: a warp's shared reads are
// broadcasts) and multiplies the column's scale in after the last K step.
// Ragged edges are bounds checks: x and W outside the matrix stage as 0,
// as the Pallas kernel's zero padding does.  compute_dtype=bfloat16 rounds
// both operands to bf16 (RNE) as they are staged, as the reference does
// before its f32-accumulated dot.  NaR decodes to NaN and poisons its
// column, as in the reference.
#include <cuda_bf16.h>

#include "posit_codec.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int N, int ES, typename XT, bool kBf16>
__global__ void __launch_bounds__(kThreads)
posit_matmul_kernel(const XT* __restrict__ x,
                    const typename posit::Code<N>::type* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int M, int K, int Ncols, int bias) {
  __shared__ float xs[kBK][kBM + 1];   // x tile, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN];       // decoded W tile: ws[k][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // x tile: consecutive threads read consecutive k of one row
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int mm = idx / kBK, kk = idx % kBK;
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < K) v = load_f32(x + (size_t)m * K + k);
      if (kBf16) v = round_bf16(v);
      xs[kk][mm] = v;
    }
    // W tile: consecutive threads read consecutive n of one row, decode
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int idx = tid + r * kThreads;
      const int kk = idx / kBN, nn = idx % kBN;
      const int k = k0 + kk, n = n0 + nn;
      float v = 0.0f;
      if (k < K && n < Ncols)
        v = posit::decode<N, ES>(w[(size_t)k * Ncols + n], bias);
      if (kBf16) v = round_bf16(v);
      ws[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= Ncols) continue;
    const float s = scale[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M) out[(size_t)m * Ncols + n] = acc[i][j] * s;
    }
  }
}

template <int N, int ES>
int launch(const void* x, const void* w, const float* scale, float* out,
           int M, int K, int Ncols, int bias, int x_bf16, int compute_bf16,
           cudaStream_t st) {
  using CodeT = typename posit::Code<N>::type;
  const dim3 grid((Ncols + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  const CodeT* wc = (const CodeT*)w;
#define K7_LAUNCH(XT, BF)                                                      \
  posit_matmul_kernel<N, ES, XT, BF><<<grid, kThreads, 0, st>>>(               \
      (const XT*)x, wc, scale, out, M, K, Ncols, bias)
  if (x_bf16) {
    if (compute_bf16) K7_LAUNCH(__nv_bfloat16, true);
    else K7_LAUNCH(__nv_bfloat16, false);
  } else {
    if (compute_bf16) K7_LAUNCH(float, true);
    else K7_LAUNCH(float, false);
  }
#undef K7_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) f32 or bf16, w (K, N) codes, scale (N,) f32, out (M, N) f32.
extern "C" int posit_matmul(const void* x, const void* w, const void* scale,
                            void* out, int M, int K, int Ncols, int nbits,
                            int es, int bias, int x_bf16, int compute_bf16,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
#define MATMUL_CASE(N, ES)                                                    \
  if (nbits == N && es == ES)                                                 \
    return launch<N, ES>(x, w, (const float*)scale, (float*)out, M, K, Ncols, \
                         bias, x_bf16, compute_bf16, st);
  POSIT_FORMATS(MATMUL_CASE)
#undef MATMUL_CASE
  return (int)cudaErrorInvalidValue;
}
