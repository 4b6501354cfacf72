// K7: activations x posit-coded weights, out = (x @ decode(W)) * scale.
//
// Replaces repro/kernels/posit_matmul.py::posit_matmul (Pallas; a
// (M/bm, N/bn, K/bk) grid with K innermost, the f32 accumulator in the
// output block, decode_tile of each W tile in VMEM right before jnp.dot and
// the scale multiplied in on the last K step).
//
// Two paths, one C entry; the wrapper picks by M and alignment.
//
// Tensor-core path (M above the crossover, TMA-aligned shapes).  Bound on
// the H100 at the main path's shapes (M = 8192, K = 768): tensor-core
// operations.  The f32 product is exact as a sum of bf16 products: every
// finite posit of n <= 8 is one bf16, of n = 16 the sum of two
// (w0 = RNE(w), w1 = w - w0), and an f32 x the sum of three
// (x0 = RNE(x), x1 = RNE(x - x0), x2 = x - x0 - x1); each bf16 x bf16
// product is exact in f32, so only the order of the f32 sums differs from
// the plain version.  Passes: x f32 -> 3 pieces, x bf16 or compute bf16 ->
// 1; W 16-bit at f32 compute -> 2 pieces, else 1.  Design: one CTA of two
// warpgroups per 128 x 128 output tile, K in steps of 64 through a ring of
// 3-6 shared-memory stages (as many as fit) that thread 0 fills by TMA: x
// f32 or bf16 with the 128-byte swizzle, W codes plain, an mbarrier per
// stage.  While the tensor cores run step i, all 256 threads decode step
// i + 1's W code tile -- once per CTA, so each decoded weight serves 128
// rows -- into bf16 piece(s) in wgmma's K-major 128-byte-swizzled B layout
// (a second buffer): n <= 8 through a 256-entry table from posit::decode,
// kept as 32 copies so a warp's lookups never share a bank; 16-bit codes
// inline.  Each warpgroup owns 64 rows: per 16 of K it reads its A
// fragments from the swizzled x tile, splits them into bf16 pieces in
// registers and issues wgmma.m64n128k16 (A from registers, B from shared
// memory) once per (x piece, W piece), the next 16's fragments split while
// the tensor cores work.  The tensor cores' f32 sum is promoted into a
// separate register sum after every step, so it never holds more than 64
// of K (accumulating all of K there misses rtol 2e-5 / atol 2e-4 at
// K = 768).  One barrier per step frees the W buffer and the stage, which
// thread 0 then refills.  The epilogue multiplies the (N,) scale row in and
// stores f32.  Edges are TMA's zero fill, as the Pallas kernel's padding;
// NaR decodes to NaN and poisons its column.  A 384-thread CTA (a separate
// producer warpgroup) would cap registers at 168 and spill the two sums.
//
// Split-K path (M up to the crossover, and every shape TMA cannot take).
// Bound: the bytes of the codes.  Grid (N / (128 threads x C columns),
// splits, M / R): each thread owns C = 16 bytes of adjacent columns of one
// code row per load (16 posit8 or 8 posit16 codes, coalesced along N),
// decodes them through the same table (16-bit inline) and keeps R rows x C
// = 64 f32 FFMA sums over its split of K, with the x chunk in shared
// memory.  The sums leave row by row through shared memory, so every store
// is a whole coalesced row.  Partials go to a (splits, M, N) f32 workspace
// and a second kernel sums the splits in a fixed order (deterministic, no
// atomics) and applies the scale; one split writes out directly.
// Unaligned shapes take the scalar-load variant of the same kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "posit_codec.cuh"
#include "smem_opt_in.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The formats are runtime arguments (the entry admits only the built
// ones): the 8-bit (and 4-bit) ones differ only in their decode table, the
// 16-bit ones in an es that the whole CTA takes the same way.  Both decode
// through the codec's branch-free decoder with es at run time.
__device__ __forceinline__ float decode_fmt(uint32_t code, int nbits, int es,
                                            int bias) {
  return nbits == 4 ? posit::decode_es<4>(code, es, bias)
                    : posit::decode_es<8>(code, es, bias);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// PTX helpers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spins on the phase; a wait that never ends (a protocol fault) traps after
// ~2^30 polls instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (++polls == (1u << 30)) __trap();
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major, 128-byte-swizzled B tile: rows of 64 bf16 (128 B), 8-row groups
// 1024 B apart.  Fields: start >> 4, leading offset 1 (unused for this
// layout), stride offset 1024 >> 4, layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = smem_u32(tile);
  return ((a & 0x3FFFFull) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// D (64 x 128 f32, the warpgroup's fragments) (+)= A (64 x 16 bf16 in
// registers) x B (16 x 128 bf16, K-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc, uint32_t accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate)
      : "memory");
}

// ---------------------------------------------------------------------------
// Tensor-core path
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kTcThreads = 256;                  // two warpgroups
constexpr int kSmemMax = 232448;                 // a block's shared memory

// Shared memory of a CTA: as many stages of (x tile, code tile) as fit
// beside the two W buffers (WP bf16 pieces each) and the decode table.
template <int CB, typename XT, int WP>
struct TcSmem {
  static constexpr int kXBytes = kBM * kBK * (int)sizeof(XT);
  static constexpr int kCBytes = kBK * kBN * CB;
  static constexpr int kWBytes = kBN * kBK * 2;     // one bf16 piece
  static constexpr int kTabBytes = CB == 1 ? 256 * 32 * 4 : 0;  // 32 copies
  static constexpr int kFixed = 2 * WP * kWBytes + kTabBytes + 1024 + 64;
  static constexpr int kStages =
      (kSmemMax - kFixed) / (kXBytes + kCBytes) < 6
          ? (kSmemMax - kFixed) / (kXBytes + kCBytes) : 6;
  static constexpr int kX = 0;                      // 1024-aligned tiles
  static constexpr int kC = kX + kStages * kXBytes;
  static constexpr int kW = kC + kStages * kCBytes;  // 2 buffers x WP
  static constexpr int kTab = kW + 2 * WP * kWBytes;
  static constexpr int kBar = kTab + kTabBytes;
  static constexpr int kTotal = kBar + kStages * 8;
  static_assert(kStages >= 3 && kTotal + 1024 <= kSmemMax, "shared memory");
};

// Byte offset of x tile element (row, k) as TMA's 128-byte swizzle lays it
// out: f32 in two 32-column boxes of 128 rows, bf16 in one 64-column box.
__device__ __forceinline__ int x_off(float*, int row, int k) {
  const int kk = k & 31;
  return (k >> 5) * (kBM * 128) + row * 128 +
         ((((kk >> 2) ^ (row & 7)) << 4) | ((kk & 3) << 2));
}
__device__ __forceinline__ int x_off(bf16*, int row, int k) {
  return row * 128 + ((((k >> 3) ^ (row & 7)) << 4) | ((k & 7) << 1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment pair (row, k), (row, k + 1) as XP bf16 pieces.
template <int XP>
__device__ __forceinline__ void split_pair(const uint8_t* xs, float*, int row,
                                           int k, uint32_t (&out)[XP]) {
  const float2 v =
      *reinterpret_cast<const float2*>(xs + x_off((float*)nullptr, row, k));
  float a = v.x, b = v.y;
#pragma unroll
  for (int p = 0; p < XP; ++p) {
    out[p] = pack_bf16(a, b);
    if (p + 1 < XP) {               // remainder, exact in f32
      a -= round_bf16(a);
      b -= round_bf16(b);
    }
  }
}
template <int XP>
__device__ __forceinline__ void split_pair(const uint8_t* xs, bf16*, int row,
                                           int k, uint32_t (&out)[XP]) {
  out[0] = *reinterpret_cast<const uint32_t*>(xs +
                                              x_off((bf16*)nullptr, row, k));
}

// Thread t's share of decoding one W code tile (64 k x 128 n, row-major):
// column n = t % 128, chunks of 8 k c = t / 128 + 2j, each decoded to WP
// bf16 pieces and stored as 16 bytes at its swizzled place in the K-major
// B tile(s).  n <= 8 decodes through 32 copies of the table, lane l reading
// copy l (word code * 32 + l: bank l), so lookups never conflict.
template <int CB, int WP>
__device__ __forceinline__ void decode_w_share(const uint8_t* codes,
                                               uint8_t* wout, int t,
                                               const uint32_t* tab, int es,
                                               int bias) {
  const uint32_t* tl = tab + (t & 31);
  constexpr int kWBytes = kBN * kBK * 2;
  const int n = t % kBN;
#pragma unroll
  for (int j = 0; j < kBK / 8 / 2; ++j) {
    const int c = t / kBN + 2 * j;
    uint32_t w0[4], w1[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int k = c * 8 + 2 * h;
      if constexpr (CB == 1) {
        const uint32_t lo = tl[codes[k * kBN + n] * 32];
        const uint32_t hi = tl[codes[(k + 1) * kBN + n] * 32];
        w0[h] = lo | (hi << 16);
      } else {
        const uint16_t* c16 = reinterpret_cast<const uint16_t*>(codes);
        const float a = posit::decode_es<16>(c16[k * kBN + n], es, bias);
        const float b =
            posit::decode_es<16>(c16[(k + 1) * kBN + n], es, bias);
        w0[h] = pack_bf16(a, b);
        if (WP == 2) w1[h] = pack_bf16(a - round_bf16(a), b - round_bf16(b));
      }
    }
    const int off = n * 128 + ((c ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(wout + off) =
        make_uint4(w0[0], w0[1], w0[2], w0[3]);
    if (WP == 2)
      *reinterpret_cast<uint4*>(wout + kWBytes + off) =
          make_uint4(w1[0], w1[1], w1[2], w1[3]);
  }
}

template <int CB, typename XT, int XP, int WP>
__global__ void __launch_bounds__(kTcThreads, 1)
    tc_kernel(const __grid_constant__ CUtensorMap tmx,
              const __grid_constant__ CUtensorMap tmw,
              const float* __restrict__ scale, float* __restrict__ out, int M,
              int K, int Ncols, int nbits, int es, int bias) {
  using L = TcSmem<CB, XT, WP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + L::kTab);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;

  constexpr int kStages = L::kStages;
  // thread 0 loads step i's x and code tiles into stage i % kStages
  auto load_step = [&](int i) {
    const int s = i % kStages, k0 = i * kBK;
    mbar_expect_tx(&full[s], L::kXBytes + L::kCBytes);
    uint8_t* xs = smem + L::kX + s * L::kXBytes;
    tma_load_2d(xs, &tmx, k0, m0, &full[s]);
    if (sizeof(XT) == 4)
      tma_load_2d(xs + kBM * 128, &tmx, k0 + 32, m0, &full[s]);
    tma_load_2d(smem + L::kC + s * L::kCBytes, &tmw, n0, k0, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(kStages, nk); ++i) load_step(i);
  }
  if (CB == 1) {                 // each code once, then 32 copies of it
    uint32_t* once = reinterpret_cast<uint32_t*>(smem + L::kW);
    once[tid] = __bfloat16_as_ushort(
        __float2bfloat16_rn(decode_fmt(tid, nbits, es, bias)));
    __syncthreads();
    for (int i = tid; i < 256 * 32; i += kTcThreads) tab[i] = once[i / 32];
  }
  __syncthreads();

  auto decode_step = [&](int i) {        // W tile of step i, once per CTA
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    decode_w_share<CB, WP>(smem + L::kC + s * L::kCBytes,
                           smem + L::kW + (i & 1) * WP * L::kWBytes, tid, tab,
                           es, bias);
    fence_async_smem();                  // visible to wgmma's reads
  };
  const int wg = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int row = wg * 64 + w * 16 + lane / 4;   // and row + 8
  const int kq = (lane % 4) * 2;                  // and kq + 8
  float acc[64], sum[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = sum[j] = 0.f;

  decode_step(0);
  __syncthreads();
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    const uint8_t* xs = smem + L::kX + s * L::kXBytes;
    const uint8_t* wb = smem + L::kW + (i & 1) * WP * L::kWBytes;
    uint32_t a[XP][4][4];          // [piece][k16 step][fragment register]
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // this 16 of K's fragments, split while the previous 16 multiply
      uint32_t f[4][XP];
      split_pair<XP>(xs, (XT*)nullptr, row, kk * 16 + kq, f[0]);
      split_pair<XP>(xs, (XT*)nullptr, row + 8, kk * 16 + kq, f[1]);
      split_pair<XP>(xs, (XT*)nullptr, row, kk * 16 + kq + 8, f[2]);
      split_pair<XP>(xs, (XT*)nullptr, row + 8, kk * 16 + kq + 8, f[3]);
#pragma unroll
      for (int pc = 0; pc < XP; ++pc)
#pragma unroll
        for (int r = 0; r < 4; ++r) a[pc][kk][r] = f[r][pc];
      wgmma_fence();
#pragma unroll
      for (int pc = 0; pc < XP; ++pc)
#pragma unroll
        for (int q = 0; q < WP; ++q)
          wgmma_rs(acc, a[pc][kk], desc_sw128(wb + q * L::kWBytes) + 2 * kk,
                   (kk | pc | q) != 0);
    }
    wgmma_commit();
    if (i + 1 < nk) decode_step(i + 1);   // overlaps the tensor core
    wgmma_wait0();
    fence_acc(acc);
#pragma unroll
    for (int j = 0; j < 64; ++j) sum[j] += acc[j];   // promote every 64 K
    // x and codes of stage s read, W buffer (i & 1) free, step i + 1's
    // W decoded: refill stage s
    __syncthreads();
    if (tid == 0 && i + kStages < nk) load_step(i + kStages);
  }

  // epilogue: fragment j covers columns 8 (j / 4) + kq + (j & 1), rows
  // row + 8 ((j / 2) & 1)
#pragma unroll
  for (int nb = 0; nb < 16; ++nb) {
    const int n = n0 + nb * 8 + kq;
    if (n >= Ncols) continue;
    const float s0 = scale[n];
    const float s1 = n + 1 < Ncols ? scale[n + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row + 8 * h;
      if (m >= M) continue;
      float* o = out + (size_t)m * Ncols + n;
      const int j = nb * 4 + 2 * h;
      if (n + 1 < Ncols)
        *reinterpret_cast<float2*>(o) = make_float2(sum[j] * s0,
                                                    sum[j + 1] * s1);
      else
        o[0] = sum[j] * s0;
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D map of a row-major (outer, inner) matrix, boxes of
// (box_outer, box_inner) elements; out-of-bounds elements load as 0.
bool make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* ptr,
              int elem_bytes, int inner, int outer, int box_inner,
              int box_outer, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estride[2] = {1, 1};
  return enc(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int CB, typename XT, int XP, int WP>
int launch_tc(const void* x, const void* w, const float* scale, float* out,
              int M, int K, int Ncols, int nbits, int es, int bias,
              cudaStream_t st) {
  using L = TcSmem<CB, XT, WP>;
  CUtensorMap tmx, tmw;
  const bool xf = sizeof(XT) == 4;
  if (!make_map(&tmx,
                xf ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                x, (int)sizeof(XT), K, M, xf ? 32 : 64, kBM,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&tmw,
                CB == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                        : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                w, CB, Ncols, K, kBN, kBK, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const int smem = L::kTotal + 1024;
  auto kern = tc_kernel<CB, XT, XP, WP>;
  static SmemOptIn opt_in;
  cudaError_t err = opt_in_smem(opt_in, kern, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Ncols + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kern<<<grid, kTcThreads, smem, st>>>(tmx, tmw, scale, out, M, K, Ncols,
                                       nbits, es, bias);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Split-K path
// ---------------------------------------------------------------------------
constexpr int kSkThreads = 128;

template <int CB, typename XT, bool kBf16, bool kVec>
__global__ void __launch_bounds__(kSkThreads)
    skinny_kernel(const XT* __restrict__ x, const void* __restrict__ wv,
                  const float* __restrict__ scale, float* __restrict__ work,
                  float* __restrict__ out, int M, int K, int Ncols,
                  int nbits, int es, int bias, int kchunk, int splits) {
  using CodeT = typename std::conditional<CB == 1, uint8_t, uint16_t>::type;
  constexpr int C = 16 / CB;                   // columns per thread
  constexpr int R = 64 / C;                    // rows per thread (64 sums)
  constexpr int LDS = C + 4;                   // staging stride (no conflicts)
  extern __shared__ float sk_smem[];
  float* tab = sk_smem;                        // 256 entries (CB == 1)
  float* xs = sk_smem + (CB == 1 ? 256 : 0);   // R x kchunk
  float* stage = xs + ((R * kchunk + 3) & ~3); // kSkThreads x LDS
  const CodeT* w = reinterpret_cast<const CodeT*>(wv);
  const int tid = threadIdx.x;
  const int split = blockIdx.y, m0 = blockIdx.z * R;
  const int kb = split * kchunk;
  const int nk = max(min(K, kb + kchunk) - kb, 0);
  const int c0 = blockIdx.x * kSkThreads * C;  // the CTA's first column
  const int n0 = c0 + tid * C;

  if (CB == 1)
    for (int i = tid; i < 256; i += kSkThreads) {
      const float v = decode_fmt(i, nbits, es, bias);
      tab[i] = kBf16 ? round_bf16(v) : v;
    }
  for (int e = tid; e < R * nk; e += kSkThreads) {
    const int r = e / nk, kk = e % nk, m = m0 + r;
    float v = m < M ? load_f32(x + (size_t)m * K + kb + kk) : 0.f;
    xs[r * kchunk + kk] = kBf16 ? round_bf16(v) : v;
  }
  __syncthreads();

  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[r][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < nk; ++k) {
    const CodeT* src = w + (size_t)(kb + k) * Ncols + n0;
    union {
      uint4 v;
      CodeT c[C];
    } u;
    if (kVec) {
      u.v = n0 < Ncols ? *reinterpret_cast<const uint4*>(src) : uint4{};
    } else {
#pragma unroll
      for (int j = 0; j < C; ++j) u.c[j] = n0 + j < Ncols ? src[j] : CodeT(0);
    }
    float wd[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if constexpr (CB == 1) {
        wd[j] = tab[u.c[j]];
      } else {
        const float v = posit::decode_es<16>(u.c[j], es, bias);
        wd[j] = kBf16 ? round_bf16(v) : v;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float xv = xs[r * kchunk + k];
#pragma unroll
      for (int j = 0; j < C; ++j) acc[r][j] = fmaf(xv, wd[j], acc[r][j]);
    }
  }
  // row by row through shared memory, so the CTA writes whole rows of
  // its 128 x C columns, coalesced
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (m0 + r >= M) break;                    // the same for the CTA
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C; j += 4)
      *reinterpret_cast<float4*>(stage + tid * LDS + j) =
          make_float4(acc[r][j], acc[r][j + 1], acc[r][j + 2], acc[r][j + 3]);
    __syncthreads();
    const size_t row = (size_t)(m0 + r) * Ncols;
    float* dst =
        splits == 1 ? out + row : work + (size_t)split * M * Ncols + row;
    if (kVec) {                  // N % C == 0: whole float4s, 16-B aligned
      for (int e = 4 * tid; e < kSkThreads * C; e += 4 * kSkThreads) {
        const int n = c0 + e;
        if (n >= Ncols) break;
        float4 v = *reinterpret_cast<const float4*>(stage + (e / C) * LDS +
                                                    e % C);
        if (splits == 1)
          v = make_float4(v.x * scale[n], v.y * scale[n + 1],
                          v.z * scale[n + 2], v.w * scale[n + 3]);
        *reinterpret_cast<float4*>(dst + n) = v;
      }
    } else {
      for (int e = tid; e < kSkThreads * C; e += kSkThreads) {
        const int n = c0 + e;
        if (n >= Ncols) break;
        const float v = stage[(e / C) * LDS + e % C];
        dst[n] = splits == 1 ? v * scale[n] : v;
      }
    }
  }
}

// out = scale * (sum of the splits' partials, in split order); four
// adjacent outputs per thread where N % 4 == 0, else one
template <int V>
__global__ void combine_kernel(const float* __restrict__ work,
                               const float* __restrict__ scale,
                               float* __restrict__ out, int M, int Ncols,
                               int splits) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const size_t mn = (size_t)M * Ncols, mv = mn / V;
  const Vec* wv = reinterpret_cast<const Vec*>(work);
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < mv;
       e += (size_t)gridDim.x * blockDim.x) {
    float s[V] = {};
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) {
      const Vec v = wv[sp * mv + e];
      const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] += f[j];
    }
    const size_t n = (e * V) % Ncols;
#pragma unroll
    for (int j = 0; j < V; ++j) out[e * V + j] = s[j] * scale[n + j];
  }
}

template <int CB, typename XT, bool kBf16>
int launch_skinny(const void* x, const void* w, const float* scale,
                  float* out, float* work, int M, int K, int Ncols,
                  int nbits, int es, int bias, int splits, cudaStream_t st) {
  const int C = 16 / CB, R = 64 / C;
  const int kchunk = (K + splits - 1) / splits;
  const size_t smem =
      sizeof(float) * ((CB == 1 ? 256 : 0) + (((size_t)R * kchunk + 3) & ~3) +
                       (size_t)kSkThreads * (C + 4));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long gz = (M + R - 1) / R;
  if (gz > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((Ncols + kSkThreads * C - 1) / (kSkThreads * C), splits,
                  (unsigned)gz);
  // 16-byte code rows: N a multiple of C and a 16-byte-aligned base
  const bool vec = Ncols % C == 0 && ((uintptr_t)w & 15) == 0;
  if (vec)
    skinny_kernel<CB, XT, kBf16, true><<<grid, kSkThreads, smem, st>>>(
        (const XT*)x, w, scale, work, out, M, K, Ncols, nbits, es, bias,
        kchunk, splits);
  else
    skinny_kernel<CB, XT, kBf16, false><<<grid, kSkThreads, smem, st>>>(
        (const XT*)x, w, scale, work, out, M, K, Ncols, nbits, es, bias,
        kchunk, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const bool v4 = Ncols % 4 == 0;
  const long long items = (long long)M * Ncols / (v4 ? 4 : 1);
  const int blocks = (int)(items / 256 + 1 < 4096 ? items / 256 + 1 : 4096);
  if (v4)
    combine_kernel<4><<<blocks, 256, 0, st>>>(work, scale, out, M, Ncols,
                                              splits);
  else
    combine_kernel<1><<<blocks, 256, 0, st>>>(work, scale, out, M, Ncols,
                                              splits);
  return (int)cudaGetLastError();
}

bool known_format(int nbits, int es) {
#define KNOWN_CASE(N, ES) \
  if (nbits == N && es == ES) return true;
  POSIT_FORMATS(KNOWN_CASE)
#undef KNOWN_CASE
  return false;
}

}  // namespace

// x (M, K) f32 or bf16, w (K, N) codes, scale (N,) f32, out (M, N) f32.
// splits == 0 takes the tensor-core path (TMA-aligned shapes only); splits
// >= 1 the split-K path with `work` a (splits, M, N) f32 workspace (unused
// for one split).
extern "C" int posit_matmul(const void* x, const void* w, const void* scale,
                            void* out, void* work, int M, int K, int Ncols,
                            int nbits, int es, int bias, int x_bf16,
                            int compute_bf16, int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!known_format(nbits, es) || splits < 0)
    return (int)cudaErrorInvalidValue;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  if (splits == 0) {
    if ((M + kBM - 1) / kBM > 65535 || K < 1) return (int)cudaErrorInvalidValue;
#define TC(CB, XT, XP, WP) \
  return launch_tc<CB, XT, XP, WP>(x, w, sc, o, M, K, Ncols, nbits, es, bias, st)
    if (nbits <= 8) {
      if (x_bf16) TC(1, bf16, 1, 1);
      if (compute_bf16) TC(1, float, 1, 1);
      TC(1, float, 3, 1);
    }
    if (x_bf16) {
      if (compute_bf16) TC(2, bf16, 1, 1);
      TC(2, bf16, 1, 2);
    }
    if (compute_bf16) TC(2, float, 1, 1);
    TC(2, float, 3, 2);
#undef TC
  }
  float* wk = (float*)work;
#define SK(CB, XT, BF) \
  return launch_skinny<CB, XT, BF>(x, w, sc, o, wk, M, K, Ncols, nbits, es, \
                                   bias, splits, st)
  if (nbits <= 8) {
    if (x_bf16) {
      if (compute_bf16) SK(1, bf16, true);
      SK(1, bf16, false);
    }
    if (compute_bf16) SK(1, float, true);
    SK(1, float, false);
  }
  if (x_bf16) {
    if (compute_bf16) SK(2, bf16, true);
    SK(2, bf16, false);
  }
  if (compute_bf16) SK(2, float, true);
  SK(2, float, false);
#undef SK
}
