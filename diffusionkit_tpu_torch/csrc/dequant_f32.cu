// Kernels C (int4_matmul) and #13 (int8_matmul) on fp32 activations above
// 16 rows: the weight-only linears of an fp32-upcast block (SD3.5-large's
// block 35) and of any fp32 model, `dequant_mm_3xtf32<BITS>`, the products
// on the tensor cores as 3xTF32 wgmma. At M <= 16 (the `ada` GEMVs of an
// fp32 model) the split-K GEMV of gemv_sm90.cu, `dequant_gemv_f32`, runs
// them; it replaced an FMA tile of 16 x 64 that each of N / 64 blocks ran
// over all of K (5.5 and 8.9 % of the bytes bound at SD3.5-large's `ada`).
//
// Replaces, at fp32, the Pallas kernels diffusionkit_tpu/ops/int4_matmul.py:
// int4_matmul (_kernel, C) and int8_matmul (_kernel8, #13), which the
// reference runs at any dtype: y = x @ W with W = q * s + z in fp32 (a
// product and a sum, each rounded: no FMA), here NOT rounded further (x's
// dtype is fp32); the products summed in fp32, y fp32. Both forms stay
// within one fp32 ulp + 2K 2^-24 (|x| @ |w|) of fp32 math.
//
// Bound on the H100: the fp32-accurate products, 3xTF32 at 495 / 3 TFLOP/s:
// block 35's (8192, 2432, 9728) fc1, 388 GFLOP, 2.35 ms (5.8 ms on the CUDA
// cores' 67 TFLOP/s FMA pipe). Measured by chip_smoke.py (NVIDIA H100 80GB
// HBM3, 700 W): 6.00 ms there, 65 TFLOP/s; the first form, an FMA tile at
// every M, took 2.83 ms at (8192, 2432, 2432), 34 TFLOP/s, against 1.57 now
// and 2.15 for dequantising then cuBLAS SGEMM. Each 3xTF32 wgmma reads both operands
// from shared memory, three times a product: the tiles' traffic, with the
// producers' split stores, is what bounds it below the tensor cores.
//  * 3xTF32 (flash_attention_f32.cu's scheme): x = hi + lo, both tf32
//    (cvt.rna), likewise the dequantised weight; a product sums lo.hi +
//    hi.lo + hi.hi. The tensor cores truncate as they accumulate, so each
//    k tile of 32 (four k8 steps, twelve products) sums from zero and is
//    folded into the fp32 accumulator by one add.
//  * One block: 128 rows x 64 columns, 512 threads. wgmma's tf32 form takes
//    both shared-memory operands K-major, so every operand is a 128-byte-
//    swizzled tile of 32-value rows written by two producer warpgroups: x's
//    rows (read as float4 from global memory, rows `lda` apart, rows past M
//    zero) and the weight's columns (a packed word, or 8 bytes, is 8
//    consecutive k of one column: two 16-byte chunks of its row), each
//    split into a hi and a lo tile; 4 stages of 48 KB. The producer fetches
//    tile k + 1 into registers before storing tile k. Two consumer
//    warpgroups, 64 rows each, run the wgmmas (m64n64k8 SS).
// K tiles of 32 never straddle a group (group 32 or a multiple of 64), so a
// tile's column takes one scale and one zero.

#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BK = 32;  // k a tile: within one group (32 or a multiple of 64)

// ---- M > 16: 3xTF32 on wgmma ----------------------------------------------

namespace tf32mm {
constexpr int BM = 128, BN = 64, NS = 4;       // rows, columns, stages; k tiles of BK = 32
constexpr uint32_t kX = BM * BK * 4;            // one x tile (hi or lo), K-major, 16 KB
constexpr uint32_t kW = BN * BK * 4;            // one weight tile (hi or lo), K-major, 8 KB
constexpr uint32_t kStage = 2 * kX + 2 * kW;    // x hi, x lo, w hi, w lo
constexpr uint32_t kBar = NS * kStage;          // then full[NS], empty[NS]
constexpr size_t kSmem = kBar + 16 * NS + 1024;  // + alignment
constexpr int NP = 256;                         // producer threads (two warpgroups)
constexpr int XV = BM * BK / 4 / NP;            // x float4 a producer thread a tile (4)
constexpr int WI = BK / 8 * BN / NP;            // C: packed words a producer thread a tile (1)
static_assert(kSmem <= 232448, "one block an SM");
static_assert(BK / 2 * BN / 4 == NP, "#13: 2 k x 4 columns of bytes a producer thread");

// Byte offset of 16-byte chunk c (4 values) of row r of a K-major tile of
// 32-value (128-byte) rows in the 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Split 4 values into tf32 hi and lo and store both: `hi` at off, lo at
// off + half.
__device__ __forceinline__ void store_split(unsigned char* tile, uint32_t half, uint32_t off,
                                            float a, float b, float c, float d) {
  uint32_t h[4], l[4];
  dk::sm90::split_tf32(a, h[0], l[0]);
  dk::sm90::split_tf32(b, h[1], l[1]);
  dk::sm90::split_tf32(c, h[2], l[2]);
  dk::sm90::split_tf32(d, h[3], l[3]);
  *reinterpret_cast<uint4*>(tile + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(tile + half + off) = make_uint4(l[0], l[1], l[2], l[3]);
}

// One k tile's global operands as a producer thread holds them: XV float4
// of x (row id / 8, k 4 (id % 8)); for C, WI words, each 8 k of one column
// (column id % 64, k 8 (id / 64)), with that column's scale and zero; for
// #13, 2 k rows of 4 columns' bytes (k 2 (pt / 16), columns 4 (pt % 16)),
// one word a row, with the 4 columns' scales and zeros.
struct Fetch4 {
  float4 x[XV];
  uint32_t w[WI];
  float s[WI], z[WI];
};
struct Fetch8 {
  float4 x[XV];
  uint32_t w[2];
  float4 s, z;
};
template <int BITS>
using Fetch = typename std::conditional<BITS == 4, Fetch4, Fetch8>::type;
}  // namespace tf32mm

// y[m0 .. m0 + 127, n0 .. n0 + 63] in fp32: four warpgroups. The producers
// (warpgroups 0 and 1: one could not keep the consumers fed on the H100)
// read x and the packed weight of the next k tile into registers from
// global memory, then split x's values and the dequantised weights
// (q * s, then + z, each rounded) into tf32 hi and lo and store them into
// the stage's four 128-byte-swizzled K-major tiles. Consumer warpgroup c
// (2, 3) owns rows 64 (c - 2) .. + 63: per k tile four k8 steps
// of three SS wgmma m64n64k8 (x lo . w hi, x hi . w lo, x hi . w hi) into a
// fresh accumulator, folded into the fp32 sum by one add a value (no chain
// longer than a tile's twelve products truncates on the tensor cores).
template <int BITS>
__global__ void __launch_bounds__(512, 1)
    dequant_mm_3xtf32(const float* __restrict__ x, const void* __restrict__ qw,
                      const float* __restrict__ scales, const float* __restrict__ zeros,
                      float* __restrict__ y, int M, int N, int K, int group, long long lda) {
  using namespace tf32mm;
  using namespace dk::sm90;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  unsigned char* gen = smem_raw + (base - raw);
  const uint32_t full = base + kBar, empty = full + 8 * NS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN, KT = K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, NP);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;

  if (wg < 2) {
    const int pt = threadIdx.x;
    auto fetch = [&](int kt, Fetch<BITS>& f) {
      const int k0 = kt * BK, gi = k0 / group;
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int id = i * NP + pt, r = id / 8, c = id % 8;
        f.x[i] = m0 + r < M ? __ldg(reinterpret_cast<const float4*>(x + (m0 + r) * lda + k0) + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if constexpr (BITS == 4) {
#pragma unroll
        for (int i = 0; i < WI; ++i) {
          const int id = i * NP + pt, n = n0 + id % BN, kr = id / BN;  // k0 + 8 kr .. + 7
          f.w[i] = __ldg(static_cast<const uint32_t*>(qw) + (long long)(k0 / 8 + kr) * N + n);
          f.s[i] = __ldg(scales + (long long)gi * N + n);
          f.z[i] = __ldg(zeros + (long long)gi * N + n);
        }
      } else {
        const int n = n0 + 4 * (pt % 16), kr = k0 + 2 * (pt / 16);
        const uint8_t* q8 = static_cast<const uint8_t*>(qw) + (long long)kr * N + n;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          f.w[j] = __ldg(reinterpret_cast<const uint32_t*>(q8 + (long long)j * N));
        f.s = __ldg(reinterpret_cast<const float4*>(scales + (long long)gi * N + n));
        f.z = __ldg(reinterpret_cast<const float4*>(zeros + (long long)gi * N + n));
      }
    };
    Fetch<BITS> next;
    fetch(0, next);
    for (int kt = 0; kt < KT; ++kt) {
      const Fetch<BITS> cur = next;
      if (kt + 1 < KT) fetch(kt + 1, next);  // in flight under this tile's stores
      const int s = kt % NS;
      unsigned char* st = gen + s * kStage;
      mbar_wait(empty + 8 * s, ((kt / NS) & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int id = i * NP + pt, r = id / 8, c = id % 8;
        store_split(st, kX, swz(r, c), cur.x[i].x, cur.x[i].y, cur.x[i].z, cur.x[i].w);
      }
      if constexpr (BITS == 4) {
#pragma unroll
        for (int i = 0; i < WI; ++i) {
          const int id = i * NP + pt, n = id % BN, kr = id / BN;
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = __fadd_rn(__fmul_rn((float)((cur.w[i] >> (4 * j)) & 0xFu), cur.s[i]), cur.z[i]);
          store_split(st + 2 * kX, kW, swz(n, 2 * kr), v[0], v[1], v[2], v[3]);
          store_split(st + 2 * kX, kW, swz(n, 2 * kr + 1), v[4], v[5], v[6], v[7]);
        }
      } else {  // column 4 (pt % 16) + e, k 2 (pt / 16) and + 1: half a 16-byte chunk
        const float sv[4] = {cur.s.x, cur.s.y, cur.s.z, cur.s.w};
        const float zv[4] = {cur.z.x, cur.z.y, cur.z.z, cur.z.w};
        const int kp = pt / 16;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t h[2], l[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            dk::sm90::split_tf32(
                __fadd_rn(__fmul_rn((float)((cur.w[j] >> (8 * e)) & 0xFFu), sv[e]), zv[e]),
                h[j], l[j]);
          const uint32_t off = swz(4 * (pt % 16) + e, kp / 2) + 8 * (kp % 2);
          *reinterpret_cast<uint2*>(st + 2 * kX + off) = make_uint2(h[0], h[1]);
          *reinterpret_cast<uint2*>(st + 2 * kX + kW + off) = make_uint2(l[0], l[1]);
        }
      }
      fence_proxy_async();  // the stores, before the wgmmas that read them
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  const int c = wg - 2, warp = (threadIdx.x >> 5) & 3, g = lane >> 2, t = lane & 3;
  float acc[32], tile[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % NS;
    const uint32_t st = base + s * kStage;
    const uint64_t dxh = desc_sw128(st + 64 * c * 128, 16, 1024);
    const uint64_t dxl = desc_sw128(st + kX + 64 * c * 128, 16, 1024);
    const uint64_t dwh = desc_sw128(st + 2 * kX, 16, 1024);
    const uint64_t dwl = desc_sw128(st + 2 * kX + kW, 16, 1024);
    mbar_wait(full + 8 * s, (kt / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t off = (kk * 32) >> 4;  // a k8 step: 32 bytes
      wgmma_ss_tf32_n64(tile, dxl + off, dwh + off, kk > 0);
      wgmma_ss_tf32_n64(tile, dxh + off, dwl + off, 1);
      wgmma_ss_tf32_n64(tile, dxh + off, dwh + off, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tile);
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = __fadd_rn(acc[i], tile[i]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 64 * c + 16 * warp + g + 8 * hh;
    if (row >= M) continue;
    float* yr = y + (long long)row * N + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<float2*>(yr + 8 * j + 2 * t) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

template <int BITS>
int dispatch(const void* x, const void* qw, const void* scales, const void* zeros, void* y,
             int M, int N, int K, int group, long long lda, void* stream) {
  if (M <= 16 || N <= 0 || K <= 0 || N % 64 || K % 64 || group <= 0 || K % group ||
      !(group == 32 || group % 64 == 0) || lda < K || lda % 4)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, qw, scales, zeros, static_cast<const void*>(y)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((M + tf32mm::BM - 1) / tf32mm::BM > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t a = cudaFuncSetAttribute(
      dequant_mm_3xtf32<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tf32mm::kSmem);
  if (a != cudaSuccess) return (int)a;
  dequant_mm_3xtf32<BITS><<<dim3(N / tf32mm::BN, (M + tf32mm::BM - 1) / tf32mm::BM), 512,
                            tf32mm::kSmem, st>>>(
      static_cast<const float*>(x), qw, static_cast<const float*>(scales),
      static_cast<const float*>(zeros), static_cast<float*>(y), M, N, K, group, lda);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernels C and #13 on fp32 x (M, K), rows `lda` elements apart (a multiple
// of 4), at M > 16 (the wrapper sends M <= 16 to dk_int{4,8}_matmul_f32,
// gemv_sm90.cu): q4 int32 words (K / 8, N) or q8 uint8 (K, N), scales and
// zeros fp32 (K / group, N), y fp32 (M, N). K % 64 == 0, N % 64 == 0, group
// 32 or a multiple of 64, every pointer 16-byte aligned.
extern "C" int dk_int4_matmul_sm90_f32(const void* x, const void* q4, const void* scales,
                                       const void* zeros, void* y, int M, int N, int K,
                                       int group, long long lda, void* stream) {
  return dispatch<4>(x, q4, scales, zeros, y, M, N, K, group, lda, stream);
}

extern "C" int dk_int8_matmul_sm90_f32(const void* x, const void* q8, const void* scales,
                                       const void* zeros, void* y, int M, int N, int K,
                                       int group, long long lda, void* stream) {
  return dispatch<8>(x, q8, scales, zeros, y, M, N, K, group, lda, stream);
}
