// The int8 main loop of #11 (w8_matmul) and #16 (int8_dot) for Hopper at
// M > 16 and K % 128 == 0: `w8_mm_sm90<OutT, BN>`, TMA-fed, warp-
// specialised int8 wgmma. w8_matmul.cu's entry points route here; its note
// has the functions, and the M <= 16 and K % 128 != 0 tiles stay there.
//
// Replaces, with w8_matmul.cu, the Pallas kernels
// diffusionkit_tpu/ops/w4a8_matmul.py:w8_matmul (_kernel_w8, #11) and
// tools/microbench_pallas_int8.py:pallas_int8_matmul (#16): y = x8 @ w8^T
// in exact int32, then #11's epilogue __fmul_rn(__fmul_rn(float(acc), xs),
// ws), __fadd_rn(., bias), rounded once to bf16 or fp32, or #16's int32
// store. Both are bit-identical to the `mma.sync` main loop they replace:
// the int32 sums are exact in any order, and the epilogue is the same
// chain of correctly rounded steps.
//
// Bound on the H100: int8 tensor-core work at every shape routed here,
// e.g. #16 at (4352, 3072, 12288) 329 GOP, 0.166 ms at 1,979 TOP/s,
// against 214 MB of int32 written (0.064 ms); #11 at SD3's (2048, 1536,
// 6144) 38.7 GOP, 0.0195 ms. The int32 accumulators never leave registers
// before the epilogue. The design keeps the int8 tensor cores fed from
// shared memory without a thread spending an instruction on a copy:
//  * One block = a 128 x BN output tile; grid (N / BN, M / 128), both
//    rounded up. BN = 256 where that grid fills the card's SMs at least
//    once, else 128 (twice the blocks: SD3's 308 text rows, T5's 256
//    tokens).
//  * 3 warpgroups, 384 threads. Warpgroup 0 is the producer: setmaxnreg
//    lowers it to 24 registers and one thread issues the TMA loads. The two
//    consumers raise theirs to 240 and each owns 64 rows of the tile: a
//    64 x BN int32 accumulator, 128 registers a thread at BN = 256.
//  * TMA: one 2-d tensor map each for x8 (K, M) and w8 (K, N), innermost
//    first; 128-byte swizzle with a box 128 bytes deep, so one box is one
//    128-deep k step of int8; rows past M and N are zero-filled (no padded
//    copies) and masked at the store. A ring of stages (4 of 16 + 32 KB at
//    BN = 256, 6 of 16 + 16 KB at BN = 128: 192 KB either way, one block
//    an SM) on a full barrier (the TMA bytes) and an empty one (the
//    consumers' 8 warps) a stage.
//  * Products: wgmma m64nBNk32 .s32.s8.s8, both operands from shared
//    memory, K-major (x8 is (M, K) and w8 is (N, K): no transpose), four a
//    stage. Each consumer keeps one stage's products in flight while it
//    waits for the next stage, and releases a stage once the products that
//    read it have completed.
//  * Epilogues on the accumulator fragments (row 16 warp + g and + 8,
//    columns 8j + 2t): #16 stores int2 pairs; #11 runs the exact
//    __fmul_rn / __fadd_rn chain and stores bf16 or fp32 pairs.
// No TMA store and no persistent grid: each block's epilogue is exposed.

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace dk::sm90;

constexpr int kConsumerWarps = 8;

template <int BN>
struct Int8Tile {
  static constexpr int BM = 128, BK = 128, kStages = BN == 256 ? 4 : 6;
  static constexpr uint32_t kABytes = BM * BK, kBBytes = BN * BK;  // one byte an element
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  // The stages (A then B), then the barriers: full[kStages], empty[kStages].
  static constexpr uint32_t kBarOffset = kStages * kStageBytes;
  static constexpr size_t kSmem = kBarOffset + 16 * kStages + 1024;  // + alignment
  static_assert(kSmem > 232448 / 2 && kSmem <= 232448, "one block an SM");
};

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 256)
    wgmma_ss_s8_n256(d, da, db, scale_d);
  else
    wgmma_ss_s8_n128(d, da, db, scale_d);
}

// OutT int: #16, the int32 product; bf16 or float: #11 with its epilogue
// (`bias` may be null).
template <typename OutT, int BN>
__global__ void __launch_bounds__(384, 1)
    w8_mm_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
               const float* __restrict__ wscale, const float* __restrict__ xscale,
               const OutT* __restrict__ bias, OutT* __restrict__ y, int M, int N, int K) {
  using T = Int8Tile<BN>;
  constexpr int NS = T::kStages;
  constexpr bool kInt32 = std::is_same<OutT, int>::value;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atoms' alignment
  const uint32_t full = base + T::kBarOffset, empty = full + 8 * NS;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * BN;
  const int KT = K / T::BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, uniform to the compiler (setmaxnreg needs the roles
  // in one if/else that never reconverges).
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // Producer warpgroup: one thread keeps the ring full.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % NS;
        const uint32_t sa = base + s * T::kStageBytes;
        mbar_wait(empty + 8 * s, ((kt / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(full + 8 * s, T::kStageBytes);
        tma_load_2d(sa, &tx, full + 8 * s, kt * T::BK, m0);
        tma_load_2d(sa + T::kABytes, &tw, full + 8 * s, kt * T::BK, n0);
      }
    }
  } else {
    // Consumer warpgroup c: rows 64c .. 64c + 63 of the tile.
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    int acc[BN / 2];
    // Stage 0's descriptors (this consumer's 64 rows of A, all BN rows of
    // B); a stage adds kStageBytes / 16, a k32 step 32 / 16.
    const uint64_t da = desc_sw128(base + c * 64 * T::BK, 16, 1024);
    const uint64_t db = desc_sw128(base + T::kABytes, 16, 1024);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % NS;
      mbar_wait(full + 8 * s, (kt / NS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::BK / 32; ++kk) {
        const uint32_t off = (s * T::kStageBytes + kk * 32) >> 4;
        wgmma_s8<BN>(acc, da + off, db + off, kt > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products have completed
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % NS));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int row0 = m0 + 64 * c + 16 * warp + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      OutT* yr = y + (long long)row * N;
      if constexpr (kInt32) {  // #16: the accumulators as they are
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;  // N % 8 == 0: col + 1 < N too
          if (col < N)
            *reinterpret_cast<int2*>(yr + col) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      } else {
        const float xs = xscale[row];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t;  // N % 8 == 0: col + 1 < N too
          if (col >= N) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), xs),
                             wscale[col + e]);
            if (bias) v[e] = __fadd_rn(v[e], dk::to_float(bias[col + e]));
          }
          dk::store2<OutT>(yr + col, v[0], v[1]);
        }
      }
    }
  }
}

// The tensor map of an int8 (rows, K) row-major operand: dims (K, rows),
// a box of 128 bytes of K x `box_rows` rows.
int encode_int8(CUtensorMap* map, const void* p, int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  return encode_tmap(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p, dims, strides, box);
}

template <typename OutT, int BN>
int launch_sm90(const void* x8, const void* w8, const void* wscale, const void* xscale,
                const void* bias, void* y, int M, int N, int K, cudaStream_t st) {
  using T = Int8Tile<BN>;
  const dim3 grid((N + BN - 1) / BN, (M + T::BM - 1) / T::BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  int e = encode_int8(&tx, x8, M, K, T::BM);
  if (e == 0) e = encode_int8(&tw, w8, N, K, BN);
  if (e != 0) return e;
  auto kernel = w8_mm_sm90<OutT, BN>;
  const cudaError_t a =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<grid, 384, T::kSmem, st>>>(tx, tw, static_cast<const float*>(wscale),
                                      static_cast<const float*>(xscale),
                                      static_cast<const OutT*>(bias), static_cast<OutT*>(y), M,
                                      N, K);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch_sm90(const void* x8, const void* w8, const void* wscale, const void* xscale,
                  const void* bias, void* y, int M, int N, int K, cudaStream_t st) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long wide_tiles = (long long)((M + 127) / 128) * ((N + 255) / 256);
  if (wide_tiles >= sms)
    return launch_sm90<OutT, 256>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
  return launch_sm90<OutT, 128>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
}

}  // namespace

// #11 (out_type 0: bf16, 1: fp32) and #16 (2: int32) at M > 16, K % 128
// == 0, N % 8 == 0, every pointer 16-byte aligned. Called by
// w8_matmul.cu's dispatch.
int dk_w8_mm_sm90(int out_type, const void* x8, const void* w8, const void* wscale,
                  const void* xscale, const void* bias, void* y, int M, int N, int K,
                  cudaStream_t st) {
  switch (out_type) {
    case 0:
      return dispatch_sm90<bf16>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
    case 1:
      return dispatch_sm90<float>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
    case 2:
      return dispatch_sm90<int>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
