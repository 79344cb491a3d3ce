// The int8 main loops of #11 (w8_matmul) and #16 (int8_dot) for Hopper at
// M > 16: at K % 128 == 0 `w8_mm_sm90<OutT, BN>`, TMA-fed, warp-
// specialised int8 wgmma; at K % 128 == 64 `w8_mm_sm90_k64<OutT>` (note
// below). w8_matmul.cu's entry points route here; its note has the
// functions, and the M <= 16 tile stays there.
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
//
// `w8_mm_sm90_k64<OutT>`, at K % 128 == 64: the SD3 x_embedder, (2048, 64,
// 1536) at 512² with CFG. There K = 64 is one 64-deep k stage, so the
// kernel is a load, 2 wgmmas and an epilogue that writes 6.3 MB of bf16
// against 0.4 GOP: bound by that store (1.9 us at 3.35 TB/s). The
// mma.sync tile it replaces stored 4-byte pairs straight from the
// fragments (eight rows a warp instruction, 0.6 TB/s). So:
//  * one block = a 128 x 128 output tile, 256 threads: two warpgroups, each
//    64 rows (a 64 x 128 int32 accumulator, 64 registers a thread), no
//    producer warp; 2 blocks an SM, so one block's stores overlap another's
//    loads and products. (2048, 1536): 192 blocks, all resident at once;
//  * thread 0 loads x8 and w8 by TMA, 64-byte swizzle with a 64-deep box
//    (one box a 64-k stage, rows past M and N zero-filled), a ring of 2
//    stages where K is longer; wgmma m64n128k32 .s32.s8.s8, both operands
//    from shared memory, K-major;
//  * the epilogue's operands (wscale, bias, xscale of the tile's columns
//    and rows) are loaded into shared memory while the tiles are in flight;
//  * the epilogue writes the tile to shared memory (rows padded by 8
//    elements: the fragments' stores are conflict free), and the block
//    stores whole rows from there, 16 bytes a lane, 16 lanes (bf16) a
//    256-byte row segment; the ragged M and N edges are masked there.

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

// w8_mm_sm90_k64 (note above): 128 x 128 tiles of OutT, a warpgroup per 64
// rows, 64-deep k stages.
template <typename OutT>
struct K64Tile {
  static constexpr int BM = 128, BN = 128, BK = 64, kStages = 2, kThreads = 256;
  static constexpr uint32_t kABytes = BM * BK, kBBytes = BN * BK;
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  // Bytes a staged output row: BN values and 8 of padding.
  static constexpr int LD = (BN + 8) * (int)sizeof(OutT);
  // The stages, the output tile, the epilogue's operands (wscale and bias:
  // BN floats each, xscale: BM), then the barriers full[kStages].
  static constexpr uint32_t kOutOffset = kStages * kStageBytes;
  static constexpr uint32_t kEpOffset = kOutOffset + BM * LD;
  static constexpr uint32_t kBarOffset = kEpOffset + (2 * BN + BM) * 4;
  static constexpr size_t kSmem = kBarOffset + 8 * kStages + 1024;  // + alignment
};

template <typename OutT>
__global__ void __launch_bounds__(K64Tile<OutT>::kThreads, 2)
    w8_mm_sm90_k64(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const float* __restrict__ wscale, const float* __restrict__ xscale,
                   const OutT* __restrict__ bias, OutT* __restrict__ y, int M, int N, int K) {
  using T = K64Tile<OutT>;
  constexpr bool kInt32 = std::is_same<OutT, int>::value;
  constexpr int LD = T::LD;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  unsigned char* tile = smem_raw + (base - raw);  // `base` as a generic pointer
  unsigned char* out = tile + T::kOutOffset;
  float* ep = reinterpret_cast<float*>(tile + T::kEpOffset);  // ws, bias, xs
  const uint32_t full = base + T::kBarOffset;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int KT = K / T::BK;
  if (tid == 0) {
    for (int s = 0; s < T::kStages; ++s) mbar_init(full + 8 * s, 1);
    mbar_fence_init();
  }
  // The epilogue's operands (wscale and bias of the tile's columns, xscale
  // of its rows), read while the tiles are in flight.
  constexpr int kEp = 2 * T::BN + T::BM, kEpEach = (kEp + T::kThreads - 1) / T::kThreads;
  float epv[kEpEach];
  if constexpr (!kInt32) {
#pragma unroll
    for (int i = 0; i < kEpEach; ++i) {
      const int at = tid + i * T::kThreads, n = n0 + at % T::BN, row = m0 + at - 2 * T::BN;
      epv[i] = at < T::BN             ? (n < N ? wscale[n] : 0.f)
             : at < 2 * T::BN         ? (bias != nullptr && n < N ? dk::to_float(bias[n]) : 0.f)
             : at < kEp && row < M    ? xscale[row]
                                      : 0.f;
    }
  }
  __syncthreads();
  auto issue = [&](int kt, int s) {
    const uint32_t sa = base + s * T::kStageBytes;
    mbar_arrive_expect_tx(full + 8 * s, T::kStageBytes);
    tma_load_2d(sa, &tx, full + 8 * s, kt * T::BK, m0);
    tma_load_2d(sa + T::kABytes, &tw, full + 8 * s, kt * T::BK, n0);
  };
  if (tid == 0)
    for (int s = 0; s < T::kStages && s < KT; ++s) issue(s, s);
  if constexpr (!kInt32) {
#pragma unroll
    for (int i = 0; i < kEpEach; ++i)
      if (tid + i * T::kThreads < kEp) ep[tid + i * T::kThreads] = epv[i];
  }

  // Warpgroup c: rows 64c .. 64c + 63 of the tile.
  const int c = tid / 128, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int acc[T::BN / 2];
  const uint64_t da = desc_sw64(base + c * 64 * T::BK, 512);
  const uint64_t db = desc_sw64(base + T::kABytes, 512);
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % T::kStages;
    mbar_wait(full + 8 * s, (kt / T::kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::BK / 32; ++kk) {
      const uint32_t off = (s * T::kStageBytes + kk * 32) >> 4;
      wgmma_ss_s8_n128(acc, da + off, db + off, kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if (kt + T::kStages < KT) {
      __syncthreads();  // both warpgroups' products of stage s have completed
      if (tid == 0) issue(kt + T::kStages, s);
    }
  }
  __syncthreads();  // the epilogue's operands are in shared memory

  // The fragments to the staged tile: row 16 warp + g (+ 8), columns 8j + 2t.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 64 * c + 16 * warp + g + 8 * h;
    unsigned char* orow = out + r * LD;
    if constexpr (kInt32) {  // #16: the accumulators as they are
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j)
        *reinterpret_cast<int2*>(orow + 4 * (8 * j + 2 * t)) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    } else {
      const float xs = ep[2 * T::BN + r];
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j) {
        const int col = 8 * j + 2 * t;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + e]), xs), ep[col + e]);
          if (bias) v[e] = __fadd_rn(v[e], ep[T::BN + col + e]);
        }
        dk::store2<OutT>(reinterpret_cast<OutT*>(orow) + col, v[0], v[1]);
      }
    }
  }
  __syncthreads();

  // Whole rows out, 16 bytes a lane (N % 8 == 0: a chunk is in or out).
  constexpr int kChunks = T::BN * (int)sizeof(OutT) / 16, kPer = 16 / (int)sizeof(OutT);
  for (int idx = tid; idx < T::BM * kChunks; idx += T::kThreads) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const int row = m0 + r, col = n0 + ch * kPer;
    if (row < M && col < N)
      *reinterpret_cast<uint4*>(y + (long long)row * N + col) =
          *reinterpret_cast<const uint4*>(out + r * LD + 16 * ch);
  }
}

// The tensor map of an int8 (rows, K) row-major operand: dims (K, rows),
// a box of `box_k` bytes of K (128: 128-byte swizzle; 64: 64-byte) x
// `box_rows` rows.
int encode_int8(CUtensorMap* map, const void* p, int rows, int K, int box_rows,
                int box_k = 128) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)box_k, (cuuint32_t)box_rows};
  return encode_tmap(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p, dims, strides, box,
                     box_k == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
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
int launch_sm90_k64(const void* x8, const void* w8, const void* wscale, const void* xscale,
                    const void* bias, void* y, int M, int N, int K, cudaStream_t st) {
  using T = K64Tile<OutT>;
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  int e = encode_int8(&tx, x8, M, K, T::BM, T::BK);
  if (e == 0) e = encode_int8(&tw, w8, N, K, T::BN, T::BK);
  if (e != 0) return e;
  auto kernel = w8_mm_sm90_k64<OutT>;
  constexpr size_t smem = T::kSmem;
  const cudaError_t a =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  kernel<<<grid, T::kThreads, smem, st>>>(tx, tw, static_cast<const float*>(wscale),
                                          static_cast<const float*>(xscale),
                                          static_cast<const OutT*>(bias), static_cast<OutT*>(y),
                                          M, N, K);
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
  if (K % 128) return launch_sm90_k64<OutT>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
  const long long wide_tiles = (long long)((M + 127) / 128) * ((N + 255) / 256);
  if (wide_tiles >= sms)
    return launch_sm90<OutT, 256>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
  return launch_sm90<OutT, 128>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
}

}  // namespace

// #11 (out_type 0: bf16, 1: fp32) and #16 (2: int32) at M > 16, K % 64
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
