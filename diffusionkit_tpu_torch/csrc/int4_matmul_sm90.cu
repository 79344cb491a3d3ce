// The weight-only main loop of kernels C (int4_matmul) and #13
// (int8_matmul) for Hopper at M > 16: `int4_mm_sm90<BN>` and
// `int8_mm_sm90<BN>`, one body (`dequant_mm_sm90<BITS, BN>`), TMA-fed,
// warp-specialised bf16 wgmma with the weight dequantised by a producer
// warpgroup. At M <= 16 the split-K GEMV of gemv_sm90.cu runs them
// (ops/int4_matmul.py routes by M).
//
// Replaces, with gemv_sm90.cu, the Pallas kernels
// diffusionkit_tpu/ops/int4_matmul.py:int4_matmul (_kernel, C) and
// int8_matmul (_kernel8, #13): y = x @ W with W = q * s + z in fp32 (a
// product and a sum, each rounded: no FMA), rounded to bf16 once before the
// product; fp32 accumulation, one rounding of y to bf16.
//
// Bound on the H100: bf16 tensor-core work, e.g. C at (4352, 3072, 3072)
// 82 GFLOP, 0.083 ms at 989 TFLOP/s; #13 at SD3's (2048, 1536, 6144) 0.039
// ms. The dequantisation (nibble or byte -> float by the 2^23 trick, the
// product, the sum, the rounding to bf16: about six operations a weight)
// is paid once per block row, so the blocks are 256 rows tall and the
// dequantisation runs beside the products:
//  * One block = a 256 x BN output tile; grid (N / BN, M / 256). BN = 128,
//    or 64 where the 128-wide grid would not fill the SMs once (SD3's 308
//    text rows).
//  * Two rings. Per k tile of 64: the x tile (256 rows of bf16, 128-byte
//    swizzle, rows `lda` apart, so a slice of a wider activation is read in
//    place; rows past M zero-filled) and the dequantised weight tile (BN x
//    64 bf16, K-major), 4 stages; and the packed words (8 x BN) or bytes
//    (64 x BN) with their scale/zero rows (no swizzle), as many stages as
//    the rest of the 227 KB holds (3 or 4).
//  * 3 warpgroups, 384 threads. Producer (setmaxnreg 56): one thread loads
//    the packed ring by TMA; its 128 threads dequantise word rows 0-3 of
//    every tile. Consumers (setmaxnreg 224): each owns 128 rows, loads its
//    half of the x tile by TMA (thread 0, as soon as its own products of
//    that stage are done), runs two m64nBNk16 bf16 SS wgmma per k16 step
//    into fp32 accumulators (2 x BN / 2 a thread), and between issuing tile
//    k's products and waiting for tile k - 1's dequantises its share of
//    tile k + 1 (word rows 4-5 or 6-7). 8 k of one column are one 16-byte
//    st.shared into the swizzled tile (a warp's 32 consecutive columns:
//    conflict-free), then fence.proxy.async and one arrival a warp on the
//    stage's `ready`.
// The fp32 accumulation over K stays within the kernels' tolerance (one
// bf16 ulp + 2K 2^-24 (|x| @ |w|)) at K = 12288 without folding.
//
// OutT is y's type: bf16, or fp32 for a row-parallel linear's partial
// product (ops/common.py), whose ranks' partials are summed in fp32 and
// rounded once after the sum. Only the output store differs: the fp32 form
// stores the accumulators the bf16 form rounds.

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace dk::sm90;

constexpr int BM = 256, BK = 64, NW = BK / 8;  // NW: 8-k word rows a tile
constexpr int kConsumerWarps = 8, kProducerWarps = 4;
// Word rows of each 8-row packed tile the producer warpgroup dequantises;
// the two consumer warpgroups take the rest.
constexpr int kProducerRows = 4;

template <int BITS, int BN>
struct Tile {
  static constexpr uint32_t kA = BM * BK * 2;  // x, bf16
  static constexpr uint32_t kB = BN * BK * 2;  // the dequantised weight, bf16
  static constexpr uint32_t kQ = BITS == 4 ? NW * BN * 4 : BK * BN;  // as loaded
  static constexpr uint32_t kS = 2 * BN * 4;   // scale (then zero) rows: 2 at group 32
  static constexpr uint32_t kRaw = kQ + 2 * kS;
  // Two rings: kStages of (x, w) for the products, kRawStages of the packed
  // weight and its scales for the dequantisation; then the barriers
  // raw_full, raw_free [kRawStages]; a_full[2][kStages], ready, empty
  // [kStages].
  static constexpr int kStages = 4;
  static constexpr uint32_t kMain = kA + kB;
  static constexpr uint32_t kRawBase = kStages * kMain;
  static constexpr int kRawStages =
      (232448 - 2048 - (int)kRawBase) / (int)kRaw < 4 ? (232448 - 2048 - (int)kRawBase) / (int)kRaw
                                                      : 4;
  static constexpr uint32_t kBar = kRawBase + kRawStages * kRaw;
  static constexpr size_t kSmem = kBar + 16 * kRawStages + 32 * kStages + 1024;  // + alignment
  static_assert(kMain % 1024 == 0, "swizzled tiles stay 1024-byte aligned");
  static_assert(kRawStages >= 2 && kSmem <= 232448, "one block an SM");
};

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 128)
    wgmma_ss_n128(d, da, db, scale_d);
  else
    wgmma_ss_n64(d, da, db, scale_d);
}

// q as an exact float, by the 2^23 trick (q < 256).
__device__ __forceinline__ float small_uint_to_float(uint32_t q) {
  return __fsub_rn(__uint_as_float(0x4B000000u | q), 8388608.f);
}

// Dequantise `words` word rows (8 k of one column each) from `kc0` of column
// n of one raw stage (packed words or bytes at `gq`, then the scale and zero
// rows) into the bf16 weight tile at `b`: (n, k = 8 kc) in the 128-byte
// swizzle is 16-byte chunk kc ^ (n % 8), one store a word row.
template <int BITS, int BN>
__device__ __forceinline__ void dequant_rows(uint32_t b, const unsigned char* gq, const float* sc,
                                             const float* zr, int n, int kc0, int words,
                                             int gshift) {
#pragma unroll 2
  for (int kc = kc0; kc < kc0 + words; ++kc) {
    const int gi = kc >> gshift;
    const float sv = sc[gi * BN + n], zv = zr[gi * BN + n];
    float q[8];
    if constexpr (BITS == 4) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(gq)[kc * BN + n];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = small_uint_to_float((w >> (4 * j)) & 0xFu);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = small_uint_to_float(gq[(8 * kc + j) * BN + n]);
    }
    uint32_t pk[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pk[j] = dk::pack_bf16(__fadd_rn(__fmul_rn(q[2 * j], sv), zv),
                            __fadd_rn(__fmul_rn(q[2 * j + 1], sv), zv));
    st_shared_v4(b + n * 128 + ((kc ^ (n & 7)) << 4), make_uint4(pk[0], pk[1], pk[2], pk[3]));
  }
}

template <int BITS, int BN, typename OutT>
__device__ __forceinline__ void dequant_mm_sm90(const CUtensorMap* tx, const CUtensorMap* tq,
                                                const CUtensorMap* ts, const CUtensorMap* tz,
                                                OutT* __restrict__ y, int M, int N, int K,
                                                int group) {
  using T = Tile<BITS, BN>;
  constexpr int NS = T::kStages, RS = T::kRawStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  const unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t raw_full = base + T::kBar, raw_free = raw_full + 8 * RS;
  const uint32_t a_full = raw_free + 8 * RS, ready = a_full + 16 * NS, empty = ready + 8 * NS;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = K / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RS; ++s) {
      mbar_init(raw_full + 8 * s, 1);
      mbar_init(raw_free + 8 * s, kProducerWarps + kConsumerWarps);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_full + 8 * (NS + s), 1);
      mbar_init(ready + 8 * s, kProducerWarps + kConsumerWarps);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Every warp dequantises a share of each tile: the producer warpgroup word
  // rows 0-3 (4 a thread at BN = 128, 2 at 64), consumer warpgroup c rows
  // 4 + 2c and 5 + 2c (2, or 1), lanes on consecutive columns (a warp's
  // 16-byte stores are conflict-free).
  const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int n = tid % BN;
  const int gshift = group == 32 ? 2 : 3;  // word row -> its scale row in the tile
  auto dequant_share = [&](int kt, int kc0, int words) {
    const int s = kt % NS, rs = kt % RS;
    const unsigned char* gq = gbase + T::kRawBase + rs * T::kRaw;
    const float* sc = reinterpret_cast<const float*>(gq + T::kQ);
    mbar_wait(raw_full + 8 * rs, (kt / RS) & 1);
    mbar_wait(empty + 8 * s, ((kt / NS) & 1) ^ 1);  // weight slot s is free
    dequant_rows<BITS, BN>(base + s * T::kMain + T::kA, gq, sc, sc + T::kS / 4, n, kc0, words,
                           gshift);
    fence_proxy_async();  // the stores, before the wgmmas that read them
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(ready + 8 * s);
      mbar_arrive(raw_free + 8 * rs);
    }
  };

  // The warpgroup index, uniform to the compiler (setmaxnreg needs the roles
  // in one if/else that never reconverges).
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // Producer warpgroup: its share of every tile; thread 0 also loads the
    // raw ring.
    setmaxnreg_dec<56>();
    constexpr int PW = kProducerRows * BN / 128;  // word rows a thread
    const int srows = group < BK ? BK / group : 1;
    const uint32_t raw_bytes = T::kQ + 2u * srows * BN * 4;
    auto issue = [&](int j) {  // raw stage j, once its slot's last tile is dequantised
      const int s = j % RS;
      const uint32_t st = base + T::kRawBase + s * T::kRaw, bar = raw_full + 8 * s;
      mbar_wait(raw_free + 8 * s, ((j / RS) & 1) ^ 1);
      mbar_arrive_expect_tx(bar, raw_bytes);
      tma_load_2d(st, tq, bar, n0, j * (BITS == 4 ? NW : BK));
      tma_load_2d(st + T::kQ, ts, bar, n0, (j * BK) / group);
      tma_load_2d(st + T::kQ + T::kS, tz, bar, n0, (j * BK) / group);
    };
    if (threadIdx.x == 0)
      for (int j = 0; j < RS && j < KT; ++j) issue(j);
    for (int kt = 0; kt < KT; ++kt) {
      dequant_share(kt, (tid / BN) * PW, PW);
      if (threadIdx.x == 0 && kt + RS < KT) issue(kt + RS);
    }
  } else {
    // Consumer warpgroup c: rows 128c .. 128c + 127 of the tile, two m64
    // halves; its thread 0 loads those rows of x into the ring. Between
    // issuing tile k's products and waiting for them it dequantises its
    // share of tile k + 1.
    setmaxnreg_inc<224>();
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = tid == 0;
    constexpr int CW = (NW - kProducerRows) * BN / 256;  // word rows a thread
    const int cw0 = kProducerRows + (NW - kProducerRows) / 2 * c + (tid / BN) * CW;
    const uint32_t my_full = a_full + 8 * NS * c;
    auto load_x = [&](int j) {  // slot j % NS is free
      const int s = j % NS;
      mbar_arrive_expect_tx(my_full + 8 * s, T::kA / 2);
      tma_load_2d(base + s * T::kMain + c * (T::kA / 2), tx, my_full + 8 * s, j * BK,
                  m0 + 128 * c);
    };
    if (leader)
      for (int j = 0; j < NS && j < KT; ++j) load_x(j);
    dequant_share(0, cw0, CW);
    float acc[2][BN / 2];
    // Stage 0's descriptors; a stage adds kMain / 16, a k16 step 32 / 16.
    const uint64_t da0 = desc_sw128(base + (128 * c) * 128, 16, 1024);
    const uint64_t da1 = desc_sw128(base + (128 * c + 64) * 128, 16, 1024);
    const uint64_t db = desc_sw128(base + T::kA, 16, 1024);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % NS;
      mbar_wait(my_full + 8 * s, (kt / NS) & 1);  // this half of x landed
      mbar_wait(ready + 8 * s, (kt / NS) & 1);    // the weight dequantised
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t off = (s * T::kMain + kk * 32) >> 4;
        const int sd = kt > 0 || kk > 0;
        wgmma_bf16<BN>(acc[0], da0 + off, db + off, sd);
        wgmma_bf16<BN>(acc[1], da1 + off, db + off, sd);
      }
      wgmma_commit();
      if (kt + 1 < KT) dequant_share(kt + 1, cw0, CW);
      wgmma_wait<1>();  // the previous stage's products have completed
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (kt > 0) {  // release stage kt - 1: the weight slot, and x to the next load
        if (lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % NS));
        if (kt - 1 + NS < KT) {
          named_bar_sync(1 + c, 128);  // the warpgroup's products of kt - 1 are done
          if (leader) load_x(kt - 1 + NS);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + 128 * c + 64 * i + 16 * warp + g + 8 * hh;
        if (row >= M) continue;
        OutT* yr = y + (long long)row * N + n0;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          if constexpr (std::is_same<OutT, float>::value)
            *reinterpret_cast<float2*>(yr + 8 * j + 2 * t) =
                make_float2(acc[i][4 * j + 2 * hh], acc[i][4 * j + 2 * hh + 1]);
          else
            *reinterpret_cast<uint32_t*>(yr + 8 * j + 2 * t) =
                dk::pack_bf16(acc[i][4 * j + 2 * hh], acc[i][4 * j + 2 * hh + 1]);
        }
      }
  }
}

// Kernel C (int4 words) and kernel #13 (uint8 bytes): one body, two names.
template <int BN, typename OutT>
__global__ void __launch_bounds__(384, 1)
    int4_mm_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tz,
                 OutT* __restrict__ y, int M, int N, int K, int group) {
  dequant_mm_sm90<4, BN, OutT>(&tx, &tq, &ts, &tz, y, M, N, K, group);
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(384, 1)
    int8_mm_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tz,
                 OutT* __restrict__ y, int M, int N, int K, int group) {
  dequant_mm_sm90<8, BN, OutT>(&tx, &tq, &ts, &tz, y, M, N, K, group);
}

// A 2-d tensor map of a row-major (rows, cols) array, rows `pitch` elements
// apart: a box of `box_cols` x `box_rows`, 128-byte swizzled or row-major.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* p, int rows,
              int cols, long long pitch, int box_cols, int box_rows, bool swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(pitch * esize)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_tmap(map, type, 2, p, dims, strides, box,
                     swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int BITS, int BN, typename OutT>
int launch(const void* x, const void* qw, const void* scales, const void* zeros, void* y, int M,
           int N, int K, int group, long long lda, cudaStream_t st) {
  using T = Tile<BITS, BN>;
  const int srows = group < BK ? BK / group : 1;
  CUtensorMap tx, tq, ts, tz;
  int e = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, lda, BK, BM / 2, true);
  if (e == 0)
    e = BITS == 4 ? encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qw, K / 8, N, N, BN, NW, false)
                  : encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, qw, K, N, N, BN, BK, false);
  if (e == 0)
    e = encode_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, K / group, N, N, BN, srows,
                  false);
  if (e == 0)
    e = encode_2d(&tz, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zeros, K / group, N, N, BN, srows,
                  false);
  if (e != 0) return e;
  auto kernel = BITS == 4 ? int4_mm_sm90<BN, OutT> : int8_mm_sm90<BN, OutT>;
  const cudaError_t a =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, 384, T::kSmem, st>>>(tx, tq, ts, tz, static_cast<OutT*>(y), M, N, K, group);
  return (int)cudaGetLastError();
}

template <int BITS, typename OutT>
int dispatch(const void* x, const void* qw, const void* scales, const void* zeros, void* y,
             int M, int N, int K, int group, long long lda, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 128 || K % BK || group <= 0 || K % group ||
      !(group == 32 || group % BK == 0) || lda < K || lda % 8 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 128 columns a block where that grid fills the SMs at least once.
  if ((long long)(N / 128) * ((M + BM - 1) / BM) >= sms)
    return launch<BITS, 128, OutT>(x, qw, scales, zeros, y, M, N, K, group, lda, st);
  return launch<BITS, 64, OutT>(x, qw, scales, zeros, y, M, N, K, group, lda, st);
}

}  // namespace

// Kernels C and #13 at any M (the wrappers send M > 16 here): q4 int32
// words (K / 8, N) (nibble j of word r is row 8r + j) or q8 uint8 (K, N),
// scales and zeros fp32 (K / group, N). K % 64 == 0, N % 128 == 0, group
// 32 or a multiple of 64, x rows `lda` elements apart (a multiple of 8),
// every pointer 16-byte aligned. y bf16; the _f32out entries write y in fp32
// (the same products, not rounded).
extern "C" int dk_int4_matmul_sm90_bf16(const void* x, const void* q4, const void* scales,
                                        const void* zeros, void* y, int M, int N, int K,
                                        int group, long long lda, void* stream) {
  return dispatch<4, bf16>(x, q4, scales, zeros, y, M, N, K, group, lda, stream);
}

extern "C" int dk_int8_matmul_sm90_bf16(const void* x, const void* q8, const void* scales,
                                        const void* zeros, void* y, int M, int N, int K,
                                        int group, long long lda, void* stream) {
  return dispatch<8, bf16>(x, q8, scales, zeros, y, M, N, K, group, lda, stream);
}

extern "C" int dk_int4_matmul_sm90_bf16_f32out(const void* x, const void* q4,
                                               const void* scales, const void* zeros, void* y,
                                               int M, int N, int K, int group, long long lda,
                                               void* stream) {
  return dispatch<4, float>(x, q4, scales, zeros, y, M, N, K, group, lda, stream);
}

extern "C" int dk_int8_matmul_sm90_bf16_f32out(const void* x, const void* q8,
                                               const void* scales, const void* zeros, void* y,
                                               int M, int N, int K, int group, long long lda,
                                               void* stream) {
  return dispatch<8, float>(x, q8, scales, zeros, y, M, N, K, group, lda, stream);
}
