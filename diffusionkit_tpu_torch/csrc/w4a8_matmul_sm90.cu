// Kernel E's main loop for Hopper at M > 16 (and in every mode but plain at
// M <= 16): `w4a8_mm_sm90<MODE, BN>`, TMA-fed, warp-specialised int8 wgmma
// with the packed int4 weight requantised by a producer warpgroup, and the
// four epilogues. Mode plain at M <= 16 (the `ada` GEMVs) runs the split-K
// GEMV of gemv_sm90.cu; ops/w4a8_matmul.py routes by M and mode.
//
// Replaces, with gemv_sm90.cu, the Pallas kernel
// diffusionkit_tpu/ops/w4a8_matmul.py:w4a8_matmul (_kernel,
// _kernel_gelu_quant, _kernel_norm_rope, _kernel_grouped_xs):
// Main loop, shared by all modes:
//   s8 = scales * (1 / wscale), z8 = zeros * (1 / wscale)   (IEEE, in that order)
//   w8 = clip(round_half_even(q * s8 + z8), -127, 127)     (a product and a sum,
//        each rounded: no FMA contraction)
//   acc = x8 @ w8                                           (exact int32)
// Epilogues, every step separately rounded in the reference's order:
//   plain       y = ((float(acc) * xs[m]) * ws[n]) + b[n] -> bf16 or fp32
//   grouped_xs  per 512-wide k group: accf = accf + float(part) * xs[m, kg];
//               y = (accf * ws[n]) + b[n] -> bf16 or fp32 (a 512-term int32 partial
//               is exact: 512 * 127^2 < 2^24)
//   gelu_quant  g = GELU(y) with the Abramowitz-Stegun erf of
//               fused_quant.py:_erf; per (row, 512-column tile)
//               amax = max(max|g|, 1e-8), y8 = clip(rne(g * (127 / amax))),
//               yscale = amax / 127
//   norm_rope   per 128-column head: yn = y * rsqrt(mean(y^2) + eps) * nw,
//               then rotate-half RoPE with the (S, 64) cos/sin tables at row
//               m mod S -> bf16 or fp32
// The bias of plain, gelu_quant and grouped_xs is bf16 or fp32, and the
// output of plain and grouped_xs bf16 or fp32, each by a flag (fp32 in an
// fp32-upcast block: SD3.5-large's block 35, whose fc1 and fc2 run
// gelu_quant and grouped_xs with fp32 out): the reference reads any bias
// as fp32 and writes its output dtype. norm_rope keeps its bf16 bias and
// output (no upcast block has RoPE, and the flags there slowed it on the
// H100).
// The reference's (M, 128) lane-broadcast scale tensors and its
// [cos|cos|-sin|sin] table are TPU layouts and are not carried over.
// Bit for bit in plain and grouped_xs: the same requantisation (common.cuh
// requant_word), exact int32 products in any order, the same epilogue
// chains of rounded steps, grouped_xs's 512-k partials folded in k order.
//
// Bound on the H100: int8 tensor-core work, e.g. fc1 at (4352, 3072,
// 12288) 329 GOP, 0.166 ms at 1,979 TOP/s. The requantisation is paid once
// per block row; at BM = 128 (the mma.sync kernel: about eight ALU
// operations a weight, all threads stopping the products for it) it cost
// twice the products' time. So:
//  * One block = a 256 x BN output tile (BM >= M at the text stream's 256
//    rows: each weight is requantised once there); grid (N / BN, M / 256).
//    BN = 128, or 64 where the 128-wide grid would not fill the SMs once;
//    grouped_xs always 64 (its int32 and fp32 accumulators), norm_rope
//    always 128 (one head).
//  * Requantisation by table: a group's 16 grid values (q = 0..15, by
//    common.cuh's exact float steps) are built once per word run and packed
//    in four registers; a word (8 consecutive k of one column) then takes
//    byte_perm lookups, about 13 operations instead of 70 (common.cuh's
//    `requant_lut` and `lut_word`).
//  * Two rings. Per k tile of 128: the x8 tile (256 rows, 128-byte
//    swizzle, rows past M zero-filled) and the requantised w8 tile (BN x
//    128, K-major, the layout TMA would give the (N, K) grid), 4 stages;
//    and the packed (16 x BN) words with their scale/zero rows (no swizzle),
//    2 stages at BN = 128, 4 at 64. Its 221-188 KB keep one block an SM.
//  * 3 warpgroups, 384 threads. Producer (setmaxnreg 56): one thread loads
//    the packed ring by TMA; its 128 threads requantise word rows 0-7 of
//    every tile. Consumers (setmaxnreg 224): each owns 128 rows, loads its
//    half of the x8 tile by TMA (thread 0, as soon as its own products of
//    that stage are done), runs two m64nBNk32 .s32.s8.s8 SS wgmma per k32
//    step into 2 x BN / 2 int32 accumulators a thread, and between issuing
//    tile k's products and waiting for tile k - 1's requantises its share
//    of tile k + 1 (word rows 8-11 or 12-15). Each word is one 8-byte half
//    of a 16-byte st.shared into the swizzled w8 tile (two word rows a
//    store, lanes on consecutive columns: conflict-free), then
//    fence.proxy.async and one arrival a warp on the stage's `ready`.
// Epilogues on the accumulator fragments (row 16 warp + g and + 8, columns
// 8j + 2t: a row's columns sit in the 4 lanes of a quad, as with mma.sync):
// plain and grouped_xs store bf16 pairs; norm_rope reduces a row's 128
// columns (one head) with two quad shuffles and rotates column c with
// c + 64 in the same thread; grouped_xs waits for its products at each
// 512-k fold (the int32 partial goes into the fp32 sum, the next wgmma
// starts a fresh partial with scale_d = 0). gelu_quant's GELU was half its
// time on the consumers' 8 warps: the accumulators go to shared memory
// and all 12 warps run it (`gelu_quant_epilogue`); its 512-column absmax
// spans 512 / BN blocks of one thread-block cluster along N, which
// exchange per-row partial maxima through distributed shared memory.

#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using namespace dk::sm90;

constexpr int BM = 256, BK = 128, QROWS = BK / 8;
constexpr int SCALE_TILE = 512, HEAD = 128;
constexpr int kConsumerWarps = 8, kProducerWarps = 4;
constexpr int kEpilogueBar = 3;  // named barrier of all 384 threads (1, 2: the consumers')
// Word rows of each 16-row packed tile the producer warpgroup requantises;
// the two consumer warpgroups take the rest (an even count a thread).
constexpr int kProducerRows = 8;

enum Mode { PLAIN = 0, GELU_QUANT = 1, GROUPED_XS = 2, NORM_ROPE = 3 };

struct Params {
  const float* wscale;
  const float* xscale;  // (M,) or, for grouped_xs, (M, K / 512)
  const void* bias;     // (N,) bf16, or fp32 with bias_f32, or null
  const bf16* norm_w;   // (128,) norm_rope only
  const float* cos;     // (S, 64) norm_rope only
  const float* sin;
  void* y;              // bf16 (M, N), fp32 with out_f32, or int8 (M, N) for gelu_quant
  float* yscale;        // gelu_quant: (M, N / 512)
  int S, M, N, K, group;
  int bias_f32, out_f32;
  float eps;
};

template <int BN>
struct Tile {
  static constexpr uint32_t kA = BM * BK;         // x8, one byte an element
  static constexpr uint32_t kB = BN * BK;         // the requantised w8 tile
  static constexpr uint32_t kQ = QROWS * BN * 4;  // packed words as loaded
  static constexpr uint32_t kS = 4 * BN * 4;      // scale (then zero) rows: 4 at group 32
  static constexpr uint32_t kRaw = kQ + 2 * kS;
  // Two rings: kStages of (x8, w8) for the products, kRawStages of the
  // packed words and their scales for the requantisation; then the
  // barriers, then gelu_quant's per-row partial maxima.
  static constexpr int kStages = 4;
  static constexpr int kRawStages = BN == 128 ? 2 : 4;
  static constexpr uint32_t kMain = kA + kB;
  static constexpr uint32_t kRawBase = kStages * kMain;
  static constexpr uint32_t kBar = kRawBase + kRawStages * kRaw;
  // raw_full, raw_free [kRawStages]; a_full[2][kStages], ready, empty [kStages]
  static constexpr uint32_t kRed = kBar + 16 * kRawStages + 32 * kStages;
  static constexpr size_t kSmem = kRed + 4 * BM + 1024;  // + alignment
  static_assert(kMain % 1024 == 0, "swizzled tiles stay 1024-byte aligned");
  static_assert(kSmem <= 232448, "one block an SM");
};

template <int BN>
constexpr int kCluster = SCALE_TILE / BN;  // gelu_quant: blocks of one scale tile

template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (BN == 128)
    wgmma_ss_s8_n128(d, da, db, scale_d);
  else
    wgmma_ss_s8_n64(d, da, db, scale_d);
}

// y = ((float(acc) * xs) * ws) + b, each step rounded (plain's epilogue).
__device__ __forceinline__ float affine(int acc, float xs, float ws, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), b);
}

// norm_rope's bias, bf16 only (a flag per element slowed it on the H100).
__device__ __forceinline__ float bias_bf16(const Params& p, int col) {
  return p.bias ? __bfloat162float(static_cast<const bf16*>(p.bias)[col]) : 0.f;
}

__device__ __forceinline__ float bias_at(const Params& p, int col) {
  if (!p.bias) return 0.f;
  return p.bias_f32 ? static_cast<const float*>(p.bias)[col]
                    : __bfloat162float(static_cast<const bf16*>(p.bias)[col]);
}

// Two adjacent outputs of row `row` at column `col`: a bf16 pair, or with
// out_f32 a float2.
__device__ __forceinline__ void store_pair(const Params& p, int row, int col, float v0,
                                           float v1) {
  const long long at = (long long)row * p.N + col;
  if (p.out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(p.y) + at) = make_float2(v0, v1);
  else
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.y) + at) = dk::pack_bf16(v0, v1);
}

// Requantise `words` consecutive word rows from `wr0` (even) of column n of
// one raw stage (words, then scale and zero rows at `sc` / `zr`) into the
// w8 tile at `b`: (n, k = 8 wr) in the 128-byte swizzle is 16-byte chunk
// wr / 2 ^ (n % 8), two word rows a 16-byte store. A group's 16 grid values
// are built when its scale row changes (`gshift`: word row -> scale row).
template <int BN>
__device__ __forceinline__ void requant_rows(uint32_t b, const uint32_t* q, const float* sc,
                                             const float* zr, int n, float rw, int wr0,
                                             int words, int gshift) {
  uint4 lut;
  int gi_built = -1;
#pragma unroll 2
  for (int wr = wr0; wr < wr0 + words; wr += 2) {
    const int gi = wr >> gshift;
    if (gi != gi_built) {
      lut = dk::requant_lut(__fmul_rn(sc[gi * BN + n], rw), __fmul_rn(zr[gi * BN + n], rw));
      gi_built = gi;
    }
    const uint2 lo = dk::lut_word(lut, q[wr * BN + n]);
    const uint2 hi = dk::lut_word(lut, q[(wr + 1) * BN + n]);
    st_shared_v4(b + n * BK + (((wr >> 1) ^ (n & 7)) << 4), make_uint4(lo.x, lo.y, hi.x, hi.y));
  }
}

// gelu_quant's epilogue, run by all 384 threads on the int32 tile the
// consumers left in shared memory (`ep`, BN + 4 values a row): each thread
// takes 8 columns of every 384 / (BN / 8)-th row, y = ((acc * xs) * ws) +
// b, GELU, the row's partial absmax over the half-warp or quarter-warp that
// holds it, then, after the cluster's blocks (one 512-column scale tile)
// exchanged those through distributed shared memory, the int8 values,
// 8 bytes a store, and the scale.
template <int BN>
__device__ __forceinline__ void gelu_quant_epilogue(float* ep, float* red, const Params& p,
                                                    int m0, int n0) {
  constexpr int CPR = BN / 8, RPP = 384 / CPR, CL = kCluster<BN>, PITCH = BN + 4;
  const int cc = threadIdx.x % CPR, r0 = threadIdx.x / CPR, col0 = n0 + 8 * cc;
  float ws[8], b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    ws[e] = p.wscale[col0 + e];
    b[e] = bias_at(p, col0 + e);
  }
  for (int rr = r0; rr < BM; rr += RPP) {
    const int row = m0 + rr;
    const float xs = row < p.M ? p.xscale[row] : 0.f;
    float4* v = reinterpret_cast<float4*>(ep + rr * PITCH + 8 * cc);
    const float4 lo = v[0], hi = v[1];
    const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    float gv[8], mx = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gv[e] = dk::gelu_as(affine(__float_as_int(a[e]), xs, ws[e], b[e]));
      mx = fmaxf(mx, fabsf(gv[e]));
    }
    v[0] = make_float4(gv[0], gv[1], gv[2], gv[3]);
    v[1] = make_float4(gv[4], gv[5], gv[6], gv[7]);
#pragma unroll
    for (int o = 1; o < CPR; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (cc == 0) red[rr] = mx;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials are written
  int8_t* y8 = static_cast<int8_t*>(p.y);
  for (int rr = r0; rr < BM; rr += RPP) {
    const int row = m0 + rr;
    float amax = 0.f;
#pragma unroll
    for (int r = 0; r < CL; ++r) amax = fmaxf(amax, cluster.map_shared_rank(red, r)[rr]);
    amax = fmaxf(amax, 1e-8f);
    if (row >= p.M) continue;
    const float r127 = __fdiv_rn(127.f, amax);
    const float4* v = reinterpret_cast<const float4*>(ep + rr * PITCH + 8 * cc);
    const float4 lo = v[0], hi = v[1];
    const float gv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) q[e] = dk::round_clip_i8(__fmul_rn(gv[e], r127));
    *reinterpret_cast<uint2*>(y8 + (long long)row * p.N + col0) =
        make_uint2(dk::pack_i8x4(q[0], q[1], q[2], q[3]), dk::pack_i8x4(q[4], q[5], q[6], q[7]));
    if (cluster.block_rank() == 0 && cc == 0)
      p.yscale[(long long)row * (p.N / SCALE_TILE) + blockIdx.x / CL] = __fdiv_rn(amax, 127.f);
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

template <int MODE, int BN>
__global__ void __launch_bounds__(384, 1)
    w4a8_mm_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap ts, const __grid_constant__ CUtensorMap tz,
                 const Params p) {
  using T = Tile<BN>;
  constexpr int NS = T::kStages, RS = T::kRawStages;
  static_assert(MODE != NORM_ROPE || BN == HEAD, "a block spans one head");
  static_assert(MODE != GROUPED_XS || BN == 64, "two accumulators a thread");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t raw_full = base + T::kBar, raw_free = raw_full + 8 * RS;
  const uint32_t a_full = raw_free + 8 * RS, ready = a_full + 16 * NS, empty = ready + 8 * NS;
  float* const red = reinterpret_cast<float*>(gbase + T::kRed);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, K = p.K, group = p.group;
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

  // Every warp requantises a share of each tile: the producer warpgroup
  // word rows 0-7 (8 a thread at BN = 128, 4 at 64), consumer warpgroup c
  // rows 8 + 4c .. 11 + 4c (4, or 2), lanes on consecutive columns, so a
  // quarter-warp's 16-byte stores land in 8 distinct chunks of the swizzle.
  const int tid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int n = tid % BN;
  const float rw = __fdiv_rn(1.f, p.wscale[n0 + n]);
  // Word row -> its scale row in the tile: group 32 (4 words), 64 (8),
  // or one row for a group of 128 or more.
  const int gshift = group == 32 ? 2 : group == 64 ? 3 : 4;
  auto requant_share = [&](int kt, int wr0, int words) {
    const int s = kt % NS, rs = kt % RS;
    const uint32_t* q = reinterpret_cast<const uint32_t*>(gbase + T::kRawBase + rs * T::kRaw);
    const float* sc = reinterpret_cast<const float*>(q) + T::kQ / 4;
    mbar_wait(raw_full + 8 * rs, (kt / RS) & 1);
    mbar_wait(empty + 8 * s, ((kt / NS) & 1) ^ 1);  // w8 slot s is free
    requant_rows<BN>(base + s * T::kMain + T::kA, q, sc, sc + T::kS / 4, n, rw, wr0, words,
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
    // Raw stage j's loads (its slot's previous tile is requantised).
    auto issue = [&](int j) {
      const int s = j % RS;
      const uint32_t st = base + T::kRawBase + s * T::kRaw, bar = raw_full + 8 * s;
      mbar_wait(raw_free + 8 * s, ((j / RS) & 1) ^ 1);
      mbar_arrive_expect_tx(bar, raw_bytes);
      tma_load_2d(st, &tq, bar, n0, j * QROWS);
      tma_load_2d(st + T::kQ, &ts, bar, n0, (j * BK) / group);
      tma_load_2d(st + T::kQ + T::kS, &tz, bar, n0, (j * BK) / group);
    };
    if (threadIdx.x == 0)
      for (int j = 0; j < RS && j < KT; ++j) issue(j);
    for (int kt = 0; kt < KT; ++kt) {
      requant_share(kt, (tid / BN) * PW, PW);
      if (threadIdx.x == 0 && kt + RS < KT) issue(kt + RS);
    }
    if constexpr (MODE == GELU_QUANT) {
      named_bar_sync(kEpilogueBar, 384);  // the ring is drained
      setmaxnreg_inc<160>();  // what the consumers give back below
      named_bar_sync(kEpilogueBar, 384);  // their accumulators are in shared memory
      gelu_quant_epilogue<BN>(reinterpret_cast<float*>(gbase), red, p, m0, n0);
    }
  } else {
    // Consumer warpgroup c: rows 128c .. 128c + 127 of the tile, two m64
    // halves; its thread 0 loads those rows of x8 into the ring. Between
    // issuing tile k's products and waiting for them it requantises its
    // share of tile k + 1.
    setmaxnreg_inc<224>();
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const bool leader = tid == 0;
    constexpr int CW = (QROWS - kProducerRows) * BN / 256;  // word rows a thread
    const int cw0 = kProducerRows + (QROWS - kProducerRows) / 2 * c + (tid / BN) * CW;
    const uint32_t my_full = a_full + 8 * NS * c;
    auto load_x = [&](int j) {  // slot j % NS is free
      const int s = j % NS;
      mbar_arrive_expect_tx(my_full + 8 * s, T::kA / 2);
      tma_load_2d(base + s * T::kMain + c * (T::kA / 2), &tx, my_full + 8 * s, j * BK,
                  m0 + 128 * c);
    };
    if (leader)
      for (int j = 0; j < NS && j < KT; ++j) load_x(j);
    requant_share(0, cw0, CW);
    constexpr int NA = BN / 2;
    int acc[2][NA];
    constexpr int FA = MODE == GROUPED_XS ? NA : 1;
    float accf[2][FA];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < FA; ++j) accf[i][j] = 0.f;
    constexpr int PER = SCALE_TILE / BK;  // grouped_xs: k tiles a fold
    // Stage 0's descriptors; a stage adds kMain / 16, a k32 step 32 / 16.
    const uint64_t da0 = desc_sw128(base + (128 * c) * BK, 16, 1024);
    const uint64_t da1 = desc_sw128(base + (128 * c + 64) * BK, 16, 1024);
    const uint64_t db = desc_sw128(base + T::kA, 16, 1024);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % NS;
      mbar_wait(my_full + 8 * s, (kt / NS) & 1);  // this half of x8 landed
      mbar_wait(ready + 8 * s, (kt / NS) & 1);    // w8 requantised
      wgmma_fence();
      const bool fresh = MODE == GROUPED_XS ? kt % PER == 0 : kt == 0;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint32_t off = (s * T::kMain + kk * 32) >> 4;
        const int sd = !fresh || kk > 0;
        wgmma_s8<BN>(acc[0], da0 + off, db + off, sd);
        wgmma_s8<BN>(acc[1], da1 + off, db + off, sd);
      }
      wgmma_commit();
      if (kt + 1 < KT) requant_share(kt + 1, cw0, CW);
      if (MODE == GROUPED_XS && (kt + 1) % PER == 0) {
        // Fold this 512-wide k group's exact partial into the fp32 sum.
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        const int kg = kt / PER, KG = K / SCALE_TILE;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = m0 + 128 * c + 64 * i + 16 * warp + g + 8 * hh;
            const float xs = row < M ? p.xscale[(long long)row * KG + kg] : 0.f;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int a = 4 * j + 2 * hh + e;
                accf[i][a % FA] =
                    __fadd_rn(accf[i][a % FA], __fmul_rn(__int2float_rn(acc[i][a]), xs));
              }
          }
      } else {
        wgmma_wait<1>();  // the previous stage's products have completed
        fence_regs(acc[0]);
        fence_regs(acc[1]);
      }
      if (kt > 0) {  // release stage kt - 1: w8 to the requantisers, x8 to the next load
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

    if constexpr (MODE == PLAIN || MODE == GROUPED_XS) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + 128 * c + 64 * i + 16 * warp + g + 8 * hh;
          if (row >= M) continue;
          const float xs = MODE == PLAIN ? p.xscale[row] : 0.f;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * t;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int a = 4 * j + 2 * hh + e;
              if constexpr (MODE == PLAIN)
                v[e] = affine(acc[i][a], xs, p.wscale[col + e], bias_at(p, col + e));
              else
                v[e] = __fadd_rn(__fmul_rn(accf[i][a % FA], p.wscale[col + e]),
                                 bias_at(p, col + e));
            }
            store_pair(p, row, col, v[0], v[1]);
          }
        }
    }

    if constexpr (MODE == NORM_ROPE) {  // bf16 out only (no fp32-upcast block has RoPE)
      bf16* y = static_cast<bf16*>(p.y);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + 128 * c + 64 * i + 16 * warp + g + 8 * hh;
          const bool live = row < M;
          const float xs = live ? p.xscale[row] : 0.f;
          // The row's fp32 values in place of its accumulators.
          float ss = 0.f;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int& a = acc[i][4 * j + 2 * hh + e];
              const int col = n0 + 8 * j + 2 * t + e;
              const float v = affine(a, xs, p.wscale[col], bias_bf16(p, col));
              ss += v * v;
              a = __float_as_int(v);
            }
          // The head's 128 columns sit in the 4 lanes of this row (t = 0..3).
          ss += __shfl_xor_sync(0xffffffffu, ss, 1);
          ss += __shfl_xor_sync(0xffffffffu, ss, 2);
          const float inv = __frsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)HEAD), p.eps));
          if (!live) continue;
          const long long cs = (long long)(row % p.S) * (HEAD / 2);
          bf16* out = y + (long long)row * N + n0;
#pragma unroll
          for (int j = 0; j < BN / 16; ++j) {
            float lo[2], hi[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cl = 8 * j + 2 * t + e;  // x1 at cl, x2 at cl + 64
              const float x1 = __fmul_rn(__fmul_rn(__int_as_float(acc[i][4 * j + 2 * hh + e]), inv),
                                         __bfloat162float(p.norm_w[cl]));
              const float x2 = __fmul_rn(
                  __fmul_rn(__int_as_float(acc[i][4 * (j + BN / 16) + 2 * hh + e]), inv),
                  __bfloat162float(p.norm_w[cl + HEAD / 2]));
              const float cv = p.cos[cs + cl], sv = p.sin[cs + cl];
              lo[e] = __fsub_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
              hi[e] = __fadd_rn(__fmul_rn(x2, cv), __fmul_rn(x1, sv));
            }
            const int j0 = 8 * j + 2 * t;
            *reinterpret_cast<uint32_t*>(out + j0) = dk::pack_bf16(lo[0], lo[1]);
            *reinterpret_cast<uint32_t*>(out + HEAD / 2 + j0) = dk::pack_bf16(hi[0], hi[1]);
          }
        }
    }

    if constexpr (MODE == GELU_QUANT) {
      // The tile goes through shared memory so that all 12 warps share the
      // GELU (the accumulators' registers then go back to the producers).
      constexpr int PITCH = BN + 4;  // ints a row: conflict-free fragment stores
      int* ep = reinterpret_cast<int*>(gbase);
      named_bar_sync(kEpilogueBar, 384);  // the ring is drained
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = 128 * c + 64 * i + 16 * warp + g + 8 * hh;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<int2*>(ep + rl * PITCH + 8 * j + 2 * t) =
                make_int2(acc[i][4 * j + 2 * hh], acc[i][4 * j + 2 * hh + 1]);
        }
      setmaxnreg_dec<160>();
      named_bar_sync(kEpilogueBar, 384);
      gelu_quant_epilogue<BN>(reinterpret_cast<float*>(gbase), red, p, m0, n0);
    }
  }
}

// A 2-d tensor map of a row-major (rows, cols) array of `type`, `esize`
// bytes an element, rows `pitch` elements apart: a box of `box_cols` x
// `box_rows`, 128-byte swizzled or landing row-major.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* p, int rows,
              int cols, long long pitch, int box_cols, int box_rows, bool swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(pitch * esize)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return encode_tmap(map, type, 2, p, dims, strides, box,
                     swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int MODE, int BN>
int launch(const void* x8, const void* q4, const void* scales, const void* zeros, long long lda,
           const Params& p, cudaStream_t st) {
  using T = Tile<BN>;
  const int srows = p.group < BK ? BK / p.group : 1;
  CUtensorMap tx, tq, ts, tz;
  int e = encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x8, p.M, p.K, lda, BK, BM / 2, true);
  if (e == 0)
    e = encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, q4, p.K / 8, p.N, p.N, BN, QROWS, false);
  if (e == 0)
    e = encode_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, p.K / p.group, p.N, p.N, BN,
                  srows, false);
  if (e == 0)
    e = encode_2d(&tz, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, zeros, p.K / p.group, p.N, p.N, BN,
                  srows, false);
  if (e != 0) return e;
  auto kernel = w4a8_mm_sm90<MODE, BN>;
  const cudaError_t a =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (a != cudaSuccess) return (int)a;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.N / BN, (p.M + BM - 1) / BM);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if constexpr (MODE == GELU_QUANT) {  // kCluster blocks along N share one scale tile
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster<BN>;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  const cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, tx, tq, ts, tz, p);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

}  // namespace

// Kernel E at any M (the wrapper sends every call but mode plain at M <= 16
// here). K % 128 == 0; N % 128 (N % 512 for
// gelu_quant); group 32, 64 or a multiple of 128; x8 rows `lda` bytes apart
// (a multiple of 16), every pointer 16-byte aligned; the bias bf16, or fp32
// with bias_f32 (not for norm_rope); y bf16, or fp32 with out_f32 (plain and
// grouped_xs).
extern "C" int dk_w4a8_matmul_sm90(const void* x8, const void* q4, const void* scales,
                                   const void* zeros, const void* wscale, const void* xscale,
                                   const void* bias, int bias_f32, const void* norm_w,
                                   const void* cos, const void* sin, int S, void* y,
                                   int out_f32, void* yscale, int mode, int M, int N, int K,
                                   int group, long long lda, float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || N % 128 || group <= 0 || K % group ||
      !(group == 32 || group == 64 || group % BK == 0) || lda < K || lda % 16 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  if (mode == GROUPED_XS && K % SCALE_TILE) return (int)cudaErrorInvalidValue;
  if (mode == GELU_QUANT && (N % SCALE_TILE || !yscale)) return (int)cudaErrorInvalidValue;
  if (mode == NORM_ROPE && (S <= 0 || !norm_w || !cos || !sin)) return (int)cudaErrorInvalidValue;
  if ((mode == GELU_QUANT || mode == NORM_ROPE) && out_f32) return (int)cudaErrorInvalidValue;
  if (mode == NORM_ROPE && bias_f32) return (int)cudaErrorInvalidValue;
  Params p;
  p.wscale = static_cast<const float*>(wscale);
  p.xscale = static_cast<const float*>(xscale);
  p.bias = bias;
  p.bias_f32 = bias_f32 != 0;
  p.out_f32 = out_f32 != 0;
  p.norm_w = static_cast<const bf16*>(norm_w);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.y = y;
  p.yscale = static_cast<float*>(yscale);
  p.S = S;
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = group;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 128 columns a block where that grid fills the SMs at least once.
  const bool wide = (long long)(N / 128) * ((M + BM - 1) / BM) >= sm_count();
  switch (mode) {
    case PLAIN:
      return wide ? launch<PLAIN, 128>(x8, q4, scales, zeros, lda, p, st)
                  : launch<PLAIN, 64>(x8, q4, scales, zeros, lda, p, st);
    case GELU_QUANT:
      return wide ? launch<GELU_QUANT, 128>(x8, q4, scales, zeros, lda, p, st)
                  : launch<GELU_QUANT, 64>(x8, q4, scales, zeros, lda, p, st);
    case GROUPED_XS:
      return launch<GROUPED_XS, 64>(x8, q4, scales, zeros, lda, p, st);
    case NORM_ROPE:
      return launch<NORM_ROPE, 128>(x8, q4, scales, zeros, lda, p, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
