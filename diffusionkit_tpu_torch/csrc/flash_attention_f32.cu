// Non-causal flash attention over fp32 q/k/v read in place through strides:
// the fp32 instantiations of kernel B and kernels #14 and #15.
//
// Replaces the fp32 path of the Pallas kernels of
// diffusionkit_tpu/ops/flash_attention.py, which take fp32 inputs in all
// three functions (their tiles sized by byte width, pick_flash_blocks):
//  * kernel B, flash_attention_bshd: the row max kept UNSCALED and the scale
//    folded into the exponent, exp((s - m) * scale);
//  * #15, flash_attention: the scale applied to the scores before the max;
//  * #14, flash_attention_stats: #15 against a key chunk with `vlen` valid
//    leading keys, o normalised by max(l, 1e-30), and the row statistics m
//    (of the scaled scores) and l, all fp32.
// What the reference computes in fp32, and so these kernels: fp32 scores,
// an fp32 online softmax (exp2 of the scaled difference, the accurate
// exp2f), P NOT rounded (v is fp32), fp32 P.V, one fp32 division by l.
// Callers: the VAE mid-block of DiffusionPipeline(a16=False) (one head of
// d=512 over 4096 positions at 512^2), fp32 MMDiTs (SD3: 24 heads of 64
// over 1178 tokens; FLUX: 24 of 128 over 4352), SD3.5-large's fp32 block.
//
// 3xTF32 (every head dim): both products on the tensor cores. Each operand
// x is split into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a
// product sums lo.hi + hi.lo + hi.hi (lo.lo, ~2^-22 relative, is dropped).
// A single TF32 product keeps ~11 mantissa bits (~3e-4 relative) and would
// miss the port's bound, 2^-16 of max|out| against the fp32 plain version;
// 3xTF32 meets it, provided no long chain of products accumulates on the
// tensor cores, which truncate as they add (see mma_3xtf32). What bounds
// these kernels on the H100: three TF32 passes at 495 TFLOP/s, i.e.
// fp32-accurate products at 165 TFLOP/s: 233 GFLOP at FLUX's (1, 4352, 24,
// 128), 1.41 ms, against 0.21 GB of q/k/v/o (0.064 ms); 34.4 GFLOP at the
// VAE's (1, 4096, 1, 512), 0.21 ms.
//  * d = 64 and 128 (`flash_fwd_3xtf32_sm90<D, MODE>`, B, #15 and #14):
//    wgmma. One block is 64 query rows and two warpgroups: a producer that
//    reads q, k and v, splits them and stores hi and lo into
//    128-byte-swizzled K-major tiles (wgmma's tf32 form takes both
//    shared-memory operands K-major only, so V is stored transposed), and a
//    consumer that runs the scores as SS wgmma m64n64k8 and P.V as RS wgmma
//    m64nDk8 with P's hi and lo in registers, each tile's P.V in a fresh
//    accumulator folded into O by one FMA. 192 KB of shared memory at d =
//    128 (96 KB at 64), 256 threads, one block an SM. At d = 64 it replaced
//    an fp32-FMA kernel on the CUDA cores: SD3's (2, 1178, 24, 64) 0.37
//    ms against 0.60, #14 at (2, 24, 295, 295, 64) 0.031 against 0.046
//    (tools/bench_flash.py --fp32, NVIDIA H100 80GB HBM3 at 700 W).
//  * d = 512 (`flash_fwd_3xtf32<MODE>`, B and #15): mma.sync m16n8k8, the
//    splits done in registers as each fragment is read (a 64 x 512 fp32
//    accumulator is 256 registers a thread for one warpgroup, and a wgmma
//    design's split tiles would not fit the SM). 8 warps as 2 row groups
//    of 16 query rows x 4 column groups of 128 output columns (64
//    accumulator registers a thread); each warp of a row group computes
//    the scores over its own 128-wide slice of d, the four partial tiles
//    summed through shared memory in one fixed order, so the four warps
//    hold bit-identical scores and run the same softmax. Per 32-key tile:
//    K and V staged by cp.async into their own tiles (V's load runs under
//    the scores, the next K's under P.V); P.V takes P straight from the
//    score fragments: an m16n8k8 A fragment wants (row g, k t) and (g,
//    t + 4), the accumulator holds (g, 2t) and (g, 2t + 1), so k position
//    t carries key 2t and t + 4 key 2t + 1, and V's B fragment reads rows
//    2t and 2t + 1 to match. Rows padded by 4 floats, so each fragment
//    load hits 32 distinct banks. 210 KB, one block an SM.
// The bf16 kernels' sources are untouched: a separate translation unit, so
// their ptxas register allocation cannot move.
// The ragged kv edge is zero-filled and masked in every kernel.

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

// kernel B (the max of the unscaled scores), #15 (the scale first) and #14
// (#15 against vlen valid keys, with m and l out).
enum Mode { kUnscaledMax = 0, kScaleFirst = 1, kStats = 2 };

// flash_fwd_3xtf32's tiles (d = 512): 4 column groups of 128 output
// columns x 2 row groups of 16 query rows (BQ = 32), BK = 32 keys a tile,
// rows padded by 4 floats, and the partial-score exchange (16 floats a
// thread a warp): 210 KB, one block an SM.
struct Tf32Tile {
  static constexpr int D = 512, CG = 4, BQ = 32, BK = 32, LD = D + 4;
  static constexpr size_t kBytes = ((size_t)(BQ + 2 * BK) * LD + 8 * 16 * 32) * 4;
};

using dk::sm90::split_tf32;

// D += A(16x8, row) * B(8x8, col), tf32 in, fp32 out. Fragments (g = lane
// / 4, t = lane % 4): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0, d1 (g, 2t), (g, 2t + 1),
// d2, d3 the same columns of row g + 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D = A * B (no accumulator input), as mma_tf32.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
}

// T (+)= A * B in 3xTF32 on the tensor cores, the small terms first (lo.hi,
// hi.lo, then hi.hi); T is overwritten where `first`. The tensor cores
// truncate as they accumulate (~2^-24 of |T| a step, toward zero), so a
// chain of products must stay short: the callers sum a few k-steps into a
// fresh T and add it to their running sum in fp32, rounded to nearest
// (with one chain over 4096 keys of P.V the error reached 2.2x the bound).
__device__ __forceinline__ void mma_3xtf32(float (&t)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1, bool first) {
  if (first)
    mma_tf32_zero(t, al, bh0, bh1);
  else
    mma_tf32(t, al, bh0, bh1);
  mma_tf32(t, ah, bl0, bl1);
  mma_tf32(t, ah, bh0, bh1);
}

// Stage ROWS x D fp32 rows (row stride `rs` elements) into a shared tile of
// row stride LD with cp.async; rows at or past `valid` are zero-filled.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void stage_rows(float* smem, const float* g, long long rs, int valid) {
  constexpr int CPR = D / 4;  // 16-byte chunks a row
  for (int c = threadIdx.x; c < ROWS * CPR; c += 256) {
    const int r = c / CPR, col = (c % CPR) * 4;
    const bool ok = r < valid;
    dk::cp_async16(smem + r * LD + col, ok ? g + r * rs + col : g, ok ? 16 : 0);
  }
}

// Kernel B (MODE 0) or #15 (1): S queries of one (batch, head) against its S
// keys at d = 512 on the tensor cores in 3xTF32 (mma.sync), with the
// numerics of the header: the scores summed 4 k-steps at a time,
// each tile's P.V per output n-tile, into fresh accumulators folded in fp32.
template <int MODE>
__global__ void __launch_bounds__(256, 1)
    flash_fwd_3xtf32(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, Strides qs, Strides ks, Strides vs, Strides os, float sc) {
  using T = Tf32Tile;
  constexpr int D = T::D, CG = T::CG, BQ = T::BQ, BK = T::BK, LD = T::LD;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Xs = Vs + BK * LD;  // the partial-score exchange

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp / CG, c0 = 128 * (warp % CG), r0 = 16 * rg;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  // B folds the scale into the exponent; #14/#15 scale the scores first.
  const float e2 = MODE == kUnscaledMax ? sc * kLog2e : kLog2e;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const int nk = (S + BK - 1) / BK;

  stage_rows<BQ, D, LD>(Qs, q + b * qs.b + q0 * qs.s + h * qs.h, qs.s, S - q0);
  dk::cp_async_commit();
  if (nk > 0) {
    stage_rows<BK, D, LD>(Ks, kb, ks.s, S);
    dk::cp_async_commit();
    stage_rows<BK, D, LD>(Vs, vb, vs.s, S);
    dk::cp_async_commit();
  }

  float oacc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // Rows r0 + g and r0 + g + 8; l is this thread's partial row sum.
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    dk::cp_async_wait<1>();  // Q and this K tile; V may still be in flight
    __syncthreads();

    // This warp's scores over d in [c0, c0 + 128): 16 rows x 32 keys.
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      float tq[4][4];
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int d0 = c0 + 32 * kq + 8 * k4;
        uint32_t ah[4], al[4];
        split_tf32(Qs[(r0 + g) * LD + d0 + t], ah[0], al[0]);
        split_tf32(Qs[(r0 + g + 8) * LD + d0 + t], ah[1], al[1]);
        split_tf32(Qs[(r0 + g) * LD + d0 + t + 4], ah[2], al[2]);
        split_tf32(Qs[(r0 + g + 8) * LD + d0 + t + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(Ks[(8 * n + g) * LD + d0 + t], bh0, bl0);
          split_tf32(Ks[(8 * n + g) * LD + d0 + t + 4], bh1, bl1);
          mma_3xtf32(tq[n], ah, al, bh0, bh1, bl0, bl1, k4 == 0);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += tq[n][e];
    }
    // Sum the row group's CG partial tiles, in column-group order: the CG
    // warps of a row group hold bit-identical scores.
    float4* xw = reinterpret_cast<float4*>(Xs) + warp * 4 * 32;
#pragma unroll
    for (int n = 0; n < 4; ++n) xw[n * 32 + lane] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    __syncthreads();
    const float4* xr = reinterpret_cast<const float4*>(Xs) + rg * CG * 4 * 32;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float4 a = xr[n * 32 + lane];
#pragma unroll
      for (int c = 1; c < CG; ++c) {
        const float4 x = xr[(c * 4 + n) * 32 + lane];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      s[n][0] = a.x;
      s[n][1] = a.y;
      s[n][2] = a.z;
      s[n][3] = a.w;
    }

    // Online softmax. Every tile run holds a valid key, so each row's max
    // is a real score: masked columns (the finite -1e30) and the first
    // tile's alpha underflow to 0.
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (MODE != kUnscaledMax) s[n][e] *= sc;
        if (k0 + 8 * n + 2 * t + (e & 1) >= S) s[n][e] = kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f((m0 - mx0) * e2), alpha1 = exp2f((m1 - mx1) * e2);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
    // P's A fragments, key 8c + 2t at k position t and 8c + 2t + 1 at t + 4.
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float p0 = exp2f((s[c][0] - mx0) * e2), p1 = exp2f((s[c][1] - mx0) * e2);
      const float p2 = exp2f((s[c][2] - mx1) * e2), p3 = exp2f((s[c][3] - mx1) * e2);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      split_tf32(p0, ph[c][0], pl[c][0]);
      split_tf32(p2, ph[c][1], pl[c][1]);
      split_tf32(p1, ph[c][2], pl[c][2]);
      split_tf32(p3, ph[c][3], pl[c][3]);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;

    dk::cp_async_wait<0>();  // this V tile
    __syncthreads();         // every warp is done with the K tile (and Xs)
    if (j + 1 < nk) {
      stage_rows<BK, D, LD>(Ks, kb + (k0 + BK) * ks.s, ks.s, S - k0 - BK);
      dk::cp_async_commit();
    }

    // O = O alpha + P . V of this tile's keys, per output n-tile (zero-filled
    // rows past S have p = 0).
    const float* v0 = Vs + 2 * t * LD + c0 + g;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      float pv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v0[8 * c * LD + 8 * n], bh0, bl0);
        split_tf32(v0[(8 * c + 1) * LD + 8 * n], bh1, bl1);
        mma_3xtf32(pv, ph[c], pl[c], bh0, bh1, bl0, bl1, c == 0);
      }
      oacc[n][0] = fmaf(oacc[n][0], alpha0, pv[0]);
      oacc[n][1] = fmaf(oacc[n][1], alpha0, pv[1]);
      oacc[n][2] = fmaf(oacc[n][2], alpha1, pv[2]);
      oacc[n][3] = fmaf(oacc[n][3], alpha1, pv[3]);
    }
    __syncthreads();  // every warp is done with the V tile
    if (j + 1 < nk) {
      stage_rows<BK, D, LD>(Vs, vb + (k0 + BK) * vs.s, vs.s, S - k0 - BK);
      dk::cp_async_commit();
    }
  }
  dk::cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    if (row0 < S)
      *reinterpret_cast<float2*>(ob + row0 * os.s + col) =
          make_float2(oacc[n][0] / l0, oacc[n][1] / l0);
    if (row1 < S)
      *reinterpret_cast<float2*>(ob + row1 * os.s + col) =
          make_float2(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

// ---- d = 64 and 128: 3xTF32 on wgmma -------------------------------------

// One block: 64 query rows of one (batch, head). Warpgroup 0 (the consumer)
// issues the wgmmas; warpgroup 1 (the producer) reads q, k and v from global
// memory, splits each value into tf32 hi and lo and stores both into
// 128-byte-swizzled K-major tiles (v transposed, d x keys, its keys
// permuted within each 8 as P's fragments need them). Shared memory at d =
// 128, each tile hi then lo: Q 2 x 32 KB (4 boxes of 64 rows x 32 values),
// K 2 x 32 KB (64 keys), V^T 2 x 32 KB (2 boxes of 128 rows x 32 keys):
// 192 KB; at d = 64 half of each.
namespace tf32x3 {
constexpr int BQ = 64, BK = 64;
// The shared-memory plan at head dim D: one hi or lo tile is 64 rows x D
// values (V^T: D rows x 64 keys), 32 KB at D = 128; then the barriers
// q_full, k_full, v_full (128 producer arrivals), k_empty, v_empty (4
// consumer warps).
template <int D>
struct Plan {
  static constexpr uint32_t kHalf = BQ * D * 4;
  static constexpr uint32_t kQ = 0, kK = 2 * kHalf, kV = 4 * kHalf, kBar = 6 * kHalf;
  static constexpr size_t kSmem = kBar + 5 * 8 + 1024;
  static_assert(kSmem <= 232448, "one block an SM");
};

// Byte offset of (row r, 16-byte chunk c) of a K-major tile whose rows are
// 32 values (128 bytes), boxes of `rows` rows, 128-byte swizzle.
__device__ __forceinline__ uint32_t swz(int rows, int r, int col) {
  return (col / 32) * rows * 128 + r * 128 + ((((col % 32) / 4) ^ (r % 8)) << 4) + (col % 4) * 4;
}

// Split a float4 into hi and lo and store both at `off` of tile `hi` and
// `hi + half` (a 16-byte chunk of a swizzled row).
__device__ __forceinline__ void store_split4(unsigned char* hi, uint32_t half, uint32_t off,
                                             float4 x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(hi + half + off) = make_uint4(l[0], l[1], l[2], l[3]);
}
}  // namespace tf32x3

// Query rows [0, Sq) of one (batch, head) against keys [0, vlen), at d = 64
// or 128. `sc` is the softmax scale. o fp32 through strides; #14 writes m
// and l at (blockIdx.z * H + blockIdx.y) * Sq + row.
// Scores: D / 8 k-steps of 3 wgmma m64n64k8 SS (Qlo.Khi, Qhi.Klo, Qhi.Khi).
// O: each tile's P.V summed from zero in its own accumulator (8 k-steps of
// 3 wgmma m64nDk8 RS, P's hi and lo from registers: the score fragments
// of columns 2t and 2t + 1 are k positions t and t + 4, which the
// producer's key permutation of V^T matches), then folded into O with
// one fp32 FMA, O alpha + tile, so no long truncating chain runs on the
// tensor cores.
template <int D, int MODE>
__global__ void __launch_bounds__(256, 1)
    flash_fwd_3xtf32_sm90(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int vlen,
                          Strides qs, Strides ks, Strides vs, Strides os, float sc) {
  using namespace tf32x3;
  using namespace dk::sm90;
  constexpr uint32_t kHalf = Plan<D>::kHalf, kQ = Plan<D>::kQ, kK = Plan<D>::kK;
  constexpr uint32_t kV = Plan<D>::kV, kBar = Plan<D>::kBar;
  constexpr int CPR = D / 4;  // float4 a row of q or k
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  const uint32_t q_full = base + kBar, k_full = q_full + 8, v_full = q_full + 16;
  const uint32_t k_empty = q_full + 24, v_empty = q_full + 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (vlen + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);
    mbar_init(k_full, 128);
    mbar_init(v_full, 128);
    mbar_init(k_empty, 4);
    mbar_init(v_empty, 4);
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;

  if (wg == 1) {
    // Producer: D / 8 float4 of q and k a thread (a quarter-warp fills one
    // 128-byte row: conflict-free), v by key (lane = key within 32, so the
    // transposed stores of a warp land in one row's 32 words).
    if (nk == 0) return;
    const int pt = threadIdx.x - 128, pw = pt >> 5;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* kb = k + b * ks.b + h * ks.h;
    const float* vb = v + b * vs.b + h * vs.h;
#pragma unroll 4
    for (int i = 0; i < D / 8; ++i) {
      const int id = i * 128 + pt, r = id / CPR, col = (id % CPR) * 4;
      const float4 x = q0 + r < Sq ? *reinterpret_cast<const float4*>(qb + (q0 + r) * qs.s + col)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      store_split4(gen + kQ, kHalf, swz(BQ, r, col), x);
    }
    fence_proxy_async();
    mbar_arrive(q_full);
    for (int j = 0; j < nk; ++j) {
      const int k0 = j * BK;
      float4 x[D / 8];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int id = i * 128 + pt, r = id / CPR, col = (id % CPR) * 4;
        x[i] = k0 + r < vlen ? *reinterpret_cast<const float4*>(kb + (k0 + r) * ks.s + col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      mbar_wait(k_empty, (j & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int id = i * 128 + pt, r = id / CPR, col = (id % CPR) * 4;
        store_split4(gen + kK, kHalf, swz(BK, r, col), x[i]);
      }
      fence_proxy_async();
      mbar_arrive(k_full);
      // V: key r = lane + 32 (i & 1), d columns 8 (pw + 4 (i >> 1)) .. + 7.
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const int r = lane + 32 * (i & 1), col = 8 * (pw + 4 * (i >> 1));
        const bool ok = k0 + r < vlen;
        const float* src = vb + (k0 + r) * vs.s + col;
        x[2 * i] = ok ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        x[2 * i + 1] =
            ok ? *reinterpret_cast<const float4*>(src + 4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      mbar_wait(v_empty, (j & 1) ^ 1);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const int r = lane + 32 * (i & 1), col = 8 * (pw + 4 * (i >> 1));
        // key r's position in its 8: 2t -> t, 2t + 1 -> t + 4.
        const int kp = (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2);
        const float e[8] = {x[2 * i].x, x[2 * i].y, x[2 * i].z, x[2 * i].w,
                            x[2 * i + 1].x, x[2 * i + 1].y, x[2 * i + 1].z, x[2 * i + 1].w};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          uint32_t hi, lo;
          split_tf32(e[c], hi, lo);
          const uint32_t off = swz(D, col + c, kp);
          *reinterpret_cast<uint32_t*>(gen + kV + off) = hi;
          *reinterpret_cast<uint32_t*>(gen + kV + kHalf + off) = lo;
        }
      }
      fence_proxy_async();
      mbar_arrive(v_full);
    }
    return;
  }

  // Consumer: warp w holds rows 16 w + g and 16 w + g + 8.
  const int warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const float e2 = MODE == kUnscaledMax ? sc * kLog2e : kLog2e;
  const uint64_t dqh = desc_sw128(base + kQ, 16, 1024), dql = desc_sw128(base + kQ + kHalf, 16, 1024);
  const uint64_t dkh = desc_sw128(base + kK, 16, 1024), dkl = desc_sw128(base + kK + kHalf, 16, 1024);
  const uint64_t dvh = desc_sw128(base + kV, 16, 1024), dvl = desc_sw128(base + kV + kHalf, 16, 1024);
  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  if (nk > 0) mbar_wait(q_full, 0);
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK, parity = j & 1;
    float s[32];
    mbar_wait(k_full, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t off = ((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4;
      const uint32_t offk = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
      wgmma_ss_tf32_n64(s, dql + off, dkh + offk, kk > 0);
      wgmma_ss_tf32_n64(s, dqh + off, dkl + offk, 1);
      wgmma_ss_tf32_n64(s, dqh + off, dkh + offk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty);

    // Online softmax: every tile run holds a valid key, so each row's max is
    // a real score (masked columns and the first tile's alpha underflow).
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (MODE != kUnscaledMax) s[4 * n + e] *= sc;
        if (k0 + 8 * n + 2 * t + (e & 1) >= vlen) s[4 * n + e] = kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f((m0 - mx0) * e2), alpha1 = exp2f((m1 - mx1) * e2);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2f((s[4 * n] - mx0) * e2), p1 = exp2f((s[4 * n + 1] - mx0) * e2);
      const float p2 = exp2f((s[4 * n + 2] - mx1) * e2), p3 = exp2f((s[4 * n + 3] - mx1) * e2);
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      split_tf32(p0, ph[n][0], pl[n][0]);
      split_tf32(p2, ph[n][1], pl[n][1]);
      split_tf32(p1, ph[n][2], pl[n][2]);
      split_tf32(p3, ph[n][3], pl[n][3]);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;

    float tile[D / 2];
    mbar_wait(v_full, parity);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t off = ((c / 4) * D * 128 + (c % 4) * 32) >> 4;
      if constexpr (D == 128) {
        wgmma_rs_tf32_n128(tile, pl[c], dvh + off, c > 0);
        wgmma_rs_tf32_n128(tile, ph[c], dvl + off, 1);
        wgmma_rs_tf32_n128(tile, ph[c], dvh + off, 1);
      } else {
        wgmma_rs_tf32_n64(tile, pl[c], dvh + off, c > 0);
        wgmma_rs_tf32_n64(tile, ph[c], dvl + off, 1);
        wgmma_rs_tf32_n64(tile, ph[c], dvh + off, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(tile);
    if (lane == 0) mbar_arrive(v_empty);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[4 * n] = fmaf(oacc[4 * n], alpha0, tile[4 * n]);
      oacc[4 * n + 1] = fmaf(oacc[4 * n + 1], alpha0, tile[4 * n + 1]);
      oacc[4 * n + 2] = fmaf(oacc[4 * n + 2], alpha1, tile[4 * n + 2]);
      oacc[4 * n + 3] = fmaf(oacc[4 * n + 3], alpha1, tile[4 * n + 3]);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row0 = q0 + 16 * warp + g, row1 = row0 + 8;
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(ob + row0 * os.s + col) =
          make_float2(oacc[4 * n] / d0, oacc[4 * n + 1] / d0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(ob + row1 * os.s + col) =
          make_float2(oacc[4 * n + 2] / d1, oacc[4 * n + 3] / d1);
  }
  if constexpr (MODE == kStats) {
    if (t == 0) {
      const long long rows = ((long long)b * gridDim.y + h) * Sq;
      if (row0 < Sq) {
        m_out[rows + row0] = m0;
        l_out[rows + row0] = l0;
      }
      if (row1 < Sq) {
        m_out[rows + row1] = m1;
        l_out[rows + row1] = l1;
      }
    }
  }
}

template <int D, int MODE>
int launch_3xtf32_sm90(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                       int B, int H, int Sq, int vlen, Strides qs, Strides ks, Strides vs,
                       Strides os, float sc, cudaStream_t st) {
  constexpr size_t smem = tf32x3::Plan<D>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_3xtf32_sm90<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + tf32x3::BQ - 1) / tf32x3::BQ, H, B);
  flash_fwd_3xtf32_sm90<D, MODE><<<grid, 256, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l), Sq, vlen, qs, ks,
      vs, os, sc);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_3xtf32(const void* q, const void* k, const void* v, void* o, int B, int H, int S,
                  Strides qs, Strides ks, Strides vs, Strides os, float sc, cudaStream_t st) {
  const size_t smem = Tf32Tile::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_3xtf32<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + Tf32Tile::BQ - 1) / Tf32Tile::BQ, H, B);
  flash_fwd_3xtf32<MODE><<<grid, 256, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, qs, ks, vs, os, sc);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_f32(const void* q, const void* k, const void* v, void* o, void* m, void* l, int B,
                 int H, int Sq, int vlen, int D, Strides qs, Strides ks, Strides vs, Strides os,
                 float sc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_3xtf32_sm90<64, MODE>(q, k, v, o, m, l, B, H, Sq, vlen, qs, ks, vs, os, sc,
                                          st);
    case 128:
      return launch_3xtf32_sm90<128, MODE>(q, k, v, o, m, l, B, H, Sq, vlen, qs, ks, vs, os, sc,
                                           st);
    case 512:  // kernel B and #15 only (#14 runs the MMDiT head dims)
      if constexpr (MODE != kStats)
        return launch_3xtf32<MODE>(q, k, v, o, B, H, Sq, qs, ks, vs, os, sc, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool bad_dims(int B, int H, float scale) {
  return !(scale > 0.f) || B <= 0 || H <= 0 || H > 65535 || B > 65535;
}

}  // namespace

// Kernel B over fp32 (B, S, H, D); the arguments of dk_flash_attn_bf16.
extern "C" int dk_flash_attn_f32(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int H, int D, long long qsb, long long qss, long long qsh,
                                 long long ksb, long long kss, long long ksh, long long vsb,
                                 long long vss, long long vsh, long long osb, long long oss,
                                 long long osh, float scale, void* stream) {
  if (bad_dims(B, H, scale) || S <= 0) return (int)cudaErrorInvalidValue;
  return dispatch_f32<kUnscaledMax>(q, k, v, o, nullptr, nullptr, B, H, S, S, D,
                                    {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                                    {osb, oss, osh}, scale, stream);
}

// #15 over fp32 (B, H, S, D); the arguments of dk_flash_attn_bhsd_bf16.
extern "C" int dk_flash_attn_bhsd_f32(const void* q, const void* k, const void* v, void* o,
                                      int B, int S, int H, int D, long long qsb, long long qss,
                                      long long qsh, long long ksb, long long kss, long long ksh,
                                      long long vsb, long long vss, long long vsh, long long osb,
                                      long long oss, long long osh, float scale, void* stream) {
  if (bad_dims(B, H, scale) || S <= 0) return (int)cudaErrorInvalidValue;
  return dispatch_f32<kScaleFirst>(q, k, v, o, nullptr, nullptr, B, H, S, S, D,
                                   {qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                                   {osb, oss, osh}, scale, stream);
}

// #14 over fp32 q (B, H, Sq, D) and k/v (B, H, Skv, D); the arguments of
// dk_flash_attn_stats_bf16 (D 64 or 128).
extern "C" int dk_flash_attn_stats_f32(const void* q, const void* k, const void* v, void* o,
                                       void* m, void* l, int B, int H, int Sq, int Skv, int D,
                                       int vlen, long long qsb, long long qss, long long qsh,
                                       long long ksb, long long kss, long long ksh,
                                       long long vsb, long long vss, long long vsh,
                                       long long osb, long long oss, long long osh, float scale,
                                       void* stream) {
  if (bad_dims(B, H, scale) || Sq <= 0 || Skv <= 0 || vlen < 0 || vlen > Skv)
    return (int)cudaErrorInvalidValue;
  return dispatch_f32<kStats>(q, k, v, o, m, l, B, H, Sq, vlen, D, {qsb, qss, qsh},
                              {ksb, kss, ksh}, {vsb, vss, vsh}, {osb, oss, osh}, scale, stream);
}
