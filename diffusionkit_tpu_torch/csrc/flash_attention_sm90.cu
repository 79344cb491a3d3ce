// Non-causal flash attention for Hopper, bf16: kernel B and #15 at d = 64
// and 128 (`flash_fwd_sm90<D, kScaleFirst>`) and #14 at d = 128
// (`flash_fwd_sm90_stats<128>`), one block body in compile-time modes
// (`flash_sm90_block`), so each kernel is its own function; and #14 at
// d = 64 (`flash_fwd_sm90_stats64`), a block shaped for short ring chunks
// that shares the body's helpers.
//
// Replaces the Pallas kernels of diffusionkit_tpu/ops/flash_attention.py at
// these head dims (the C entry points in flash_attention.cu route here):
//  * kernel B, flash_attention_bshd (_flash_kernel_bshd), kScaleFirst false:
//    (B, S, H, D), the row max m kept UNSCALED and the scale folded into the
//    exponent, p = exp((s - m) * scale);
//  * #15, flash_attention (_flash_kernel), kScaleFirst true: (B, H, S, D),
//    the scale first, s = (q.k) * scale, m = max s, p = exp(s - m);
//  * #14, flash_attention_stats (_flash_kernel with emit_stats): #15's
//    numerics for q (B, H, Sq, D) against a key chunk (B, H, Skv, D) whose
//    first vlen keys are valid (the k and v tensor maps hold vlen rows, so
//    TMA zero-fills the last tile past them and its columns >= vlen are
//    masked); o in fp32 divided by max(l, 1e-30), m (of the scaled scores)
//    and l in fp32 for the ring's merge; with no valid key nothing is
//    loaded and the block writes o = 0, l = 0, m = -1e30 exactly.
// All three numerics as flash_attention.cu keeps them: fp32 scores, m and
// l; key columns past S (vlen) at the finite -1e30 before the max; P
// rounded to bf16 before P.V; an fp32 accumulator divided by l at the end
// (one reciprocal a row) and rounded once (#14: not rounded). The kernels
// take the max of the raw q.k (a positive scale commutes with it exactly)
// and form the exponent with one FMA, q.k * scale log2(e) - m', then
// ex2.approx: B keeps m unscaled (m' = m scale log2 e), #15 and #14 keep m
// of the scaled scores (m' = m log2 e). That is an fp32 rounding of the
// argument away from (s - m) * c, far inside the one-ulp-plus-2^-8
// tolerance (and #14's l within 1e-4).
//
// Bound on the H100: 4 B H Sq Skv D operations on the bf16 tensor cores
// against the bytes of q, k, v and o, e.g. 233 GFLOP (0.235 ms at 989
// TFLOP/s) against 0.11 GB (0.032 ms) at FLUX's (1, 4352, 24, 128), and
// for #14 at FLUX 2048²'s one-rank ring call (1, 24, 16640, 16640, 128)
// 3.40 TFLOP (3.44 ms) against 0.51 GB (0.31 GB of bf16 q/k/v, 0.20 GB of
// fp32 o): compute-bound at every shape the models run, so the design
// keeps the tensor cores fed and takes the softmax off their path.
// #14 at d = 64 runs its own kernel, flash_fwd_sm90_stats64 (its design
// below). Its bound: 4 B H Sq vlen 64 operations against q, k, v read once
// and o (fp32), m and l written; at SD3 512² CFG's four-rank ring chunk
// (2, 24, 295, 295, 64) 1.07 GFLOP (0.0011 ms) against 9.2 MB (0.0027 ms),
// bytes-bound; at SD3 1024² CFG's one-rank ring call (2, 24, 4250, 4250,
// 64) 222 GFLOP (0.224 ms) against 0.13 GB (0.039 ms), compute-bound. This
// body's 128-row blocks (flash_fwd_sm90_stats<64>) leave a 12-block second
// wave at the 295 chunk (144 blocks on 132 SMs) and were slower than the
// 64-row kernel at all three SD3 shapes, 295, 1063 and 4250 tokens: 0.0145,
// 0.0578-0.0585 and 0.576-0.579 ms against 0.0070, 0.0481-0.0482 and
// 0.525-0.544 (tools/bench_flash on an NVIDIA H100 80GB HBM3 at 700 W, the
// two in turns in one run), so it is not instantiated.
//
// Design (one block = 128 query rows of one (batch, head); grid (Sq/128, H, B)):
//  * 3 warpgroups, 384 threads. Warpgroup 0 is the producer: setmaxnreg
//    lowers it to 24 registers and one thread issues every TMA load. The
//    two consumer warpgroups raise theirs to 240 and each owns 64 query
//    rows: a 64 x D fp32 output accumulator and a 64 x 128 fp32 score tile
//    a warpgroup (64 + 64 registers a thread at d = 128).
//  * TMA: one 4-d tensor map per operand, dims (D, S, H, B) innermost first
//    with the byte strides the wrapper passes, so bshd, bhsd, a packed
//    qkv's head slices and transposed views are the same code and are read
//    in place. 128-byte swizzle; a box is 64 columns (128 bytes) x 128 rows,
//    so a d = 128 tile is two boxes. The hardware zero-fills rows past S.
//    Q is loaded once; K and V go through a ring of stages (3 at d = 128:
//    32 + 3 x 64 KB; 4 at d = 64: 16 + 4 x 32 KB; either way over half the
//    SM, so one block runs an SM, as setmaxnreg's register split assumes),
//    with a full barrier for K, one for V and an empty barrier a stage; the
//    consumers' 8 warps release a stage once its P.V has completed.
//  * Products: S = Q K^T is wgmma m64n128k16 with both operands in shared
//    memory, K-major (d contiguous in both). O += P V is wgmma m64nDk16
//    with A = P from registers: the score fragments of 8-column chunks 2c
//    and 2c+1, packed to bf16, are the A fragment of k-step c. V is read
//    MN-major (the transpose bit), never transposed.
//  * Softmax on the accumulator fragments: a warp owns 16 rows, each quad a
//    row pair, so the row max and sum are two quad shuffles; the last key
//    tile masks columns >= S to -1e30 (TMA's zero rows would otherwise
//    score 0). The epilogue scales by 1/l, rounds once and stores rows < S
//    (#14: float2 stores of o, then each quad's m and l).
//  * Keeping the tensor cores busy through the softmax, chosen by head dim
//    (both measured on the card, the numbers in PERF.md):
//    - d = 64: each consumer issues tile j's scores and tile j-1's P.V
//      together and runs tile j's softmax under them (FlashAttention-3's
//      in-warpgroup overlap); ~5 % faster than the ping-pong below.
//    - d = 128: that overlap keeps the scores, O and P in flight at once
//      (160 registers); ptxas spills and serialises the wgmmas (1.6x
//      slower). So each consumer runs a tile's scores, softmax and P.V in
//      turn, and the two consumers take turns issuing their products on
//      named barriers (ping-pong): one's softmax runs under the other's
//      products (~3 % faster than without the turns).
//
// Design of #14 at d = 64 (flash_fwd_sm90_stats64; one block = 64 query rows
// of one (batch, head); grid (Sq/64, H, B), 240 blocks at the 295 chunk):
//  * 160 threads: one consumer warpgroup (warps 0-3) and one producer warp
//    (warp 4), no setmaxnreg; 105 KB of shared memory and __launch_bounds__
//    (160, 2), so two blocks share an SM and the 295 chunk runs in one wave.
//  * TMA as above: Q in one 64-row box, K and V in 128-key boxes through a
//    ring of 3 stages (384 keys), so a chunk up to 384 keys long is asked
//    for at once and the block waits on one memory latency, not one a tile;
//    longer chunks cycle the ring on its empty barriers.
//  * Products and softmax as the d = 64 path above: S = Q K^T by wgmma
//    m64n128k16 (SS), O += P V by m64n64k16 with P from registers and V
//    MN-major, tile j's scores overlapping tile j-1's P.V.
//  * Epilogue: o scaled by 1 / max(l, 1e-30) into K stage 0 in TMA's
//    128-byte swizzle (two boxes of 32 fp32 columns), then two TMA stores
//    write whole row segments and clip rows past Sq; m and l once a row.

#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace dk::sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kConsumerWarps = 8;

// A block's tiles: BQ = 128 query rows (64 a consumer warpgroup), BK = 128
// keys a tile, in a ring of kStages: 4 at d = 64 (16 + 4 x 32 KB), 3 at
// d = 128 (32 + 3 x 64 KB); either way over half the SM, so one block runs
// an SM, as setmaxnreg's register split assumes. kOverlap: a consumer
// overlaps its softmax with its own products (d = 64) instead of taking
// turns with the other consumer (d = 128); see the note above.
template <int D>
struct Sm90Tile {
  static constexpr int BQ = 128, BK = 128, kStages = D == 64 ? 4 : 3;
  static constexpr bool kOverlap = D == 64;
  static constexpr int kBoxes = D / 64;            // 64-column (128-byte) boxes a row
  static constexpr uint32_t kBoxBytes = 128 * 128;  // 128 rows x 128 bytes
  static constexpr uint32_t kTileBytes = kBoxes * kBoxBytes;
  // Q, the K ring, the V ring, then the barriers: q_full, k_full[kStages],
  // v_full[kStages], empty[kStages].
  static constexpr uint32_t kBarOffset = (1 + 2 * kStages) * kTileBytes;
  static constexpr size_t kSmem = kBarOffset + 8 * (1 + 3 * kStages) + 1024;  // + alignment
  static_assert(kSmem > 232448 / 2 && kSmem <= 232448, "one block an SM");
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one 128-key tile into sacc, D / 16 k-steps committed as one
// group; `dq`, `dk` describe the tile's first k-step.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sacc)[64], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = ((kk / 4) * Sm90Tile<D>::kBoxBytes + (kk % 4) * 32) >> 4;
    wgmma_ss_n128(sacc, dq + off, dk + off, kk > 0);
  }
  wgmma_commit();
}

// O += P V of one 128-key tile, 8 k-steps (16 keys, 2048 bytes of V each)
// committed as one group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&oacc)[D / 2], const uint32_t (&pa)[8][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    if constexpr (D == 64)
      wgmma_rs_n64(oacc, pa[kc], dv + kc * (2048 >> 4), 1);
    else
      wgmma_rs_n128(oacc, pa[kc], dv + kc * (2048 >> 4), 1);
  }
  wgmma_commit();
}

// One consumer warpgroup's online softmax state: rows g and g+8 of each
// warp's 16, m in the kernel's units (unscaled for B, scaled for #15), l
// this thread's partial row sum.
struct RowState {
  float m0, m1, l0, l1;
};

// Scores (raw q.k) of key tile j -> p in place, m and l updated; returns
// the rows' alpha = exp(m_old - m_new) in `al0`, `al1`. `cexp` multiplies a
// raw score in the exponent (scale log2 e for both kernels), `mscale` takes
// a raw max to m's units (B: 1; #15: scale) and `malpha` m's units to the
// exponent's (B: scale log2 e; #15: log2 e).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 2], RowState& st, int j, int S,
                                             int t, float cexp, float mscale, float malpha,
                                             float& al0, float& al1) {
  if ((j + 1) * BK > S) {  // the ragged kv edge: TMA's zero rows score 0
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int col = j * BK + n * 8 + 2 * t;
      if (col >= S) sacc[4 * n] = sacc[4 * n + 2] = kNegInf;
      if (col + 1 >= S) sacc[4 * n + 1] = sacc[4 * n + 3] = kNegInf;
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    mx0 = fmaxf(mx0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
    mx1 = fmaxf(mx1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // A positive scale commutes with the max: max(s * scale) = max(s) * scale
  // exactly. Every tile holds a valid key, so the max is a real score:
  // masked columns and the first tile's alpha underflow to 0.
  mx0 = fmaxf(st.m0, mx0 * mscale);
  mx1 = fmaxf(st.m1, mx1 * mscale);
  al0 = ex2((st.m0 - mx0) * malpha);
  al1 = ex2((st.m1 - mx1) * malpha);
  st.m0 = mx0;
  st.m1 = mx1;
  const float mc0 = mx0 * malpha, mc1 = mx1 * malpha;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    sacc[4 * n] = ex2(fmaf(sacc[4 * n], cexp, -mc0));
    sacc[4 * n + 1] = ex2(fmaf(sacc[4 * n + 1], cexp, -mc0));
    sacc[4 * n + 2] = ex2(fmaf(sacc[4 * n + 2], cexp, -mc1));
    sacc[4 * n + 3] = ex2(fmaf(sacc[4 * n + 3], cexp, -mc1));
    rs0 += sacc[4 * n] + sacc[4 * n + 1];
    rs1 += sacc[4 * n + 2] + sacc[4 * n + 3];
  }
  st.l0 = st.l0 * al0 + rs0;
  st.l1 = st.l1 * al1 + rs1;
}

template <int D>
__device__ __forceinline__ void rescale(float (&oacc)[D / 2], float al0, float al1) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    oacc[4 * n] *= al0;
    oacc[4 * n + 1] *= al0;
    oacc[4 * n + 2] *= al1;
    oacc[4 * n + 3] *= al1;
  }
}

// P (rounded to bf16) as the A fragments of the BK / 16 k-steps: the score
// fragments of 8-column chunks 2c and 2c+1 are the A fragment of k-step c.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&sacc)[BK / 2]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    pa[kc][0] = dk::pack_bf16(sacc[8 * kc], sacc[8 * kc + 1]);
    pa[kc][1] = dk::pack_bf16(sacc[8 * kc + 2], sacc[8 * kc + 3]);
    pa[kc][2] = dk::pack_bf16(sacc[8 * kc + 4], sacc[8 * kc + 5]);
    pa[kc][3] = dk::pack_bf16(sacc[8 * kc + 6], sacc[8 * kc + 7]);
  }
}

// The block's work, shared by the kernels below (compile-time modes, so
// each instantiation is its own function): q rows [0, Sq) of one (batch,
// head) against keys [0, Skv), the k and v maps holding Skv rows.
// kScaleFirst false (kernel B): `sc` is scale * log2(e), m unscaled. True
// (#15, #14): `sc` is the scale, m of the scaled scores. kStats (#14): o in
// fp32 divided by max(l, 1e-30), m and l written at (b H + h) Sq + row, and
// Skv may be 0 (no valid key: no load, o = 0, l = 0, m = -1e30).
template <int D, bool kScaleFirst, bool kStats>
__device__ __forceinline__ void flash_sm90_block(
    const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
    typename std::conditional<kStats, float, bf16>::type* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int Skv, long long osb,
    long long oss, long long osh, float sc) {
  using T = Sm90Tile<D>;
  constexpr int BK = T::BK, NS = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atoms' alignment
  const uint32_t sQ = base, sK = base + T::kTileBytes, sV = sK + NS * T::kTileBytes;
  const uint32_t q_full = base + T::kBarOffset;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * NS, empty = v_full + 8 * NS;

  const int q0 = blockIdx.x * T::BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (Skv + BK - 1) / BK;
  // Kernel B and #15 always have a key; #14 skips every load without one.
  const bool any_key = !kStats || nk > 0;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
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
    if (threadIdx.x == 0 && any_key) {
      mbar_arrive_expect_tx(q_full, T::kTileBytes);
      for (int x = 0; x < T::kBoxes; ++x)
        tma_load_4d(sQ + x * T::kBoxBytes, &tq, q_full, 64 * x, q0, h, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % NS;
        mbar_wait(empty + 8 * s, ((j / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, T::kTileBytes);
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_4d(sK + s * T::kTileBytes + x * T::kBoxBytes, &tk, k_full + 8 * s, 64 * x,
                      j * BK, h, b);
        mbar_arrive_expect_tx(v_full + 8 * s, T::kTileBytes);
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_4d(sV + s * T::kTileBytes + x * T::kBoxBytes, &tv, v_full + 8 * s, 64 * x,
                      j * BK, h, b);
      }
    }
  } else {
    // Consumer warpgroup c: query rows 64c .. 64c + 63 of the block's 128.
    setmaxnreg_inc<240>();
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const float cexp = kScaleFirst ? sc * kLog2e : sc;
    const float mscale = kScaleFirst ? sc : 1.f, malpha = kScaleFirst ? kLog2e : sc;

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    RowState st{kNegInf, kNegInf, 0.f, 0.f};
    float sacc[BK / 2];
    uint32_t pa[BK / 16][4];
    float al0, al1;
    // Descriptors of the consumer's Q rows and of stage 0's K and V; a
    // stage or a k-step adds its byte offset / 16 to the start address.
    const uint64_t desc_q = desc_sw128(sQ + c * 64 * 128, 16, 1024);
    const uint64_t desc_k = desc_sw128(sK, 16, 1024);
    const uint64_t desc_v = desc_sw128(sV, T::kBoxBytes, 1024);
    constexpr uint32_t kStage = T::kTileBytes >> 4;
    auto wait_k = [&](int j) { mbar_wait(k_full + 8 * (j % NS), (j / NS) & 1); };
    auto wait_v = [&](int j) { mbar_wait(v_full + 8 * (j % NS), (j / NS) & 1); };
    auto release = [&](int j) {
      if (lane == 0) mbar_arrive(empty + 8 * (j % NS));
    };
    // Ping-pong (d = 128): the two warpgroups take turns issuing their
    // products (a tile's scores, then its P.V), each waiting on its named
    // barrier 1 + c
    // for the other's previous turn, so one's softmax runs under the other's
    // products instead of beside them. Warpgroup 0 goes first; warpgroup 1's
    // last turn wakes no one.
    auto turn_begin = [&] { named_bar_sync(1 + c, 256); };
    auto turn_end = [&](bool last) {
      if (c == 0 || !last) named_bar_arrive(2 - c, 256);
    };

    if (any_key) {
      mbar_wait(q_full, 0);
      if constexpr (T::kOverlap) {
        // Tile j's scores and tile j-1's P.V are in flight together, so the
        // tensor cores run P.V while this warpgroup's softmax of tile j runs.
        wait_k(0);
        wgmma_fence();
        issue_scores<D>(sacc, desc_q, desc_k);
        wgmma_wait<0>();
        fence_regs(sacc);
        softmax_tile<BK>(sacc, st, 0, Skv, t, cexp, mscale, malpha, al0, al1);
        pack_p<BK>(pa, sacc);
        for (int j = 1; j < nk; ++j) {
          wait_k(j);
          wait_v(j - 1);
          fence_regs(oacc);
          wgmma_fence();
          issue_scores<D>(sacc, desc_q, desc_k + (j % NS) * kStage);
          issue_pv<D>(oacc, pa, desc_v + ((j - 1) % NS) * kStage);
          wgmma_wait<1>();  // the scores; P.V may still run
          fence_regs(sacc);
          softmax_tile<BK>(sacc, st, j, Skv, t, cexp, mscale, malpha, al0, al1);
          wgmma_wait<0>();
          fence_regs(oacc);
          release(j - 1);
          rescale<D>(oacc, al0, al1);
          pack_p<BK>(pa, sacc);
        }
        wait_v(nk - 1);
        fence_regs(oacc);
        wgmma_fence();
        issue_pv<D>(oacc, pa, desc_v + ((nk - 1) % NS) * kStage);
        wgmma_wait<0>();
        fence_regs(oacc);
        release(nk - 1);
      } else {
        if (c == 1) named_bar_arrive(1, 256);
        for (int j = 0; j < nk; ++j) {
          wait_k(j);
          turn_begin();
          wgmma_fence();
          issue_scores<D>(sacc, desc_q, desc_k + (j % NS) * kStage);
          turn_end(false);
          wgmma_wait<0>();
          fence_regs(sacc);
          softmax_tile<BK>(sacc, st, j, Skv, t, cexp, mscale, malpha, al0, al1);
          rescale<D>(oacc, al0, al1);
          pack_p<BK>(pa, sacc);
          wait_v(j);
          fence_regs(oacc);
          turn_begin();
          wgmma_fence();
          issue_pv<D>(oacc, pa, desc_v + (j % NS) * kStage);
          turn_end(j == nk - 1);
          wgmma_wait<0>();
          fence_regs(oacc);
          release(j);
        }
      }
    }

    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    // #14: l >= 1 wherever a key is valid, 0 only with none (o = 0 then).
    const float r0 = 1.f / (kStats ? fmaxf(l0, 1e-30f) : l0);
    const float r1 = 1.f / (kStats ? fmaxf(l1, 1e-30f) : l1);
    const int row0 = q0 + 64 * c + 16 * warp + g, row1 = row0 + 8;
    auto* ob = o + b * osb + h * osh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + 2 * t;
      if constexpr (kStats) {
        if (row0 < Sq)
          *reinterpret_cast<float2*>(ob + row0 * oss + col) =
              make_float2(oacc[4 * n] * r0, oacc[4 * n + 1] * r0);
        if (row1 < Sq)
          *reinterpret_cast<float2*>(ob + row1 * oss + col) =
              make_float2(oacc[4 * n + 2] * r1, oacc[4 * n + 3] * r1);
      } else {
        if (row0 < Sq)
          *reinterpret_cast<uint32_t*>(ob + row0 * oss + col) =
              dk::pack_bf16(oacc[4 * n] * r0, oacc[4 * n + 1] * r0);
        if (row1 < Sq)
          *reinterpret_cast<uint32_t*>(ob + row1 * oss + col) =
              dk::pack_bf16(oacc[4 * n + 2] * r1, oacc[4 * n + 3] * r1);
      }
    }
    if constexpr (kStats) {
      if (t == 0) {  // m is quad-uniform (the softmax's shuffles), l reduced above
        const long long rows = ((long long)b * gridDim.y + h) * Sq;
        if (row0 < Sq) {
          m_out[rows + row0] = st.m0;
          l_out[rows + row0] = l0;
        }
        if (row1 < Sq) {
          m_out[rows + row1] = st.m1;
          l_out[rows + row1] = l1;
        }
      }
    }
  }
}

// Kernel B (kScaleFirst false) and #15 (true) over S queries and keys.
template <int D, bool kScaleFirst>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int S,
                   long long osb, long long oss, long long osh, float sc) {
  flash_sm90_block<D, kScaleFirst, false>(tq, tk, tv, o, nullptr, nullptr, S, S, osb, oss, osh,
                                          sc);
}

// #14: Sq queries against the chunk's vlen valid keys (the k and v maps
// hold vlen rows, so TMA zero-fills the rest of the last tile); `sc` is the
// scale.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_sm90_stats(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                         float* __restrict__ m, float* __restrict__ l, int Sq, int vlen,
                         long long osb, long long oss, long long osh, float sc) {
  flash_sm90_block<D, true, true>(tq, tk, tv, o, m, l, Sq, vlen, osb, oss, osh, sc);
}

// #14 at d = 64: a block is 64 query rows of one (batch, head), one
// consumer warpgroup (warps 0-3) and a producer warp (warp 4); 128-key
// tiles in a ring of 3 stages, so a chunk of up to 384 keys is asked for
// at once. Q (8 KB), the K and V rings (3 x 16 KB each) and the barriers
// take 105 KB, so two blocks share an SM; registers are not rebalanced.
struct Stats64Tile {
  static constexpr int BQ = 64, BK = 128, kStages = 3, kThreads = 160;
  static constexpr uint32_t kQBytes = 64 * 128;    // 64 rows x 128 bytes
  static constexpr uint32_t kKVBytes = 128 * 128;  // 128 keys x 128 bytes
  static constexpr uint32_t kOBoxBytes = 64 * 128;  // 64 rows x 32 fp32 columns
  // Q, the K ring, the V ring, then the barriers: q_full, k_full[kStages],
  // v_full[kStages], empty[kStages].
  static constexpr uint32_t kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  static constexpr size_t kSmem = kBarOffset + 8 * (1 + 3 * kStages) + 1024;  // + alignment
  // 228 KB an SM, 1 KB of it reserved for each block.
  static_assert(2 * (kSmem + 1024) <= 233472, "two blocks an SM");
  static_assert(2 * kOBoxBytes <= kKVBytes, "the o tile fits K stage 0");
};

// #14 at d = 64 (see Stats64Tile): q rows [0, Sq) of one (batch, head)
// against the chunk's vlen valid keys (the k and v maps hold vlen rows); `sc`
// is the scale. The consumer overlaps tile j's scores with tile j-1's P.V,
// as the d = 64 kOverlap path of flash_sm90_block does, with #14's numerics.
// o goes out through shared memory (K stage 0, free once the last tile's
// products are done) by two TMA stores of 64 rows x 32 fp32 columns, whole
// 128-byte row segments; m and l are written once a row.
__global__ void __launch_bounds__(Stats64Tile::kThreads, 2)
    flash_fwd_sm90_stats64(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, float* __restrict__ m_out,
                           float* __restrict__ l_out, int Sq, int vlen, float sc) {
  using T = Stats64Tile;
  constexpr int BK = T::BK, NS = T::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle atoms' alignment
  const uint32_t sQ = base, sK = base + T::kQBytes, sV = sK + NS * T::kKVBytes;
  const uint32_t q_full = base + T::kBarOffset;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * NS, empty = v_full + 8 * NS;

  const int q0 = blockIdx.x * T::BQ, h = blockIdx.y, b = blockIdx.z;
  const int nk = (vlen + BK - 1) / BK;  // 0 with no valid key: nothing is loaded
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // the consumer's 4 warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: one thread asks for Q and every K / V tile as soon as its
    // stage is free; a chunk of up to NS tiles goes out at once.
    if (lane == 0 && nk > 0) {
      mbar_arrive_expect_tx(q_full, T::kQBytes);
      tma_load_4d(sQ, &tq, q_full, 0, q0, h, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % NS;
        mbar_wait(empty + 8 * s, ((j / NS) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + 8 * s, T::kKVBytes);
        tma_load_4d(sK + s * T::kKVBytes, &tk, k_full + 8 * s, 0, j * BK, h, b);
        mbar_arrive_expect_tx(v_full + 8 * s, T::kKVBytes);
        tma_load_4d(sV + s * T::kKVBytes, &tv, v_full + 8 * s, 0, j * BK, h, b);
      }
    }
    return;
  }

  // Consumer warpgroup: the block's 64 query rows, 16 a warp.
  const int g = lane >> 2, t = lane & 3;
  const float cexp = sc * kLog2e, mscale = sc, malpha = kLog2e;
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  RowState st{kNegInf, kNegInf, 0.f, 0.f};
  float sacc[BK / 2];
  uint32_t pa[BK / 16][4];
  float al0, al1;
  const uint64_t desc_q = desc_sw128(sQ, 16, 1024);
  const uint64_t desc_k = desc_sw128(sK, 16, 1024);
  const uint64_t desc_v = desc_sw128(sV, T::kKVBytes, 1024);
  constexpr uint32_t kStage = T::kKVBytes >> 4;
  auto wait_k = [&](int j) { mbar_wait(k_full + 8 * (j % NS), (j / NS) & 1); };
  auto wait_v = [&](int j) { mbar_wait(v_full + 8 * (j % NS), (j / NS) & 1); };
  auto release = [&](int j) {
    if (lane == 0) mbar_arrive(empty + 8 * (j % NS));
  };
  if (nk > 0) {
    mbar_wait(q_full, 0);
    wait_k(0);
    wgmma_fence();
    issue_scores<64>(sacc, desc_q, desc_k);
    wgmma_wait<0>();
    fence_regs(sacc);
    softmax_tile<BK>(sacc, st, 0, vlen, t, cexp, mscale, malpha, al0, al1);
    pack_p<BK>(pa, sacc);
    for (int j = 1; j < nk; ++j) {
      wait_k(j);
      wait_v(j - 1);
      fence_regs(oacc);
      wgmma_fence();
      issue_scores<64>(sacc, desc_q, desc_k + (j % NS) * kStage);
      issue_pv<64>(oacc, pa, desc_v + ((j - 1) % NS) * kStage);
      wgmma_wait<1>();  // the scores; P.V may still run
      fence_regs(sacc);
      softmax_tile<BK>(sacc, st, j, vlen, t, cexp, mscale, malpha, al0, al1);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(j - 1);
      rescale<64>(oacc, al0, al1);
      pack_p<BK>(pa, sacc);
    }
    wait_v(nk - 1);
    fence_regs(oacc);
    wgmma_fence();
    issue_pv<64>(oacc, pa, desc_v + ((nk - 1) % NS) * kStage);
    wgmma_wait<0>();
    fence_regs(oacc);
    release(nk - 1);
  }

  float l0 = st.l0, l1 = st.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // l >= 1 wherever a key is valid, 0 only with none (o = 0 then).
  const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
  // o into K stage 0 as TMA's 128-byte swizzle lays a box out: row r's
  // 16-byte chunk c at r * 128 + ((c ^ (r % 8)) * 16), box x holding columns
  // 32x .. 32x + 31. A warp's float2 stores then fill every bank twice.
  named_bar_sync(1, 128);  // every product of the warpgroup has read its K tiles
  const uint32_t sO = sK;
  const int r = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const uint32_t box = sO + (n >> 2) * T::kOBoxBytes;
    const uint32_t chunk = 2 * (n & 3) + (t >> 1), off = (t & 1) * 8;
    st_shared_v2f(box + r * 128 + ((chunk ^ (r & 7)) << 4) + off, oacc[4 * n] * r0,
                  oacc[4 * n + 1] * r0);
    st_shared_v2f(box + (r + 8) * 128 + ((chunk ^ ((r + 8) & 7)) << 4) + off,
                  oacc[4 * n + 2] * r1, oacc[4 * n + 3] * r1);
  }
  fence_proxy_async();
  named_bar_sync(1, 128);
  if (threadIdx.x == 0) {  // rows past Sq are not written
    tma_store_4d(&to, sO, 0, q0, h, b);
    tma_store_4d(&to, sO + T::kOBoxBytes, 32, q0, h, b);
    bulk_commit_group();
  }
  if (t == 0) {  // m is quad-uniform (the softmax's shuffles), l reduced above
    const long long rows = ((long long)b * gridDim.y + h) * Sq;
    const int row0 = q0 + r, row1 = row0 + 8;
    if (row0 < Sq) {
      m_out[rows + row0] = st.m0;
      l_out[rows + row0] = l0;
    }
    if (row1 < Sq) {
      m_out[rows + row1] = st.m1;
      l_out[rows + row1] = l1;
    }
  }
  if (threadIdx.x == 0) bulk_wait_group_read0();  // the tile stays until TMA has read it
}

// The tensor map of one (B, S, H, D) operand read through its strides (in
// elements, batch / sequence / head), a box of 64 columns x `rows` rows; a
// dim of size 1 takes a stride of 16 bytes, which TMA accepts whatever
// torch reports for it.
int encode_operand(CUtensorMap* map, const void* p, int B, int S, int H, int D, long long sb,
                   long long ss, long long sh, cuuint32_t rows = 128) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {S == 1 ? 16 : 2 * (cuuint64_t)ss,
                                 H == 1 ? 16 : 2 * (cuuint64_t)sh,
                                 B == 1 ? 16 : 2 * (cuuint64_t)sb};
  const cuuint32_t box[4] = {64, rows, 1, 1};
  return encode_tmap_bf16_4d(map, p, dims, strides, box);
}

template <int D, bool kScaleFirst>
int launch_sm90(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                const long long (&st)[12], float sc, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  using T = Sm90Tile<D>;
  int e = encode_operand(&tq, q, B, S, H, D, st[0], st[1], st[2]);
  if (e == 0) e = encode_operand(&tk, k, B, S, H, D, st[3], st[4], st[5]);
  if (e == 0) e = encode_operand(&tv, v, B, S, H, D, st[6], st[7], st[8]);
  if (e != 0) return e;
  const size_t smem = T::kSmem;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_fwd_sm90<D, kScaleFirst>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((S + T::BQ - 1) / T::BQ, H, B);
  flash_fwd_sm90<D, kScaleFirst><<<grid, 384, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), S, st[9], st[10], st[11], sc);
  return (int)cudaGetLastError();
}

// #14: the q map holds Sq rows, the k and v maps the vlen valid keys (Skv
// rows where vlen is 0: no tile is loaded then).
template <int D>
int launch_sm90_stats(const void* q, const void* k, const void* v, float* o, float* m, float* l,
                      int B, int H, int Sq, int Skv, int vlen, const long long (&st)[12],
                      float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  using T = Sm90Tile<D>;
  const int rows = vlen > 0 ? vlen : Skv;
  int e = encode_operand(&tq, q, B, Sq, H, D, st[0], st[1], st[2]);
  if (e == 0) e = encode_operand(&tk, k, B, rows, H, D, st[3], st[4], st[5]);
  if (e == 0) e = encode_operand(&tv, v, B, rows, H, D, st[6], st[7], st[8]);
  if (e != 0) return e;
  const size_t smem = T::kSmem;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_fwd_sm90_stats<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((Sq + T::BQ - 1) / T::BQ, H, B);
  flash_fwd_sm90_stats<D><<<grid, 384, smem, stream>>>(tq, tk, tv, o, m, l, Sq, vlen, st[9],
                                                       st[10], st[11], scale);
  return (int)cudaGetLastError();
}

// #14 at d = 64: q read in 64-row boxes, the k and v maps holding the vlen
// valid keys (Skv rows where vlen is 0: no tile is loaded then) in 128-row
// boxes, and o (fp32, its strides in elements) written through a map of
// 64-row x 32-column boxes, 128-byte swizzle.
int launch_sm90_stats64(const void* q, const void* k, const void* v, float* o, float* m,
                        float* l, int B, int H, int Sq, int Skv, int vlen,
                        const long long (&st)[12], float scale, cudaStream_t stream) {
  using T = Stats64Tile;
  CUtensorMap tq, tk, tv, to;
  const int rows = vlen > 0 ? vlen : Skv;
  int e = encode_operand(&tq, q, B, Sq, H, 64, st[0], st[1], st[2], T::BQ);
  if (e == 0) e = encode_operand(&tk, k, B, rows, H, 64, st[3], st[4], st[5], T::BK);
  if (e == 0) e = encode_operand(&tv, v, B, rows, H, 64, st[6], st[7], st[8], T::BK);
  if (e == 0) {
    const cuuint64_t dims[4] = {64, (cuuint64_t)Sq, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {Sq == 1 ? 16 : 4 * (cuuint64_t)st[10],
                                   H == 1 ? 16 : 4 * (cuuint64_t)st[11],
                                   B == 1 ? 16 : 4 * (cuuint64_t)st[9]};
    const cuuint32_t box[4] = {32, (cuuint32_t)T::BQ, 1, 1};
    e = encode_tmap(&to, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, o, dims, strides, box);
  }
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_fwd_sm90_stats64, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((Sq + T::BQ - 1) / T::BQ, H, B);
  flash_fwd_sm90_stats64<<<grid, T::kThreads, T::kSmem, stream>>>(tq, tk, tv, to, m, l, Sq, vlen,
                                                                  scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B (scale_first false, `sc` = scale * log2(e)) or #15 (true, `sc` =
// scale) at d = 64 or 128; strides in elements, (batch, sequence, head) for
// q, k, v and o in turn. Called by flash_attention.cu's entry points.
int dk_flash_attn_sm90_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                            int H, int D, const long long (&strides)[12], float sc,
                            bool scale_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return scale_first ? launch_sm90<64, true>(q, k, v, o, B, S, H, strides, sc, st)
                       : launch_sm90<64, false>(q, k, v, o, B, S, H, strides, sc, st);
  if (D == 128)
    return scale_first ? launch_sm90<128, true>(q, k, v, o, B, S, H, strides, sc, st)
                       : launch_sm90<128, false>(q, k, v, o, B, S, H, strides, sc, st);
  return (int)cudaErrorInvalidValue;
}

// #14 at d = 64 or 128: q (B, H, Sq, D) against k/v (B, H, Skv, D) with
// `vlen` valid leading keys; strides as above (o's in fp32 elements), m and
// l contiguous (B, H, Sq). Called by flash_attention.cu's entry point.
int dk_flash_attn_stats_sm90_bf16(const void* q, const void* k, const void* v, float* o,
                                  float* m, float* l, int B, int H, int Sq, int Skv, int D,
                                  int vlen, const long long (&strides)[12], float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_sm90_stats64(q, k, v, o, m, l, B, H, Sq, Skv, vlen, strides, scale, st);
  if (D == 128)
    return launch_sm90_stats<128>(q, k, v, o, m, l, B, H, Sq, Skv, vlen, strides, scale, st);
  return (int)cudaErrorInvalidValue;
}
