// Kernels C, #13, E (mode plain) and #11 at M <= 16: the AdaLN `ada` and
// embedder GEMVs, split along K; C and #13 also on fp32 x (an fp32 model's
// `ada`, dequant_gemv_f32 below).
//
// Replaces, at the rows these projections have (M = 1 for FLUX, 2 for SD3
// with CFG; ops/int4_matmul.py and ops/w4a8_matmul.py route M <= 16 here),
// the Pallas kernels diffusionkit_tpu/ops/int4_matmul.py:int4_matmul
// (_kernel, kernel C), :int8_matmul (_kernel8, #13),
// diffusionkit_tpu/ops/w4a8_matmul.py:w4a8_matmul in mode plain (_kernel,
// kernel E) and :w8_matmul (_kernel_w8, #11). What each computes
// (int4_matmul_sm90.cu, w4a8_matmul_sm90.cu and w8_matmul.cu, which run
// M > 16, say it in full):
//   C, #13  y = x @ W, W = bf16(q * s + z) (the product and the sum each
//           rounded in fp32), the products summed in fp32, y rounded to
//           bf16 once;
//   E       w8 = clip(rne(q * s8 + z8)), s8 = s * (1 / ws), z8 = z * (1 /
//           ws); acc = x8 @ w8, exact in int32; y = ((acc * xs[m]) * ws[n])
//           + b[n] -> bf16 or fp32, every step rounded (the bias bf16 or
//           fp32: an fp32-upcast block's `ada` has an fp32 bias);
//   #11     the same epilogue on an int8 w8 (N, K) (the bias added only
//           where there is one), to bf16 or fp32; its quantizing entry
//           first quantizes float x per row as kernel D does.
//
// Bound: bytes. At M <= 16 the products are a small share of the tensor
// cores' time; what has to move is the packed weight and its scale and zero
// rows, each read once: 35.4 MB at FLUX's dual-block `ada` (K 3072, N 18432,
// group 64), 10.6 us at 3.35 TB/s; 17.7 MB for #13 at SD3's (1536 x 9216,
// group 32), 5.3 us. A 16-row mma.sync tile that walked all of K in each of
// N / 128 blocks, ~6 KB of weight in flight a block and a shared-memory
// round trip (dequantise into a tile, ldmatrix it back, two barriers) every
// k tile, reached 11-16 % of that.
//
// Design:
// * Split K: grid (S, N / 128), S <= 8 picked by ops/int4_matmul.py:
//   gemv_splits for the card's waves of resident blocks (2 a SM); each
//   block takes one (K / S) x 128 slab, whole groups.
// * No shared tile: each lane streams its own weights straight into
//   registers, 16 bytes a row (4 columns' words, or 8 columns' bytes for
//   #13) with no L1 allocation, a ring of 2-4 chunks in flight.
// * Dequantise in registers, straight into mma.sync's B fragments. Lane
//   (g, t) supplies column g at the k positions that t names; a sum over k
//   does not care which physical k stands at which position, as long as x's
//   A fragment uses the same map. So lane t walks its own contiguous quarter
//   of the warp's k range, and a packed word (8 consecutive k of one column)
//   is two k16 steps' B fragments for C, one k32 step's for E, with no data
//   exchanged between lanes. x's A fragment is then 16 (C) or 8 bytes a row
//   and word row, read from global memory (the slab's x stays in L1). A
//   chunk is two word rows (C, E) or four byte rows (#13).
// * Warps: 4 x 32 columns x 2 k halves (C, E), 2 x 64 columns x 4 k
//   quarters (#13). A block sums its warps' partials in shared memory in
//   warp order and stores them to an fp32 (int32 for E) workspace; the last
//   of a column tile's S blocks to arrive (an integer counter a tile, reset
//   by that block) sums the S partials in split order and applies the
//   epilogue. One launch, no float atomics, the order of every sum fixed.
// * C and #13 dequantise in fp32 as the reference does: q * s as one FMA,
//   f * s - 2^23 s on f = 2^23 + q (exact: the product is q * s before the
//   one rounding), then + z rounded; the high nibble of a byte is read in
//   place as f = 2^23 + 16 q against s / 16 and -2^23 s / 16 (exact unless
//   s / 16 is subnormal; quantised scales are >= 1e-8). #13's byte becomes f
//   by one byte_perm. E requantises by a per-(group, column) table of its 16
//   grid values (common.cuh requant_lut, built with the exact fp32 steps)
//   and byte_perm lookups (lut_word), as w4a8_matmul_sm90.cu does.
//
// Tried and dropped on the H100 (variant builds timed as tools/bench_gemv.py
// times, not kept): every lane's weights through cp.async into its own
// 12-deep shared ring (slower than plain loads even with no arithmetic, and
// slower still with a deeper ring); a TMA producer warp with bulk copies on
// full/empty mbarriers (copies of 128-512 bytes issue too slowly: #13's
// small shapes ran slower than the old tile); the splits of a tile as a
// thread-block cluster summed through distributed shared memory (blocks
// idled at the cluster barrier); x prefetched a chunk ahead in registers
// (C then spilled). What bounds the kernel now is its issue rate: with the
// memory traffic taken out, the dequantisation alone took most of C's time.
//
// #11 (w8_gemv, at the end) has no dequantisation and another layout: its
// 14.2 MB `ada` weight at SD3's (1536 x 9216) is 4.2 us at 3.35 TB/s, and
// the old 16-row tile (w8_matmul.cu w8_mm, 72 blocks each walking all of K
// through a cp.async double buffer) took 10.6 us with the weight cold. A
// lane's 16-byte load of w8 (N, K) is 16 consecutive k of one column: by
// the same k-permutation argument, two m16n8k32 steps' B fragments with no
// exchange between lanes, the 4 lanes of a column reading 64 consecutive
// bytes. Measured on the H100 and kept: 64-column blocks, 4 warps along K,
// and K split only past 2048 k a block (ops/w4a8_matmul.py
// w8_gemv_splits), the splits of a column tile then one thread-block
// cluster that sums its blocks' partials through distributed shared
// memory. A split cost ~2 us (the workspace's fence, counter and second
// read as much as the cluster's barriers), more than 64-column blocks
// streaming all of K gave back; x's slab is copied to shared memory once,
// and the epilogue's wscale, bias and xscale are loaded at the start (each
// had been a round trip after the main loop). Its quantizing entry takes
// float x, so kernel D's launch before each of these GEMVs goes: each block
// reads all of x's M <= 16 rows (a few KB, from L2) for their absmax and
// quantizes its slab into shared memory, D's arithmetic bit for bit, while
// its first weights load.

#include <cooperative_groups.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256, BN = 128, MAX_M = 16, MAX_SPLITS = 8, MAX_TILES = 65536;
enum Kind { INT4 = 0, INT8 = 1, W4A8 = 2, INT4_F32 = 3, INT8_F32 = 4 };

// Per kernel and column tile, the splits that have stored their partial in
// the current launch: zero between launches (the last split of a tile resets
// it), so a CUDA graph may replay a launch. One stream at a time.
__device__ int g_arrivals[5][MAX_TILES];

// Per kind: columns a lane (CPT) and a warp (8 CPT), k a chunk (KC), rows
// of a lane's chunk (ROWS; KR k a row: two packed word rows of 16 bytes, or
// four byte rows of 8; a part of C or E may end in a chunk of one row),
// column warps (CW) and k groups of warps (H), k parts of a block's slab
// (P: one a lane quarter of each k group), and chunks in flight (D).
template <int KIND>
struct Cfg {
  static constexpr bool kBytes = KIND == INT8;
  static constexpr int CPT = kBytes ? 8 : 4;
  static constexpr int KC = kBytes ? 4 : 16;
  static constexpr int ROWS = kBytes ? 4 : 2;
  static constexpr int KR = KC / ROWS;
  static constexpr int CW = BN / (8 * CPT);
  static constexpr int H = 8 / CW;
  static constexpr int P = 4 * H;
  static constexpr int D = KIND == INT8 ? 2 : (KIND == INT4 ? 3 : 4);
  static constexpr size_t bytes = (size_t)H * MAX_M * BN * 4 + 16;  // partials, the last flag
};

struct Params {
  const void* x;        // (M, K) rows, lda apart: bf16 (C, #13) or int8 (E)
  const void* qw;       // int32 words (K / 8, N), or uint8 (K, N) for #13
  const float* scales;  // (K / group, N)
  const float* zeros;
  const float* wscale;  // E: (N,)
  const float* xscale;  // E: (M,)
  const void* bias;     // E: (N,) bf16, or fp32 with bias_f32, or null
  void* y;              // (M, N) bf16, or fp32 with out_f32
  void* partials;       // (N / 128, S, M, 128) fp32 (C, #13) or int32 (E)
  int* arrivals;        // (N / 128,), this kernel's row of g_arrivals
  long long lda;
  int M, N, K, group;
  int bias_f32, out_f32;  // bias_f32: E
};

// A lane's weights of one chunk: a 16-byte run of 4 columns' words a word
// row (C, E), or 8 columns' bytes a byte row (#13).
template <int KIND>
struct WChunk {
  using V = typename std::conditional<KIND == INT8, uint2, uint4>::type;
  V v[Cfg<KIND>::ROWS];
};

// x's A-fragment bytes of one row and chunk, a vector a packed word row: 8 k
// of bf16 (C) or int8 (E); for #13 one vector of its 4 k of bf16.
template <int KIND>
struct XChunk {
  using V = typename std::conditional<KIND == INT4, uint4, uint2>::type;
  V v[KIND == INT8 ? 1 : 2];
};

// The first `n` vectors of a chunk, rows `stride` bytes apart from `src`
// (read once: no L1 allocation), zeros past them.
template <typename T>
__device__ __forceinline__ T load_rows(const unsigned char* src, long long stride, int n) {
  using V = typename std::remove_reference<decltype(T{}.v[0])>::type;
  T c{};
#pragma unroll
  for (int i = 0; i < (int)(sizeof(c.v) / sizeof(V)); ++i) {
    if (i >= n) break;
    if constexpr (sizeof(V) == 16) {
      uint4 r;
      asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
                   : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(src + i * stride));
      c.v[i] = r;
    } else {
      uint2 r;
      asm volatile("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];"
                   : "=r"(r.x), "=r"(r.y) : "l"(src + i * stride));
      c.v[i] = r;
    }
  }
  return c;
}

// One x row's chunk from `src`: its first `n` vectors, zeros past them (x
// stays in L1: every column warp of the block reads it).
template <int KIND>
__device__ __forceinline__ XChunk<KIND> load_x(const unsigned char* src, int n) {
  using V = typename XChunk<KIND>::V;
  XChunk<KIND> c{};
#pragma unroll
  for (int i = 0; i < (int)(sizeof(c.v) / sizeof(V)); ++i)
    if (i < n) c.v[i] = __ldg(reinterpret_cast<const V*>(src) + i);
  return c;
}

// A group's scale and zero values of a lane's CPT columns.
template <int KIND>
struct Affine {
  float4 s[Cfg<KIND>::CPT / 4], z[Cfg<KIND>::CPT / 4];
};

template <int KIND>
__device__ __forceinline__ Affine<KIND> load_affine(const Params& p, int gi, int col) {
  Affine<KIND> a;
  const long long off = (long long)gi * p.N + col;
#pragma unroll
  for (int i = 0; i < Cfg<KIND>::CPT / 4; ++i) {
    a.s[i] = __ldg(reinterpret_cast<const float4*>(p.scales + off) + i);
    a.z[i] = __ldg(reinterpret_cast<const float4*>(p.zeros + off) + i);
  }
  return a;
}

// (w & MASK) | magic in one LOP3 (written as two operations, ptxas keeps
// both constants as immediates and issues two).
template <uint32_t MASK>
__device__ __forceinline__ float nibble_f(uint32_t w, uint32_t magic) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(w), "n"(MASK), "r"(magic));
  return __uint_as_float(d);
}

// Nibbles 2i and 2i + 1 of `w` (q at bits 0 and 4 of one byte) -> one bf16
// pair of bf16(q * s + z), the product and the sum each rounded in fp32.
__device__ __forceinline__ uint32_t dequant_pair(uint32_t w, uint32_t magic, float s, float c,
                                                 float s16, float c16, float z) {
  const float lo = nibble_f<0xFu>(w, magic);   // 2^23 + q0
  const float hi = nibble_f<0xF0u>(w, magic);  // 2^23 + 16 q1
  return dk::pack_bf16(__fadd_rn(__fmaf_rn(lo, s, c), z), __fadd_rn(__fmaf_rn(hi, s16, c16), z));
}

// The end of a split-K GEMV block: its H k parts' partials, red [H][M][BN],
// summed in part order and stored to the workspace; the last of the column
// tile's S blocks to arrive (an integer counter a tile, reset by that block)
// sums the S partials in split order and hands each output to
// store(m, n, v). One launch, no float atomics, the order of every sum fixed.
template <int H, typename Acc, typename Store>
__device__ __forceinline__ void finish(const Params& p, const Acc* red, int* last_flag,
                                       Store store) {
  __syncthreads();
  const int tid = threadIdx.x, S = gridDim.x, tile = blockIdx.y, n0 = tile * BN;
  const int total = p.M * BN;
  Acc* parts = static_cast<Acc*>(p.partials) + (long long)tile * S * total;
  for (int i = tid; i < total; i += NTHREADS) {
    Acc v = red[i];
#pragma unroll
    for (int q = 1; q < H; ++q) v += red[q * total + i];
    __stcg(parts + blockIdx.x * total + i, v);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int arrived = atomicAdd(p.arrivals + tile, 1);
    *last_flag = arrived == S - 1;
    if (arrived == S - 1) p.arrivals[tile] = 0;  // for the next launch
  }
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  for (int i = tid; i < total; i += NTHREADS) {
    Acc v = __ldcg(parts + i);
    for (int q = 1; q < S; ++q) v += __ldcg(parts + q * total + i);
    store(i / BN, n0 + i % BN, v);
  }
}

template <int KIND>
__device__ __forceinline__ void gemv(const Params& p) {
  using C = Cfg<KIND>;
  using Acc = typename std::conditional<KIND == W4A8, int, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* red = reinterpret_cast<Acc*>(smem);  // [H][M][BN]
  int* last_flag = reinterpret_cast<int*>(smem + (size_t)C::H * MAX_M * BN * 4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = gridDim.x, tile = blockIdx.y, n0 = tile * BN;
  const int M = p.M, N = p.N, group = p.group;
  const int kslab = p.K / S, kp = kslab / C::P;
  const int L = (kp + C::KC - 1) / C::KC;                // chunks of each part
  const int last_rows = (kp - (L - 1) * C::KC) / C::KR;  // rows of its last chunk

  // Warp (cw, h), lane (g, t): part 4h + t of the block's slab, CPT columns.
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp % C::CW, h = warp / C::CW, part = 4 * h + t;
  const int k0 = blockIdx.x * kslab + part * kp;  // this lane's k range [k0, k0 + kp)
  const int cb = cw * 8 * C::CPT + C::CPT * g;    // its first column in the block
  const int col = n0 + cb;
  const uint32_t magic = 0x4B000000u;             // 2^23: f = magic | q is 2^23 + q

  // The lane's weights, a register ring of D chunks in flight.
  const long long wstride = KIND == INT8 ? N : 4LL * N;  // bytes a row
  const unsigned char* wp = static_cast<const unsigned char*>(p.qw) +
                            (KIND == INT8 ? (long long)k0 * N + col : 4 * ((long long)(k0 / 8) * N + col));
  auto chunk_rows = [&](int r) { return r + 1 < L ? C::ROWS : (r + 1 == L ? last_rows : 0); };
  WChunk<KIND> ring[C::D];
#pragma unroll
  for (int i = 0; i < C::D; ++i)
    ring[i] = load_rows<WChunk<KIND>>(wp + i * C::ROWS * wstride, wstride, chunk_rows(i));

  // The group affine: C and E load the first group's now and each next
  // one's a group ahead; #13 (8 chunks a group, and 8 columns' worth of
  // registers) loads each at its start.
  int next = k0;
  Affine<KIND> pend;
  if constexpr (KIND != INT8) pend = load_affine<KIND>(p, k0 / group, col);

  // x rows g and g + 8 of this part, a chunk of KC k at a time.
  const int esize = KIND == W4A8 ? 1 : 2;
  const unsigned char* xpa = static_cast<const unsigned char*>(p.x) + ((long long)g * p.lda + k0) * esize;
  const unsigned char* xpb = xpa + 8 * p.lda * esize;
  const bool va = g < M, vb = g + 8 < M;

  // Per-column constants of the current group: s, -2^23 s and z (and
  // s / 16, -2^23 s / 16 for C's high nibbles); E's 16-value tables and
  // 1 / ws.
  float cs[C::CPT], cc[C::CPT], cz[C::CPT], cs16[4], cc16[4];
  uint4 lut[4];
  float rw[4];
  if constexpr (KIND == W4A8) {
    const float4 w4 = __ldg(reinterpret_cast<const float4*>(p.wscale + col));
    rw[0] = __fdiv_rn(1.f, w4.x), rw[1] = __fdiv_rn(1.f, w4.y);
    rw[2] = __fdiv_rn(1.f, w4.z), rw[3] = __fdiv_rn(1.f, w4.w);
  }
  Acc acc[C::CPT][4];
#pragma unroll
  for (int j = 0; j < C::CPT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  // Where a group starts at k `ki`: its constants from `pend`, and the next
  // group's affine loaded a group ahead.
  auto group_at = [&](int ki) {
    if (ki != next) return;
    if constexpr (KIND == INT8) pend = load_affine<KIND>(p, ki / group, col);
    float s[C::CPT], z[C::CPT];
#pragma unroll
    for (int i = 0; i < C::CPT / 4; ++i) {
      s[4 * i] = pend.s[i].x, s[4 * i + 1] = pend.s[i].y, s[4 * i + 2] = pend.s[i].z;
      s[4 * i + 3] = pend.s[i].w;
      z[4 * i] = pend.z[i].x, z[4 * i + 1] = pend.z[i].y, z[4 * i + 2] = pend.z[i].z;
      z[4 * i + 3] = pend.z[i].w;
    }
#pragma unroll
    for (int j = 0; j < C::CPT; ++j) {
      if constexpr (KIND == W4A8) {
        lut[j] = dk::requant_lut(__fmul_rn(s[j], rw[j]), __fmul_rn(z[j], rw[j]));
      } else {
        cs[j] = s[j];
        cc[j] = -8388608.f * s[j];
        cz[j] = z[j];
        if constexpr (KIND == INT4) {
          cs16[j] = 0.0625f * s[j];
          cc16[j] = -8388608.f * cs16[j];
        }
      }
    }
    const int gi = ki / group + 1;
    next = gi * group;
    if constexpr (KIND != INT8)
      if (next < k0 + kp) pend = load_affine<KIND>(p, gi, col);
  };

#pragma unroll 1
  for (int r0 = 0; r0 < L; r0 += C::D) {
#pragma unroll
    for (int i = 0; i < C::D; ++i) {
      const int r = r0 + i;
      if (r >= L) break;
      const int k = k0 + r * C::KC;
      const int rows = chunk_rows(r);
      const XChunk<KIND> xa = load_x<KIND>(xpa, va ? rows : 0);
      const XChunk<KIND> xb = load_x<KIND>(xpb, vb ? rows : 0);
      xpa += C::KC * esize;
      xpb += C::KC * esize;
      const WChunk<KIND> w = ring[i];
      ring[i] = load_rows<WChunk<KIND>>(wp + (r + C::D) * C::ROWS * wstride, wstride,
                                        chunk_rows(r + C::D));

      if constexpr (KIND == INT4) {
        // Word row q: k + 8q + 0..3 at positions 2t, 2t+1, 2t+8, 2t+9 of
        // step 2q, k + 8q + 4..7 of step 2q + 1.
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == rows) break;
          group_at(k + 8 * q);
          const uint32_t wq[4] = {w.v[q].x, w.v[q].y, w.v[q].z, w.v[q].w};
          const uint4 u = xa.v[q], v = xb.v[q];
          const uint32_t a0[4] = {u.x, v.x, u.y, v.y}, a1[4] = {u.z, v.z, u.w, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b0 = dequant_pair(wq[j], magic, cs[j], cc[j], cs16[j], cc16[j], cz[j]);
            const uint32_t b1 = dequant_pair(wq[j] >> 8, magic, cs[j], cc[j], cs16[j], cc16[j], cz[j]);
            const uint32_t b2 = dequant_pair(wq[j] >> 16, magic, cs[j], cc[j], cs16[j], cc16[j], cz[j]);
            const uint32_t b3 = dequant_pair(wq[j] >> 24, magic, cs[j], cc[j], cs16[j], cc16[j], cz[j]);
            dk::mma_bf16_16816(acc[j], a0, b0, b1);
            dk::mma_bf16_16816(acc[j], a1, b2, b3);
          }
        }
      } else if constexpr (KIND == INT8) {
        group_at(k);  // groups start at multiples of 32 k, so at a chunk's first row
        // k + 0, 1 at positions 2t, 2t+1; k + 2, 3 at 2t+8, 2t+9.
        const uint32_t a[4] = {xa.v[0].x, xb.v[0].x, xa.v[0].y, xb.v[0].y};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t src = j < 4 ? w.v[q].x : w.v[q].y;
            const float f = __uint_as_float(__byte_perm(src, magic, 0x7440 | (j & 3)));
            v[q] = __fadd_rn(__fmaf_rn(f, cs[j], cc[j]), cz[j]);
          }
          dk::mma_bf16_16816(acc[j], a, dk::pack_bf16(v[0], v[1]), dk::pack_bf16(v[2], v[3]));
        }
      } else {
        // Word row q: k + 8q + 0..3 at positions 4t..4t+3, k + 8q + 4..7 at
        // 16+4t..16+4t+3.
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == rows) break;
          group_at(k + 8 * q);
          const uint32_t wq[4] = {w.v[q].x, w.v[q].y, w.v[q].z, w.v[q].w};
          const uint32_t a[4] = {xa.v[q].x, xb.v[q].x, xa.v[q].y, xb.v[q].y};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint2 b = dk::lut_word(lut[j], wq[j]);
            dk::mma_s8_16832(acc[j], a, b.x, b.y);
          }
        }
      }
    }
  }

  // The warps' partials, [H][M][BN], then the block's, summed in warp order,
  // to the workspace.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = g + 8 * hf;
    if (m >= M) continue;
    Acc* dst = red + (h * M + m) * BN + cw * 8 * C::CPT;
#pragma unroll
    for (int j = 0; j < C::CPT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)  // D fragment column 2t + e of n8 tile j
        dst[KIND == INT8 ? 16 * t + 8 * e + j : 8 * t + 4 * e + j] = acc[j][2 * hf + e];
  }
  finish<C::H>(p, red, last_flag, [&](int m, int n, Acc v) {
    float out;
    if constexpr (KIND == W4A8) {
      const float b = !p.bias      ? 0.f
                      : p.bias_f32 ? static_cast<const float*>(p.bias)[n]
                                   : __bfloat162float(static_cast<const bf16*>(p.bias)[n]);
      out = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(v), p.xscale[m]), p.wscale[n]), b);
    } else {
      out = v;
    }
    if (p.out_f32)
      static_cast<float*>(p.y)[(long long)m * N + n] = out;
    else
      static_cast<bf16*>(p.y)[(long long)m * N + n] = __float2bfloat16(out);
  });
}

__global__ void __launch_bounds__(NTHREADS, 2) int4_gemv(const Params p) { gemv<INT4>(p); }
__global__ void __launch_bounds__(NTHREADS, 2) int8_gemv(const Params p) { gemv<INT8>(p); }
__global__ void __launch_bounds__(NTHREADS, 2) w4a8_gemv(const Params p) { gemv<W4A8>(p); }

template <int KIND>
int launch(void (*kernel)(const Params), Params p, int splits, void* stream) {
  const size_t smem = Cfg<KIND>::bytes;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int* arrivals;
  const cudaError_t ea = cudaGetSymbolAddress(reinterpret_cast<void**>(&arrivals), g_arrivals);
  if (ea != cudaSuccess) return (int)ea;
  p.arrivals = arrivals + KIND * MAX_TILES;
  kernel<<<dim3(splits, p.N / BN), NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// What every GEMV takes: 1 <= M <= 16, N a multiple of 128, S <= 8 splits of
// K, each a multiple of 64 k (8 parts of whole word rows, or 16 of 4-k
// chunks) and of the group.
bool takes(int M, int N, int K, int group, int splits) {
  return M > 0 && M <= MAX_M && N > 0 && N % BN == 0 && N / BN <= MAX_TILES && K > 0 &&
         group > 0 && splits > 0 && splits <= MAX_SPLITS && K % (64 * splits) == 0 &&
         (K / splits) % group == 0;
}

Params params(const void* x, long long lda, const void* qw, const void* scales,
              const void* zeros, void* y, void* partials, int M, int N, int K, int group) {
  Params p = {};
  p.partials = partials;
  p.x = x;
  p.lda = lda;
  p.qw = qw;
  p.scales = static_cast<const float*>(scales);
  p.zeros = static_cast<const float*>(zeros);
  p.y = y;
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = group;
  return p;
}

template <int KIND>
int dequant_entry(const void* x, const void* qw, const void* scales, const void* zeros, void* y,
                  int M, int N, int K, int group, long long lda, int splits, void* partials,
                  bool out_f32, void* stream) {
  if (!takes(M, N, K, group, splits) || !(group == 32 || group % 64 == 0) || lda < K || lda % 8)
    return (int)cudaErrorInvalidValue;
  Params p = params(x, lda, qw, scales, zeros, y, partials, M, N, K, group);
  p.out_f32 = out_f32;
  return launch<KIND>(KIND == INT4 ? int4_gemv : int8_gemv, p, splits, stream);
}

// -- C and #13 on fp32 x at M <= 16 ------------------------------------------
//
// The `ada` projections of an fp32 model (c at M = 1 for FLUX, 2 for SD3
// with CFG): y = x @ W in fp32, W = q * s + z (the product and the sum each
// rounded in fp32, no FMA between them) and not rounded further, the
// products summed in fp32. The grid and the split are the bf16 GEMV's
// (gemv_splits, whole groups a split); the products run on the CUDA cores'
// FMA pipe, against x's rows, which every lane of a warp reads at the same
// address (one L1 broadcast a vector), so no k permutation is needed:
// * a block's 8 warps take 8 consecutive k parts of its slab, a warp all 128
//   columns of the tile, a lane 4 adjacent columns (16 bytes of a packed
//   word row, or 4 bytes of each of 4 byte rows for #13), streamed into a
//   register ring of F32_D chunks with no L1 allocation;
// * each chunk (8 k of C, 4 of #13) is dequantised in registers by the
//   exact 2^23 step of the bf16 GEMV, then each of x's MT rows (M rounded
//   up to 1, 2, 4, 8 or 16; rows past M repeat row M - 1 and are not
//   stored) takes its chunk of x as float4 loads and one FMA a weight, in k
//   order into the lane's fp32 sums (MT > 2 runs one block an SM: C's
//   MT = 4 spilled at the 128 registers of two);
// * the warps' sums go through `finish` in warp order, then the splits' in
//   split order: no float atomics, a repeat is bit for bit.
// Bound: bytes, as the bf16 GEMV's: 35.4 MB at FLUX's dual-block `ada`
// (1 x 3072 x 18432, group 64), 10.6 us at 3.35 TB/s; ~4.4 operations a
// weight at M = 1 (the dequantisation's 3 and 1.4 of nibble extraction, and
// one FMA a row) put the issue rate near it too.

constexpr int F32_CPT = 4, F32_WARPS = NTHREADS / 32, F32_D = 4;
static_assert(32 * F32_CPT == BN, "a warp takes the column tile");

// One chunk's weights of a lane: 4 columns' words of one word row (C), or
// the 4 columns' bytes of each of 4 byte rows (#13), rows `stride` apart.
template <int BITS>
__device__ __forceinline__ uint4 load_chunk_f32(const unsigned char* src, long long stride,
                                                bool valid) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!valid) return r;
  if constexpr (BITS == 4) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(src));
  } else {
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r.x) : "l"(src));
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r.y) : "l"(src + stride));
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
                 : "=r"(r.z) : "l"(src + 2 * stride));
    asm volatile("ld.global.nc.L1::no_allocate.u32 %0, [%1];"
                 : "=r"(r.w) : "l"(src + 3 * stride));
  }
  return r;
}

template <int BITS, int MT>
__global__ void __launch_bounds__(NTHREADS, MT <= 2 ? 2 : 1) dequant_gemv_f32(const Params p) {
  constexpr int KC = BITS == 4 ? 8 : 4;  // k a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [F32_WARPS][M][BN]
  int* last_flag = reinterpret_cast<int*>(smem + (size_t)F32_WARPS * p.M * BN * 4);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int M = p.M, N = p.N, group = p.group;
  const int kslab = p.K / gridDim.x, kp = kslab / F32_WARPS, L = kp / KC;
  const int k0 = blockIdx.x * kslab + warp * kp;  // this warp's k range [k0, k0 + kp)
  const int col = blockIdx.y * BN + F32_CPT * lane;
  const uint32_t magic = 0x4B000000u;  // 2^23: f = magic | q is 2^23 + q

  // A chunk is 4 N bytes on from the last: one word row, or four byte rows.
  const long long rstride = BITS == 4 ? 4LL * N : N;
  const unsigned char* wp = static_cast<const unsigned char*>(p.qw) +
                            (BITS == 4 ? 4 * ((long long)(k0 / 8) * N + col) : (long long)k0 * N + col);
  uint4 ring[F32_D];
#pragma unroll
  for (int i = 0; i < F32_D; ++i) ring[i] = load_chunk_f32<BITS>(wp + i * 4LL * N, rstride, i < L);

  // The group affine, each next group's loaded a group ahead.
  int next = k0;
  const long long aoff = (long long)(k0 / group) * N + col;
  float4 ps = __ldg(reinterpret_cast<const float4*>(p.scales + aoff));
  float4 pz = __ldg(reinterpret_cast<const float4*>(p.zeros + aoff));
  float cs[F32_CPT], cc[F32_CPT], cz[F32_CPT], cs16[F32_CPT], cc16[F32_CPT];

  const float* x = static_cast<const float*>(p.x);
  float acc[MT][F32_CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < F32_CPT; ++j) acc[m][j] = 0.f;

#pragma unroll 1
  for (int r0 = 0; r0 < L; r0 += F32_D) {
#pragma unroll
    for (int i = 0; i < F32_D; ++i) {
      const int r = r0 + i;
      if (r >= L) break;
      const int k = k0 + r * KC;
      const uint4 w = ring[i];
      ring[i] = load_chunk_f32<BITS>(wp + (r + F32_D) * 4LL * N, rstride, r + F32_D < L);
      if (k == next) {  // a group starts: s, -2^23 s and z (s / 16 too for C)
        const float s[4] = {ps.x, ps.y, ps.z, ps.w}, z[4] = {pz.x, pz.y, pz.z, pz.w};
#pragma unroll
        for (int j = 0; j < F32_CPT; ++j) {
          cs[j] = s[j];
          cc[j] = -8388608.f * s[j];
          cz[j] = z[j];
          cs16[j] = 0.0625f * s[j];
          cc16[j] = -8388608.f * cs16[j];
        }
        const int gi = k / group + 1;
        next = gi * group;
        if (next < k0 + kp) {
          ps = __ldg(reinterpret_cast<const float4*>(p.scales + (long long)gi * N + col));
          pz = __ldg(reinterpret_cast<const float4*>(p.zeros + (long long)gi * N + col));
        }
      }
      // The chunk's weights, wv[j][e] at column col + j, k + e.
      float wv[F32_CPT][KC];
      if constexpr (BITS == 4) {
        const uint32_t wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int j = 0; j < F32_CPT; ++j)
#pragma unroll
          for (int b = 0; b < 4; ++b) {  // byte b: nibbles 2b (low) and 2b + 1 (high)
            const uint32_t wb = wq[j] >> (8 * b);
            const float lo = nibble_f<0xFu>(wb, magic);   // 2^23 + q
            const float hi = nibble_f<0xF0u>(wb, magic);  // 2^23 + 16 q
            wv[j][2 * b] = __fadd_rn(__fmaf_rn(lo, cs[j], cc[j]), cz[j]);
            wv[j][2 * b + 1] = __fadd_rn(__fmaf_rn(hi, cs16[j], cc16[j]), cz[j]);
          }
      } else {
        const uint32_t rows[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < KC; ++e)
#pragma unroll
          for (int j = 0; j < F32_CPT; ++j) {
            const float f = __uint_as_float(__byte_perm(rows[e], magic, 0x7440 | j));
            wv[j][e] = __fadd_rn(__fmaf_rn(f, cs[j], cc[j]), cz[j]);
          }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4* xr = reinterpret_cast<const float4*>(x + (long long)min(m, M - 1) * p.lda + k);
        float xv[KC];
#pragma unroll
        for (int v = 0; v < KC / 4; ++v) {
          const float4 t = __ldg(xr + v);
          xv[4 * v] = t.x, xv[4 * v + 1] = t.y, xv[4 * v + 2] = t.z, xv[4 * v + 3] = t.w;
        }
#pragma unroll
        for (int j = 0; j < F32_CPT; ++j)
#pragma unroll
          for (int e = 0; e < KC; ++e) acc[m][j] = __fmaf_rn(xv[e], wv[j][e], acc[m][j]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
    *reinterpret_cast<float4*>(red + (warp * M + m) * BN + F32_CPT * lane) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  finish<F32_WARPS>(p, red, last_flag, [&](int m, int n, float v) {
    static_cast<float*>(p.y)[(long long)m * N + n] = v;
  });
}

template <int BITS, int MT>
int launch_f32(Params p, int splits, void* stream) {
  auto kernel = dequant_gemv_f32<BITS, MT>;
  const size_t smem = (size_t)F32_WARPS * p.M * BN * 4 + 16;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int* arrivals;
  const cudaError_t ea = cudaGetSymbolAddress(reinterpret_cast<void**>(&arrivals), g_arrivals);
  if (ea != cudaSuccess) return (int)ea;
  p.arrivals = arrivals + (BITS == 4 ? INT4_F32 : INT8_F32) * MAX_TILES;
  kernel<<<dim3(splits, p.N / BN), NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <int BITS>
int f32_entry(const void* x, const void* qw, const void* scales, const void* zeros, void* y,
              int M, int N, int K, int group, long long lda, int splits, void* partials,
              void* stream) {
  if (!takes(M, N, K, group, splits) || !(group == 32 || group % 64 == 0) || lda < K || lda % 4)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {x, qw, scales, zeros, static_cast<const void*>(y),
                          static_cast<const void*>(partials)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return (int)cudaErrorInvalidValue;
  const Params p = params(x, lda, qw, scales, zeros, y, partials, M, N, K, group);
  if (M <= 1) return launch_f32<BITS, 1>(p, splits, stream);
  if (M <= 2) return launch_f32<BITS, 2>(p, splits, stream);
  if (M <= 4) return launch_f32<BITS, 4>(p, splits, stream);
  if (M <= 8) return launch_f32<BITS, 8>(p, splits, stream);
  return launch_f32<BITS, 16>(p, splits, stream);
}

// -- #11 at M <= 16: w8 int8 in (N, K), K-contiguous per column ----------------

// Columns a block (W8_BN), a lane (W8_CPT) and a warp (8 W8_CPT), column
// warps (W8_CW) and k parts (W8_H) of a block, k a warp's chunk (W8_KC: 16
// a lane of its 4 lanes t), chunks in flight (W8_D), and the bytes of pad
// past each row of the block's int8 slab of x (its rows 16 banks apart).
constexpr int W8_BN = 64, W8_CPT = 4, W8_CW = W8_BN / (8 * W8_CPT), W8_H = 8 / W8_CW;
constexpr int W8_KC = 64, W8_D = 4;
constexpr int W8_PAD = 64;

struct W8Params {
  const void* x;        // (M, K) rows: int8 x8, or bf16 / fp32 to quantize
  const int8_t* w8;     // (N, K)
  const float* wscale;  // (N,)
  const float* xscale;  // (M,), the int8 entry's
  const void* bias;     // (N,) in the output type, or null
  void* y;              // (M, N)
  int M, N, K;
};

// A lane's weights of one chunk: 16 consecutive k of each of its columns.
struct W8Chunk {
  uint4 v[W8_CPT];
};

// Shared memory of the W8 GEMV: the warps' int32 partials [W8_H][M][W8_BN],
// each warp's absmax of each row [MAX_M][8] (the quantizing entry's), the
// epilogue's wscale and bias of the block's columns and xscale [2 W8_BN +
// MAX_M], and the block's int8 slab of x, [M][K / S + W8_PAD].
size_t w8_smem(int M, int K, int splits) {
  return (size_t)W8_H * M * W8_BN * 4 + MAX_M * 8 * 4 + (2 * W8_BN + MAX_M) * 4 +
         (size_t)M * (K / splits + W8_PAD);
}

// Row m's absmax from its warps' (max is exact in any order).
__device__ __forceinline__ float row_amax(const float* wmax, int m) {
  float a = wmax[8 * m];
#pragma unroll
  for (int i = 1; i < 8; ++i) a = fmaxf(a, wmax[8 * m + i]);
  return a;
}

// Kernel #11 at M <= 16, y = ((x8 @ w8^T) * xs[m]) * ws[n] (+ b[n]). Block
// (split, tile) takes k [split K / S, (split + 1) K / S) of W8_BN columns;
// warp (cw, h) its k part h and 32 columns, lane (g, t) columns cb + j (j <
// 4) at k h kh + 64 r + 16 t .. + 15 of chunk r: one 16-byte load of each
// column's w8 row, two m16n8k32 steps of B fragments (bytes 0-7, 8-15),
// x's A fragment from the same 16 bytes of x rows g and g + 8, so the 4
// lanes t of a column read 64 consecutive bytes of it. The block's slab of
// x8 sits in shared memory, copied there once while the weights' first
// chunks are in flight (not a global load a chunk: each was a round trip
// to L2). With XT a float type, the block instead takes the absmax of each
// of x's rows over all K (four rows' loads in flight together), the scale
// and its reciprocal by dk::row_scale, and quantizes its own slab by
// dk::store_row_i8_rcp: kernel D's x8 and scale bit for bit.
template <typename XT, typename OutT>
__global__ void __launch_bounds__(NTHREADS, 2) w8_gemv(const W8Params p) {
  constexpr bool kQuant = !std::is_same<XT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = p.M, N = p.N, K = p.K;
  int* red = reinterpret_cast<int*>(smem);  // [W8_H][M][W8_BN]
  float* wmax = reinterpret_cast<float*>(smem + (size_t)W8_H * M * W8_BN * 4);
  float* ep = wmax + MAX_M * 8;  // wscale [W8_BN], bias [W8_BN], xscale [MAX_M]
  int8_t* slab = reinterpret_cast<int8_t*>(ep + 2 * W8_BN + MAX_M);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = gridDim.x, tile = blockIdx.y, n0 = tile * W8_BN;
  const int kslab = K / S, kh = kslab / W8_H, L = kh / W8_KC;  // L chunks a lane
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp % W8_CW, h = warp / W8_CW;
  const int kw = h * kh + 16 * t;  // the lane's first k in the block's slab
  const int cb = cw * 8 * W8_CPT + W8_CPT * g;
  const int pitch = kslab + W8_PAD;

  // The lane's weights, a register ring of W8_D chunks in flight.
  const unsigned char* wp = reinterpret_cast<const unsigned char*>(p.w8) +
                            (long long)(n0 + cb) * K + blockIdx.x * kslab + kw;
  W8Chunk ring[W8_D];
#pragma unroll
  for (int i = 0; i < W8_D; ++i)
    ring[i] = load_rows<W8Chunk>(wp + i * W8_KC, K, i < L ? W8_CPT : 0);
  // The epilogue's operands, loaded now and kept in shared memory from the
  // end of the prologue: after the main loop each would be one more round
  // trip to device memory.
  const OutT* bias = static_cast<const OutT*>(p.bias);
  float ws_col = 0.f, b_col = 0.f, xs_row = 0.f;
  if (tid < W8_BN) {
    ws_col = p.wscale[n0 + tid];
    if (bias) b_col = dk::to_float(bias[n0 + tid]);
  }
  if constexpr (!kQuant) {
    if (tid < M) xs_row = p.xscale[tid];
  }

  if constexpr (kQuant) {
    constexpr int V = dk::Vec<XT>::N;
    const XT* x = static_cast<const XT*>(p.x);
    // Where the block's slab is all of x and a thread's share of it is one
    // vector of each of at most 2 rows (S = 1, M <= 2, K / V <= NTHREADS:
    // the paths' GEMVs), the absmax pass keeps its loads for the quantize.
    const bool one_pass = S == 1 && M <= 2 && K / V <= NTHREADS;
    uint4 keep[2];
    for (int m0 = 0; m0 < M; m0 += 4) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = tid; c < K / V; c += NTHREADS) {
        uint4 raw[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (m0 + q < M)
            raw[q] = __ldg(reinterpret_cast<const uint4*>(x + (long long)(m0 + q) * K) + c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (m0 + q >= M) break;
          if (q < 2) keep[q] = raw[q];
          const XT* e = reinterpret_cast<const XT*>(&raw[q]);
#pragma unroll
          for (int k = 0; k < V; ++k) a[q] = fmaxf(a[q], fabsf(dk::to_float(e[k])));
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (m0 + q >= M) break;
        const float w = dk::warp_max(a[q]);
        if (lane == 0) wmax[8 * (m0 + q) + warp] = w;
      }
    }
    __syncthreads();
    const int svec = kslab / V;  // vectors of a row's slab
    if (one_pass) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q >= M || tid >= svec) break;
        const XT* e = reinterpret_cast<const XT*>(&keep[q]);
        float v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = dk::to_float(e[k]);
        const float2 sr = dk::row_scale(row_amax(wmax, q));
        dk::store_row_i8_rcp<V>(slab + q * pitch + tid * V, v, sr.x, sr.y);
      }
    }
    for (int i = one_pass ? M * svec : tid; i < M * svec; i += NTHREADS) {
      const int m = i / svec, c = i - m * svec;
      const uint4 raw = __ldg(
          reinterpret_cast<const uint4*>(x + (long long)m * K + blockIdx.x * kslab) + c);
      const XT* e = reinterpret_cast<const XT*>(&raw);
      float v[V];
#pragma unroll
      for (int k = 0; k < V; ++k) v[k] = dk::to_float(e[k]);
      const float2 sr = dk::row_scale(row_amax(wmax, m));
      dk::store_row_i8_rcp<V>(slab + m * pitch + c * V, v, sr.x, sr.y);
    }
  } else {
    const int8_t* x8 = static_cast<const int8_t*>(p.x) + blockIdx.x * kslab;
    const int svec = kslab / 16;  // 16-byte vectors of a row's slab
    for (int i = tid; i < M * svec; i += NTHREADS) {
      const int m = i / svec, c = i - m * svec;
      *reinterpret_cast<uint4*>(slab + m * pitch + 16 * c) =
          __ldg(reinterpret_cast<const uint4*>(x8 + (long long)m * K) + c);
    }
  }
  if (tid < W8_BN) ep[tid] = ws_col, ep[W8_BN + tid] = b_col;
  if (tid < M) ep[2 * W8_BN + tid] = xs_row;
  __syncthreads();

  const bool va = g < M, vb = g + 8 < M;
  int acc[W8_CPT][4];
#pragma unroll
  for (int j = 0; j < W8_CPT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll 1
  for (int r0 = 0; r0 < L; r0 += W8_D) {
#pragma unroll
    for (int i = 0; i < W8_D; ++i) {
      const int r = r0 + i;
      if (r >= L) break;
      const int k = kw + r * W8_KC;
      uint4 xa = make_uint4(0u, 0u, 0u, 0u), xb = xa;
      if (va) xa = *reinterpret_cast<const uint4*>(slab + g * pitch + k);
      if (vb) xb = *reinterpret_cast<const uint4*>(slab + (g + 8) * pitch + k);
      // Bytes 0-7 of the 16: k positions 4t..4t+3 and 16+4t..16+4t+3 of
      // the first step, bytes 8-15 of the second.
      const uint32_t a0[4] = {xa.x, xb.x, xa.y, xb.y}, a1[4] = {xa.z, xb.z, xa.w, xb.w};
#pragma unroll
      for (int j = 0; j < W8_CPT; ++j) {
        dk::mma_s8_16832(acc[j], a0, ring[i].v[j].x, ring[i].v[j].y);
        dk::mma_s8_16832(acc[j], a1, ring[i].v[j].z, ring[i].v[j].w);
      }
      // The slot's next chunk once its products are issued: a ring of W8_D
      // registers sets, not W8_D + 1 (which spilled at 128 registers).
      ring[i] = load_rows<W8Chunk>(wp + (r + W8_D) * W8_KC, K, r + W8_D < L ? W8_CPT : 0);
    }
  }

  // The warps' partials, [W8_H][M][W8_BN], then the block's, summed in
  // place.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int m = g + 8 * hf;
    if (m >= M) continue;
    int* dst = red + (h * M + m) * W8_BN + cw * 8 * W8_CPT;
#pragma unroll
    for (int j = 0; j < W8_CPT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)  // D fragment column 2t + e of n8 tile j
        dst[8 * t + 4 * e + j] = acc[j][2 * hf + e];
  }
  __syncthreads();
  const int total = M * W8_BN;
  for (int i = tid; i < total; i += NTHREADS) {
    int v = red[i];
#pragma unroll
    for (int q = 1; q < W8_H; ++q) v += red[q * total + i];
    red[i] = v;
  }
  // Row m's output at column n0 + c from its exact int32 sum, each step
  // rounded as the plain version's torch ops.
  auto store = [&](int i, int v) {
    const int m = i / W8_BN, c = i % W8_BN;
    float xs;
    if constexpr (kQuant) {
      xs = dk::row_scale(row_amax(wmax, m)).x;
    } else {
      xs = ep[2 * W8_BN + m];
    }
    float out = __fmul_rn(__fmul_rn(__int2float_rn(v), xs), ep[c]);
    if (bias) out = __fadd_rn(out, ep[W8_BN + c]);
    static_cast<OutT*>(p.y)[(long long)m * N + n0 + c] = dk::from_float<OutT>(out);
  };
  if (S == 1) {  // the block holds all of K
    __syncthreads();
    for (int i = tid; i < total; i += NTHREADS) store(i, red[i]);
    return;
  }
  // The tile's S blocks are one cluster: each sums its share of the
  // outputs over the S blocks' shared memory and applies the epilogue.
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();  // every block's sums are in its shared memory
  const int share = (total + S - 1) / S, i0 = (int)cluster.block_rank() * share;
  for (int i = i0 + tid; i < min(total, i0 + share); i += NTHREADS) {
    int v = 0;
    for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(red, q)[i];
    store(i, v);
  }
  cluster.sync();  // no block leaves while another still reads its sums
}

// The W8 GEMV's launch: grid (S, N / 128), the S blocks of a column tile
// one thread-block cluster (S <= 8, the portable cluster size).
template <typename XT, typename OutT>
int launch_w8(W8Params p, int splits, void* stream) {
  const size_t smem = w8_smem(p.M, p.K, splits);
  auto kernel = w8_gemv<XT, OutT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, p.N / W8_BN);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, p);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <typename XT>
int launch_w8_out(W8Params p, int out_type, int splits, void* stream) {
  return out_type ? launch_w8<XT, float>(p, splits, stream)
                  : launch_w8<XT, bf16>(p, splits, stream);
}

}  // namespace

// Kernel C at M <= 16; the wrapper sends M > 16 to dk_int4_matmul_sm90_bf16
// (int4_matmul_sm90.cu), which takes the same arguments but `splits` and
// `partials`: `splits` blocks along K, fp32 (N / 128, splits, M, 128)
// scratch for their partial sums. y bf16; the _f32out entries write the
// split sums to an fp32 y unrounded (a row-parallel linear's partial).
extern "C" int dk_int4_matmul_bf16(const void* x, const void* q4, const void* scales,
                                   const void* zeros, void* y, int M, int N, int K, int group,
                                   long long lda, int splits, void* partials, void* stream) {
  return dequant_entry<INT4>(x, q4, scales, zeros, y, M, N, K, group, lda, splits, partials,
                             false, stream);
}

extern "C" int dk_int4_matmul_bf16_f32out(const void* x, const void* q4, const void* scales,
                                          const void* zeros, void* y, int M, int N, int K,
                                          int group, long long lda, int splits, void* partials,
                                          void* stream) {
  return dequant_entry<INT4>(x, q4, scales, zeros, y, M, N, K, group, lda, splits, partials,
                             true, stream);
}

// Kernel #13 at M <= 16, as dk_int4_matmul_bf16 with uint8 (K, N) weights.
extern "C" int dk_int8_matmul_bf16(const void* x, const void* q8, const void* scales,
                                   const void* zeros, void* y, int M, int N, int K, int group,
                                   long long lda, int splits, void* partials, void* stream) {
  return dequant_entry<INT8>(x, q8, scales, zeros, y, M, N, K, group, lda, splits, partials,
                             false, stream);
}

extern "C" int dk_int8_matmul_bf16_f32out(const void* x, const void* q8, const void* scales,
                                          const void* zeros, void* y, int M, int N, int K,
                                          int group, long long lda, int splits, void* partials,
                                          void* stream) {
  return dequant_entry<INT8>(x, q8, scales, zeros, y, M, N, K, group, lda, splits, partials,
                             true, stream);
}

// Kernels C and #13 on fp32 x at M <= 16; the wrapper sends M > 16 to
// dk_int{4,8}_matmul_sm90_f32 (dequant_f32.cu). x fp32 (M, K) rows lda
// apart (a multiple of 4), y fp32 (M, N), the fp32 partials workspace as
// C's; every pointer 16-byte aligned.
extern "C" int dk_int4_matmul_f32(const void* x, const void* q4, const void* scales,
                                  const void* zeros, void* y, int M, int N, int K, int group,
                                  long long lda, int splits, void* partials, void* stream) {
  return f32_entry<4>(x, q4, scales, zeros, y, M, N, K, group, lda, splits, partials, stream);
}

extern "C" int dk_int8_matmul_f32(const void* x, const void* q8, const void* scales,
                                  const void* zeros, void* y, int M, int N, int K, int group,
                                  long long lda, int splits, void* partials, void* stream) {
  return f32_entry<8>(x, q8, scales, zeros, y, M, N, K, group, lda, splits, partials, stream);
}

// Kernel E in mode plain at M <= 16; the wrapper sends every other call to
// dk_w4a8_matmul_sm90 (w4a8_matmul_sm90.cu). x8 int8 (M, K) rows lda apart;
// wscale (N,), xscale (M,), bias (N,) bf16 (fp32 with bias_f32) or null; y
// bf16 (fp32 with out_f32); int32 partials as C's.
extern "C" int dk_w4a8_matmul(const void* x8, const void* q4, const void* scales,
                              const void* zeros, const void* wscale, const void* xscale,
                              const void* bias, int bias_f32, void* y, int out_f32, int M,
                              int N, int K, int group, long long lda, int splits,
                              void* partials, void* stream) {
  if (!takes(M, N, K, group, splits) || K % 128 ||
      !(group == 32 || group == 64 || group % 128 == 0) || lda < K || lda % 16)
    return (int)cudaErrorInvalidValue;
  Params p = params(x8, lda, q4, scales, zeros, y, partials, M, N, K, group);
  p.wscale = static_cast<const float*>(wscale);
  p.xscale = static_cast<const float*>(xscale);
  p.bias = bias;
  p.bias_f32 = bias_f32 != 0;
  p.out_f32 = out_f32 != 0;
  return launch<W4A8>(w4a8_gemv, p, splits, stream);
}

// Kernel #11 at M <= 16 (the wrapper routes M > 16 and the other shapes to
// dk_w8_matmul_bf16 / _f32, w8_matmul.cu): x (M, K) contiguous, x_type 0
// int8 x8 with fp32 xscale (M,), 1 bf16 or 2 fp32 rows quantized in the
// kernel (xscale unused); w8 int8 (N, K); wscale fp32 (N,); bias (N,) in
// the output type or null; y (M, N), out_type 0 bf16 or 1 fp32; S splits
// of K (a cluster of S blocks a column tile), each a multiple of 128 k.
extern "C" int dk_w8_gemv(const void* x, int x_type, const void* w8, const void* wscale,
                          const void* xscale, const void* bias, void* y, int out_type, int M,
                          int N, int K, int splits, void* stream) {
  if (!(M > 0 && M <= MAX_M && N > 0 && N % W8_BN == 0 && N / W8_BN <= MAX_TILES && K > 0 &&
        splits > 0 && splits <= MAX_SPLITS && K % (W8_H * W8_KC * splits) == 0) ||
      x_type < 0 || x_type > 2 || out_type < 0 || out_type > 1 ||
      w8_smem(M, K, splits) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  W8Params p = {};
  p.x = x;
  p.w8 = static_cast<const int8_t*>(w8);
  p.wscale = static_cast<const float*>(wscale);
  p.xscale = static_cast<const float*>(xscale);
  p.bias = bias;
  p.y = y;
  p.M = M;
  p.N = N;
  p.K = K;
  if (x_type == 1) return launch_w8_out<bf16>(p, out_type, splits, stream);
  if (x_type == 2) return launch_w8_out<float>(p, out_type, splits, stream);
  return launch_w8_out<int8_t>(p, out_type, splits, stream);
}
