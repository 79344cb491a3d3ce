// Kernel #11: the w8a8 linear, y = ((x8 @ w8^T) * xscale) * wscale + bias;
// kernel #16: the bare int8 product, y = x8 @ w8^T in int32; kernel #10:
// the int8 weight grid of a packed int4 layer.
//
// #11 replaces the Pallas kernel diffusionkit_tpu/ops/w4a8_matmul.py:
// w8_matmul (_kernel_w8), which computes exactly the reference's w8a8 linear
// (diffusionkit_tpu/ops/w8a8.py:w8a8_linear, an XLA int8 dot_general and
// an fp32 epilogue in this order). x8 is int8 (M, K) with per-row scales
// (M,); w8 is int8 (N, K), torch's (out, in) layout, with per-channel
// scales (N,); bias (N,) in the output dtype, or null. acc is the exact
// int32 product; the epilogue is __fmul_rn(__fmul_rn(float(acc), xs), ws),
// then __fadd_rn(., bias), each step rounded as the plain version's
// separate torch ops are, then one rounding to the output dtype.
//
// #16 replaces tools/microbench_pallas_int8.py:pallas_int8_matmul: #11's
// main loop with an epilogue that stores the int32 accumulators. Any M >= 1
// by predication (the reference pads M to its block); K and N as #11.
//
// Bound on the H100: at M >= 256 (SD3's 2048 image rows, 308 text rows,
// T5-XXL's 256 tokens) int8 tensor-core work: (2048, 1536, 6144) is 38.7
// GOP, 0.0195 ms at 1,979 TOP/s. The int32 accumulator stays in registers
// through the epilogue, so the (M, N) int32 never reaches device memory
// (the round trip an int32 GEMM followed by a rescale pass pays). At M = 2
// (the AdaLN `ada` and embedder GEMVs) it is bound by reading w8: one byte a
// weight, 14 MB for a 1536 x 9216 `ada`. #16 at the microbench's (4352,
// 3072, 12288): 329 GOP, 0.166 ms, above the 214 MB of int32 it writes
// (0.064 ms).
//
// Main loops, by shape (`dispatch`):
//  * M > 16: w8_matmul_sm90.cu (TMA, int8 wgmma; its own note): at K %
//    128 == 0, every main-path shape but the GEMVs and the SD3 x_embedder,
//    the warp-specialised `w8_mm_sm90`; at K % 128 == 64 (the x_embedder's
//    K = 64) `w8_mm_sm90_k64`, 64-deep k stages and the output tile stored
//    from shared memory.
//  * #11 at M <= 16 with K and N multiples of 128 (the `ada` and embedder
//    GEMVs): the wrapper sends them to gemv_sm90.cu's split-K `w8_gemv`
//    instead, and the calls whose x is float there too, quantized in it.
//  * M <= 16 otherwise (#16, and #11's other shapes): `w8_mm` here, kernel
//    E's old `plain` main loop without the requantisation. 256 threads (8
//    warps), warp tiles of 16 x 16; BK = 128 k per tile (64 where K is not
//    a multiple of 128). cp.async stages the x8 and w8 tiles (16-byte
//    chunks; rows past M and N zero-filled, so no padded copies) into a
//    double buffer of [row][k] tiles padded to BK + 16 bytes, bank-conflict
//    free for ldmatrix, which gives the m16n8k32 s8 fragments of both
//    operands directly (both are k-contiguous). The ragged N edge is masked
//    at the store. The tile reads w8 once at about half the memory rate (L2
//    warm); the wgmma kernel's 64-row products would waste 3/4 of their
//    work there.
//
// #10 replaces diffusionkit_tpu/ops/w4a8_matmul.py:dequant_w8_pallas: packed
// int4 words (K/8, N) (int32 bit views, shifted as unsigned) and the group
// affine already divided by wscale, s8 and z8 fp32 (K/g, N), to the int8
// grid clip(rne(q * s8 + z8), -127, 127), written as (N, K), the layout #11,
// #16 and torch._int_mm(x8, w8.t()) read. The grid is kernel E's in-tile
// requantisation bit for bit: its table (common.cuh requant_lut, the 16
// values requant_nibble gives q = 0..15, __fmul_rn then __fadd_rn; nvcc's
// default -fmad=true would contract a plain q * s8 + z8 into one FMA and
// round ties differently), or requant_word and requant_nibble themselves.
// The FLUX w4a8 path runs it before #11 on every plain linear of more than
// 16 rows (ops/w4a8_matmul.py w4a8_route), as the reference's tool
// materialises it.
// Bound by its bytes: at FLUX fc1 (K, N, g) = (3072, 12288, 64) it reads
// 18.9 MB of words and 4.7 MB of s8/z8 and writes 37.7 MB, 0.018 ms at 3.35
// TB/s; about 3 instructions a grid byte by table, a fifth of that time at
// the card's issue rate. So the design keeps the memory busy both ways:
//  * a block of 128 threads takes 256 k x 128 columns: a warp 8 word rows
//    (one 64-k slot), a lane 4 columns, so each word load is 16 bytes and
//    a warp's 512 contiguous; the slot's s8 and z8 (one 16-byte load each
//    per group and 4 columns: once per (group, column) at a group of 64 or
//    more), then all 8 of a lane's word loads, are issued before the first
//    requantisation. 32 KB of shared memory and ~20 KB of loads in
//    flight a block, several blocks an SM;
//  * a group's 16 grid values are computed once per lane and column
//    (requant_lut), each word then looked up (lut_word); groups of 32 take
//    two tables a slot, other groups requant_word (and requant_nibble where
//    a group straddles a word) with the affine read per word;
//  * the tile goes through shared memory, [n][k] with an XOR swizzle of its
//    16-byte chunks, and leaves as whole 256-byte row segments, 16 lanes a
//    segment, in 16-byte stores (8-byte where K % 16 == 8), a column of
//    the lanes' 4 at a time, so the stores start after a quarter of the
//    requantisation (at 3072², one wave of 288 blocks, the loads, tables
//    and stores would otherwise run in series).
// Any group that divides K; K and N multiples of 8.

#include <type_traits>

#include "common.cuh"

// #11 and #16 at M > 16: csrc/w8_matmul_sm90.cu.
int dk_w8_mm_sm90(int out_type, const void* x8, const void* w8, const void* wscale,
                  const void* xscale, const void* bias, void* y, int M, int N, int K,
                  cudaStream_t st);

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;

template <int BK, int BM, int BN>
constexpr size_t smem_bytes() {
  return 2 * (size_t)(BM + BN) * (BK + 16);
}

template <typename OutT, int BK, int WARPS_M, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS, MT * NT <= 16 ? 2 : 1)
    w8_mm(const int8_t* __restrict__ x8, const int8_t* __restrict__ w8,
          const float* __restrict__ wscale, const float* __restrict__ xscale,
          const OutT* __restrict__ bias, OutT* __restrict__ y, int M, int N, int K) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int BN = WARPS_N * NT * 8;
  constexpr int LD = BK + 16;  // padded shared rows (bytes)
  constexpr int CH = BK / 16;  // 16-byte chunks per tile row
  constexpr bool kInt32 = std::is_same<OutT, int>::value;  // #16
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);  // [2][BM][LD]
  int8_t* Bs = As + 2 * BM * LD;                  // [2][BN][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = K / BK;

  auto load_stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * CH; c += NTHREADS) {
      const int r = c / CH, col = (c % CH) * 16;
      const int row = m0 + r;
      dk::cp_async16(&As[(buf * BM + r) * LD + col],
                     x8 + (long long)(row < M ? row : 0) * K + k0 + col, row < M ? 16 : 0);
    }
    for (int c = tid; c < BN * CH; c += NTHREADS) {
      const int r = c / CH, col = (c % CH) * 16;
      const int n = n0 + r;
      dk::cp_async16(&Bs[(buf * BN + r) * LD + col],
                     w8 + (long long)(n < N ? n : 0) * K + k0 + col, n < N ? 16 : 0);
    }
    dk::cp_async_commit();
  };

  int acc[MT][NT][4] = {};
  load_stage(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {
      load_stage(kt + 1, buf ^ 1);  // the buffer's last readers finished (sync below)
      dk::cp_async_wait<1>();
    } else {
      dk::cp_async_wait<0>();
    }
    __syncthreads();

    const int8_t* Ab = As + buf * BM * LD;
    const int8_t* Bb = Bs + buf * BN * LD;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        dk::ldmatrix_x4(a[mt], &Ab[(wm * MT * 16 + mt * 16 + (lane & 15)) * LD + ks * 32 +
                                   (lane >> 4) * 16]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        dk::ldmatrix_x4(b, &Bb[(wn * NT * 8 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                              ks * 32 + ((lane >> 3) & 1) * 16]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          dk::mma_s8_16832(acc[mt][2 * np], a[mt], b[0], b[1]);
          dk::mma_s8_16832(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // As[buf] and Bs[buf] are free for the next load
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * MT * 16 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      if constexpr (kInt32) {  // #16: the accumulators as they are
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = n0 + wn * NT * 8 + nt * 8 + 2 * t;  // N % 8 == 0: col + 1 < N too
          if (col < N)
            *reinterpret_cast<int2*>(y + (long long)row * N + col) =
                make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      } else {
        const float xs = xscale[row];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = n0 + wn * NT * 8 + nt * 8 + 2 * t;  // N % 8 == 0: col + 1 < N too
          if (col >= N) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), xs),
                             wscale[col + e]);
            if (bias) v[e] = __fadd_rn(v[e], dk::to_float(bias[col + e]));
          }
          dk::store2<OutT>(y + (long long)row * N + col, v[0], v[1]);
        }
      }
    }
}

template <typename OutT, int BK, int WARPS_M, int MT, int NT>
int launch(const void* x8, const void* w8, const void* wscale, const void* xscale,
           const void* bias, void* y, int M, int N, int K, cudaStream_t st) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = WARPS_M * MT * 16, BN = WARPS_N * NT * 8;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<BK, BM, BN>();
  auto kernel = w8_mm<OutT, BK, WARPS_M, MT, NT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, NTHREADS, smem, st>>>(
      static_cast<const int8_t*>(x8), static_cast<const int8_t*>(w8),
      static_cast<const float*>(wscale), static_cast<const float*>(xscale),
      static_cast<const OutT*>(bias), static_cast<OutT*>(y), M, N, K);
  return (int)cudaGetLastError();
}

// The Hopper main loops' output type code (w8_matmul_sm90.cu).
template <typename OutT>
constexpr int sm90_out_type() {
  return std::is_same<OutT, bf16>::value ? 0 : std::is_same<OutT, float>::value ? 1 : 2;
}

template <typename OutT>
int dispatch(const void* x8, const void* w8, const void* wscale, const void* xscale,
             const void* bias, void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M > 16)
    return dk_w8_mm_sm90(sm90_out_type<OutT>(), x8, w8, wscale, xscale, bias, y, M, N, K, st);
  if (K % 128 == 0)
    return launch<OutT, 128, 1, 1, 2>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
  return launch<OutT, 64, 1, 1, 2>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
}

// #10: a block of DQ_THREADS threads takes DQ_KW word rows (8 * DQ_KW k)
// x DQ_N columns; warp w the slot of 8 word rows (64 k) at 8w, lane l the 4
// columns at 4l, one column c at a time. The requantised tile is staged in
// shared memory as [n][k], 8 * DQ_KW bytes a row in 16-byte chunks, chunk
// ch of row r at ch ^ ((r / 4) % 8): a lane's 16-byte stores (rows 4l + c)
// and a quarter-warp's 16-byte reads (8 chunks of one row) then each meet
// 8 distinct bank groups. Column c's 32 rows leave while column c + 1 is
// requantised.
constexpr int DQ_THREADS = 128, DQ_SLOT = 8;     // word rows a warp
constexpr int DQ_KW = DQ_THREADS / 32 * DQ_SLOT;  // 32 word rows: 256 k
constexpr int DQ_N = 4 * 32;                      // 128 columns
constexpr int DQ_CHUNKS = 8 * DQ_KW / 16;         // 16-byte chunks of a grid row

// How the group affine falls on a slot's word rows: one group (the group a
// multiple of the slot's 8 * DQ_SLOT k), two (half of it), or looked up word
// by word, nibble by nibble where a group straddles a word (any other group
// that divides K).
enum DqGroups { kDqOneGroup, kDqTwoGroups, kDqAnyGroup };

// `wscale` null: s8 and z8 are the affine on the int8 grid. Else they are
// the layer's group scales and zeros, put on the grid here as
// scaled_affine does it: s * (1 / wscale), the reciprocal and the product
// each correctly rounded (x * 1 is x, so one code path serves both).
template <int G>
__global__ void __launch_bounds__(DQ_THREADS)
    dequant_w8_kernel(const uint32_t* __restrict__ q4, const float* __restrict__ s8,
                      const float* __restrict__ z8, const float* __restrict__ wscale,
                      int8_t* __restrict__ w8, int N, int K, int group) {
  __shared__ uint4 tile[DQ_N * DQ_CHUNKS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int KW = K / 8;
  const int kwt = blockIdx.y * DQ_KW;  // the tile's first word row
  const int kw0 = kwt + DQ_SLOT * warp;
  const int n0 = blockIdx.x * DQ_N, n = n0 + 4 * lane;
  const bool live = n < N && kw0 < KW;  // N % 8 == 0: the 4 columns are whole

  // Every load first: the affine of the slot's groups (its tables can be
  // built while the words arrive), then the slot's 8 words of 4 columns
  // (16 bytes a row, a warp 512 contiguous bytes).
  constexpr int NG = G == kDqOneGroup ? 1 : 2;
  float4 s[NG], z[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int kw = kw0 + DQ_SLOT / 2 * i;  // kDqTwoGroups: the slot's halves
    const bool on = G != kDqAnyGroup && live && kw < KW;
    const long long at = on ? (long long)(8 * kw / group) * N + n : 0;
    s[i] = on ? __ldg(reinterpret_cast<const float4*>(s8 + at)) : make_float4(0, 0, 0, 0);
    z[i] = on ? __ldg(reinterpret_cast<const float4*>(z8 + at)) : make_float4(0, 0, 0, 0);
  }
  const float4 ws = wscale != nullptr && live ? __ldg(reinterpret_cast<const float4*>(wscale + n))
                                              : make_float4(1.f, 1.f, 1.f, 1.f);
  uint4 w[DQ_SLOT];
#pragma unroll
  for (int j = 0; j < DQ_SLOT; ++j)
    w[j] = live && kw0 + j < KW
               ? __ldg(reinterpret_cast<const uint4*>(q4 + (long long)(kw0 + j) * N + n))
               : make_uint4(0u, 0u, 0u, 0u);

  const int bytes = min(8 * DQ_KW, 8 * (KW - kwt));  // of each grid row in the tile
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint2 b[DQ_SLOT];  // column n + c's 8 words: 64 bytes of grid row n + c
    const float rw = wscale != nullptr ? __fdiv_rn(1.f, (&ws.x)[c]) : 1.f;
    if constexpr (G == kDqAnyGroup) {
#pragma unroll
      for (int j = 0; j < DQ_SLOT; ++j) {
        const int k = 8 * (kw0 + j);
        const uint32_t wj = (&w[j].x)[c];
        b[j] = make_uint2(0u, 0u);
        if (!live || kw0 + j >= KW) continue;
        if (k / group == (k + 7) / group) {  // one group: kernel E's requant_word
          const long long at = (long long)(k / group) * N + n + c;
          b[j] = dk::requant_word(wj, __fmul_rn(s8[at], rw), __fmul_rn(z8[at], rw));
        } else {
          uint32_t v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const long long at = (long long)((k + e) / group) * N + n + c;
            v[e] = dk::requant_nibble(wj, e, __fmul_rn(s8[at], rw), __fmul_rn(z8[at], rw));
          }
          b[j] = make_uint2(dk::pack_i8x4(v[0], v[1], v[2], v[3]),
                            dk::pack_i8x4(v[4], v[5], v[6], v[7]));
        }
      }
    } else {
      // The group's 16 grid values once (requant_lut: requant_nibble's
      // bytes), then each word by table.
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const uint4 t =
            dk::requant_lut(__fmul_rn((&s[i].x)[c], rw), __fmul_rn((&z[i].x)[c], rw));
#pragma unroll
        for (int j = i * DQ_SLOT / NG; j < (i + 1) * DQ_SLOT / NG; ++j)
          b[j] = dk::lut_word(t, (&w[j].x)[c]);
      }
    }
    const int r = 4 * lane + c;
#pragma unroll
    for (int h = 0; h < DQ_SLOT / 2; ++h)
      tile[r * DQ_CHUNKS + ((DQ_SLOT / 2 * warp + h) ^ (lane & 7))] =
          make_uint4(b[2 * h].x, b[2 * h].y, b[2 * h + 1].x, b[2 * h + 1].y);
    __syncthreads();

    // Column c's grid rows (4l + c) out while the next column is
    // requantised: 16 lanes a row segment of 8 * DQ_KW contiguous bytes
    // (16-byte stores; 8-byte where K % 16 == 8), the ragged edges masked.
#pragma unroll
    for (int it = 0; it < 32 * DQ_CHUNKS / DQ_THREADS; ++it) {
      const int idx = it * DQ_THREADS + threadIdx.x;
      const int l = idx / DQ_CHUNKS, ch = idx % DQ_CHUNKS, rr = 4 * l + c;
      if (n0 + rr >= N || 16 * ch >= bytes) continue;
      const uint4 v = tile[rr * DQ_CHUNKS + (ch ^ (l & 7))];
      int8_t* dst = w8 + (long long)(n0 + rr) * K + 8 * kwt + 16 * ch;
      if ((K & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
        if (16 * ch + 8 < bytes) *reinterpret_cast<uint2*>(dst + 8) = make_uint2(v.z, v.w);
      }
    }
  }
}

template <int G>
int launch_dequant(const void* q4, const void* s8, const void* z8, const void* wscale, void* w8,
                   int K, int N, int group, cudaStream_t st) {
  const dim3 grid((N + DQ_N - 1) / DQ_N, (K / 8 + DQ_KW - 1) / DQ_KW);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dequant_w8_kernel<G><<<grid, DQ_THREADS, 0, st>>>(
      static_cast<const uint32_t*>(q4), static_cast<const float*>(s8),
      static_cast<const float*>(z8), static_cast<const float*>(wscale),
      static_cast<int8_t*>(w8), N, K, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dk_w8_matmul_bf16(const void* x8, const void* w8, const void* wscale,
                                 const void* xscale, const void* bias, void* y, int M, int N,
                                 int K, void* stream) {
  return dispatch<bf16>(x8, w8, wscale, xscale, bias, y, M, N, K, stream);
}

extern "C" int dk_w8_matmul_f32(const void* x8, const void* w8, const void* wscale,
                                const void* xscale, const void* bias, void* y, int M, int N,
                                int K, void* stream) {
  return dispatch<float>(x8, w8, wscale, xscale, bias, y, M, N, K, stream);
}

// #16: y (M, N) int32 = x8 (M, K) int8 @ w8 (N, K)^T; K % 64 == 0, N % 8 == 0.
extern "C" int dk_int8_dot(const void* x8, const void* w8, void* y, int M, int N, int K,
                           void* stream) {
  return dispatch<int>(x8, w8, nullptr, nullptr, nullptr, y, M, N, K, stream);
}

// #10: q4 (K/8, N) words, s8/z8 (K/g, N) fp32 -> w8 (N, K) int8; with
// wscale (N,) not null, s8/z8 are the layer's scales and zeros, divided by
// wscale here. g divides K, K % 8 == 0, N % 8 == 0, every pointer 16-byte
// aligned.
extern "C" int dk_dequant_w8(const void* q4, const void* s8, const void* z8, const void* wscale,
                             void* w8, int K, int N, int group, void* stream) {
  if (K <= 0 || N <= 0 || K % 8 || N % 8 || group <= 0 || K % group)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group % (8 * DQ_SLOT) == 0)
    return launch_dequant<kDqOneGroup>(q4, s8, z8, wscale, w8, K, N, group, st);
  if (group == 4 * DQ_SLOT)
    return launch_dequant<kDqTwoGroups>(q4, s8, z8, wscale, w8, K, N, group, st);
  return launch_dequant<kDqAnyGroup>(q4, s8, z8, wscale, w8, K, N, group, st);
}
