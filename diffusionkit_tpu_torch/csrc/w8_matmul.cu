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
//  * M > 16 and K % 128 == 0, every main-path shape but the GEMVs and the
//    SD3 x_embedder: w8_matmul_sm90.cu's `w8_mm_sm90` (TMA, int8 wgmma,
//    warp-specialised; its own note).
//  * #11 at M <= 16 with K and N multiples of 128 (the `ada` and embedder
//    GEMVs): the wrapper sends them to gemv_sm90.cu's split-K `w8_gemv`
//    instead, and the calls whose x is float there too, quantized in it.
//  * M <= 16 (#16, and #11's other shapes) and K % 128 != 0 (the
//    x_embedder's K = 64): `w8_mm` here, kernel E's `plain` main loop
//    without the requantisation. 256 threads (8 warps), warp tiles of 16 x 16 (M <= 16:
//    BM = 16), 16 x 64 (BM = 64) or 32 x 64 (BM = BN = 128); BK = 128 k per
//    tile (64 where K is not a multiple of 128). cp.async stages the x8 and
//    w8 tiles (16-byte chunks; rows past M and N zero-filled, so no padded
//    copies) into a double buffer of [row][k] tiles padded to BK + 16
//    bytes, bank-conflict free for ldmatrix, which gives the m16n8k32 s8
//    fragments of both operands directly (both are k-contiguous). The
//    ragged M and N edges are masked at the store. At M <= 16 the tile
//    reads w8 once at about half the memory rate (L2 warm); the wgmma
//    kernel's 64-row products would waste 3/4 of their work there.
//
// #10 replaces diffusionkit_tpu/ops/w4a8_matmul.py:dequant_w8_pallas: packed
// int4 words (K/8, N) (int32 bit views, shifted as unsigned) and the group
// affine already divided by wscale, s8 and z8 fp32 (K/g, N), to the int8
// grid clip(rne(q * s8 + z8), -127, 127), written as (N, K), the layout #11,
// #16 and torch._int_mm(x8, w8.t()) read. The grid is kernel E's in-tile
// requantisation bit for bit: the same device function (common.cuh
// requant_word, __fmul_rn then __fadd_rn; nvcc's default -fmad=true would
// contract a plain q * s8 + z8 into one FMA and round ties differently).
// Memory-bound: at FLUX fc1 (K, N, g) = (3072, 12288, 64) it reads 18.9 MB
// of words and 4.7 MB of s8/z8 and writes 37.7 MB, 0.018 ms at 3.35 TB/s.
// A block takes 16 word rows (128 k) x 64 columns: words are read along N
// (two 64-byte rows a warp), requantised into a shared [n][k] tile (144-byte
// rows, lanes alternating between two word rows as in kernel E, so the
// 8-byte stores are conflict free), then written along K, 16 lanes to one
// 128-byte row segment. Any group that divides K (a word straddling two
// groups is requantised nibble by nibble); K % 8 == 0.

#include <type_traits>

#include "common.cuh"

// #11 and #16 at M > 16, K % 128 == 0: csrc/w8_matmul_sm90.cu.
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

template <typename OutT, int BK>
int dispatch_m(const void* x8, const void* w8, const void* wscale, const void* xscale,
               const void* bias, void* y, int M, int N, int K, cudaStream_t st) {
  if (M <= 16) return launch<OutT, BK, 1, 1, 2>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
  if (M <= 512) return launch<OutT, BK, 4, 1, 8>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
  return launch<OutT, BK, 4, 2, 8>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
}

// The Hopper main loop's output type code (w8_matmul_sm90.cu).
template <typename OutT>
constexpr int sm90_out_type() {
  return std::is_same<OutT, bf16>::value ? 0 : std::is_same<OutT, float>::value ? 1 : 2;
}

template <typename OutT>
int dispatch(const void* x8, const void* w8, const void* wscale, const void* xscale,
             const void* bias, void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 128 == 0) {
    if (M <= 16) return launch<OutT, 128, 1, 1, 2>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
    return dk_w8_mm_sm90(sm90_out_type<OutT>(), x8, w8, wscale, xscale, bias, y, M, N, K, st);
  }
  return dispatch_m<OutT, 64>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
}

// #10: a tile of DQ_KW word rows (8 * DQ_KW k) x DQ_N columns.
constexpr int DQ_KW = 16, DQ_N = 64;
constexpr int DQ_LD = 8 * DQ_KW + 16;  // padded shared [n][k] rows (bytes)

__global__ void __launch_bounds__(NTHREADS)
    dequant_w8_kernel(const uint32_t* __restrict__ q4, const float* __restrict__ s8,
                      const float* __restrict__ z8, int8_t* __restrict__ w8, int N, int K,
                      int group) {
  static_assert(DQ_KW == 2 * (NTHREADS / 32), "8 warps x 2 word rows");
  __shared__ __align__(16) int8_t tile[DQ_N * DQ_LD];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kw0 = blockIdx.y * DQ_KW, n0 = blockIdx.x * DQ_N;
  const int KW = K / 8;
  const int r = 2 * warp + (lane & 1);  // this lane's word row in the tile
  const int kw = kw0 + r;
#pragma unroll
  for (int c = lane >> 1; c < DQ_N; c += 16) {
    const int n = n0 + c;
    uint2 bytes = make_uint2(0u, 0u);
    if (kw < KW && n < N) {
      const uint32_t w = q4[(long long)kw * N + n];
      const int k = 8 * kw;
      if (k / group == (k + 7) / group) {  // one group: kernel E's requant_word
        const long long s = (long long)(k / group) * N + n;
        bytes = dk::requant_word(w, s8[s], z8[s]);
      } else {
        uint32_t b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const long long s = (long long)((k + j) / group) * N + n;
          b[j] = dk::requant_nibble(w, j, s8[s], z8[s]);
        }
        bytes = make_uint2(dk::pack_i8x4(b[0], b[1], b[2], b[3]),
                           dk::pack_i8x4(b[4], b[5], b[6], b[7]));
      }
    }
    *reinterpret_cast<uint2*>(&tile[c * DQ_LD + 8 * r]) = bytes;
  }
  __syncthreads();
  const int chunks = min(DQ_KW, KW - kw0);  // valid 8-byte chunks of each row
  for (int c = tid; c < DQ_N * DQ_KW; c += NTHREADS) {
    const int row = c / DQ_KW, ch = c % DQ_KW;
    const int n = n0 + row;
    if (n < N && ch < chunks)
      *reinterpret_cast<uint2*>(w8 + (long long)n * K + 8 * (kw0 + ch)) =
          *reinterpret_cast<const uint2*>(&tile[row * DQ_LD + 8 * ch]);
  }
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

// #10: q4 (K/8, N) words, s8/z8 (K/g, N) fp32 -> w8 (N, K) int8;
// g divides K, K % 8 == 0.
extern "C" int dk_dequant_w8(const void* q4, const void* s8, const void* z8, void* w8, int K,
                             int N, int group, void* stream) {
  if (K <= 0 || N <= 0 || K % 8 || group <= 0 || K % group) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + DQ_N - 1) / DQ_N, (K / 8 + DQ_KW - 1) / DQ_KW);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  dequant_w8_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q4), static_cast<const float*>(s8),
      static_cast<const float*>(z8), static_cast<int8_t*>(w8), N, K, group);
  return (int)cudaGetLastError();
}
