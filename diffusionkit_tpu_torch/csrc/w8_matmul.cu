// Kernel #11: the w8a8 linear, y = ((x8 @ w8^T) * xscale) * wscale + bias.
//
// Replaces the Pallas kernel diffusionkit_tpu/ops/w4a8_matmul.py:w8_matmul
// (_kernel_w8), which computes exactly the reference's w8a8 linear
// (diffusionkit_tpu/ops/w8a8.py:w8a8_linear, an XLA int8 dot_general and
// an fp32 epilogue in this order). x8 is int8 (M, K) with per-row scales
// (M,); w8 is int8 (N, K), torch's (out, in) layout, with per-channel
// scales (N,); bias (N,) in the output dtype, or null. acc is the exact
// int32 product; the epilogue is __fmul_rn(__fmul_rn(float(acc), xs), ws),
// then __fadd_rn(., bias), each step rounded as the plain version's
// separate torch ops are, then one rounding to the output dtype.
//
// Bound on the H100: at M >= 256 (SD3's 2048 image rows, 308 text rows,
// T5-XXL's 256 tokens) int8 tensor-core work: (2048, 1536, 6144) is 38.7
// GOP, 0.0195 ms at 1,979 TOP/s. The int32 accumulator stays in registers
// through the epilogue, so the (M, N) int32 never reaches device memory
// (the round trip an int32 GEMM followed by a rescale pass pays). At M = 2
// (the AdaLN `ada` and embedder GEMVs) it is bound by reading w8: one byte a
// weight, 14 MB for a 1536 x 9216 `ada`.
//
// Tiling: kernel E's `plain` main loop without the requantisation. 256
// threads (8 warps), warp tiles of 32 x 64 (BM = BN = 128), 16 x 64 (BM =
// 64) or 16 x 16 (M <= 16: BM = 16); BK = 128 k per tile (64 where K is not
// a multiple of 128: the SD3 x_embedder's K = 64). cp.async stages the x8
// and w8 tiles (16-byte chunks; rows past M and N zero-filled, so no padded
// copies) into a double buffer of [row][k] tiles padded to BK + 16 bytes,
// bank-conflict free for ldmatrix, which gives the m16n8k32 s8 fragments
// of both operands directly (both are k-contiguous). The ragged M and N
// edges are masked at the store. wgmma, TMA and deeper pipelines come later.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 256;

template <typename OutT>
__device__ __forceinline__ void store2(OutT* dst, float v0, float v1);
template <>
__device__ __forceinline__ void store2<bf16>(bf16* dst, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(dst) = dk::pack_bf16(v0, v1);
}
template <>
__device__ __forceinline__ void store2<float>(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

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
      const float xs = xscale[row];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn * NT * 8 + nt * 8 + 2 * t;  // N % 8 == 0: col + 1 < N too
        if (col >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), xs), wscale[col + e]);
          if (bias) v[e] = __fadd_rn(v[e], dk::to_float(bias[col + e]));
        }
        store2<OutT>(y + (long long)row * N + col, v[0], v[1]);
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

template <typename OutT>
int dispatch(const void* x8, const void* w8, const void* wscale, const void* xscale,
             const void* bias, void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || K <= 0 || K % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 128 == 0) return dispatch_m<OutT, 128>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
  return dispatch_m<OutT, 64>(x8, w8, wscale, xscale, bias, y, M, N, K, st);
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
