// The GPTQ group step: the body of the reference's group scan
// (diffusionkit_tpu/ops/gptq.py _gptq_core: gbody with rbody inside), which
// XLA compiles from a lax.scan there; no Pallas kernel.
//
// One call takes G groups of gs rows of an (in, out) weight: w (G, gs, N)
// fp32, the rows of each group already error-compensated by the groups
// before it, and each group's diagonal block of U (G, gs, gs; its rows may
// be rows of the whole U, u_row_stride apart), U the upper
// Cholesky factor of H^-1 (a batch stride of 0 repeats one block: the
// identity, which makes the step the data-free ALS grid). Per column:
//
//  1. the ALS affine-grid fit of _fit_grid_jax / _als_refine_host: from the
//     min/max grid, 9 evaluations of the group's squared error with 8
//     least-squares refits between them, the best (scale, zero) kept; then
//     rounded through f16 (the storage dtype), the scale clamped to 6.1e-8;
//  2. the in-group recursion, row by row: q = clip(rint((w_i - z) / s), 0,
//     qmax); e_i = (w_i - (s q + z)) / U_ii; w_j -= U_ij e_i for j > i.
//
// Out: codes (G, gs, N) uint8, the f16-rounded scale and zero (G, N) as
// fp32 values, and err (G, gs, N), which the caller pushes onto the rows
// past the group with one GEMM.
//
// Columns are independent, so a thread takes one column and keeps its gs
// rows in registers (GS is a template parameter, every row loop unrolled);
// U is read from global memory, the same address across a warp. Every sum
// over the rows runs from row 0 in order, and every product, sum and
// quotient is written __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn (nvcc's
// default -fmad=true would contract a * b + c into one FMA), so the kernel
// is its plain torch version (ops/gptq.py gptq_group_plain) bit for bit on
// the card; on the CPU that version is numpy's _als_refine_host bit for bit
// when U is the identity.
//
// Bound on the H100: it reads w once and writes err and the codes once, 9
// bytes a weight; FLUX's q/k/v + fc1 group (32 x 21504) is 6.2 MB, 1.8 us at
// 3.35 TB/s. The GPTQ loop launches it once a group, so its time there is
// the launch's.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kIters = 8;  // least-squares refits; kIters + 1 evaluations

__device__ __forceinline__ float f16_round(float x) {
  return __half2float(__float2half_rn(x));
}

__device__ __forceinline__ float grid_code(float w, float s, float z, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(__fsub_rn(w, z), s)), 0.f), qmax);
}

template <int GS>
__global__ void __launch_bounds__(kThreads)
    gptq_group_kernel(const float* __restrict__ w, const float* __restrict__ u,
                      long long u_group_stride, int u_row_stride, uint8_t* __restrict__ codes,
                      float* __restrict__ s_out, float* __restrict__ z_out,
                      float* __restrict__ err, int N, float qmax) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= N) return;
  const long long g = blockIdx.y;
  const long long base = g * GS * static_cast<long long>(N) + col;
  const float* ug = u + g * u_group_stride;

  float r[GS];
#pragma unroll
  for (int i = 0; i < GS; ++i) r[i] = w[base + static_cast<long long>(i) * N];

  // 1. The ALS fit.
  float wmin = r[0], wmax = r[0], sw = r[0];
#pragma unroll
  for (int i = 1; i < GS; ++i) {
    wmin = fminf(wmin, r[i]);
    wmax = fmaxf(wmax, r[i]);
    sw = __fadd_rn(sw, r[i]);
  }
  const float n = static_cast<float>(GS);
  float s = fmaxf(__fdiv_rn(__fsub_rn(wmax, wmin), qmax), 1e-8f);
  float z = wmin;
  float best_s = s, best_z = z, best_e = __int_as_float(0x7f800000);
#pragma unroll 1
  for (int it = 0; it <= kIters; ++it) {
    float e = 0.f, sq = 0.f, sqq = 0.f, swq = 0.f;
#pragma unroll
    for (int i = 0; i < GS; ++i) {
      const float q = grid_code(r[i], s, z, qmax);
      const float d = __fsub_rn(__fadd_rn(__fmul_rn(s, q), z), r[i]);
      const float dd = __fmul_rn(d, d), qq = __fmul_rn(q, q), wq = __fmul_rn(r[i], q);
      if (i == 0) {
        e = dd, sq = q, sqq = qq, swq = wq;
      } else {
        e = __fadd_rn(e, dd);
        sq = __fadd_rn(sq, q);
        sqq = __fadd_rn(sqq, qq);
        swq = __fadd_rn(swq, wq);
      }
    }
    if (e < best_e) best_s = s, best_z = z, best_e = e;
    if (it == kIters) break;
    const float denom = __fsub_rn(__fmul_rn(n, sqq), __fmul_rn(sq, sq));
    const bool ok = denom > 1e-10f;
    const float s_new =
        __fdiv_rn(__fsub_rn(__fmul_rn(n, swq), __fmul_rn(sq, sw)), ok ? denom : 1.f);
    if (ok && s_new > 1e-8f) {
      z = __fdiv_rn(__fsub_rn(sw, __fmul_rn(s_new, sq)), n);
      s = s_new;
    }
  }
  s = fmaxf(f16_round(best_s), 6.1e-8f);
  z = f16_round(best_z);
  s_out[g * N + col] = f16_round(s);
  z_out[g * N + col] = z;

  // 2. The in-group recursion.
#pragma unroll
  for (int i = 0; i < GS; ++i) {
    const float* urow = ug + i * u_row_stride;
    const float q = grid_code(r[i], s, z, qmax);
    codes[base + static_cast<long long>(i) * N] = static_cast<uint8_t>(q);
    const float e = __fdiv_rn(__fsub_rn(r[i], __fadd_rn(__fmul_rn(s, q), z)), __ldg(urow + i));
    err[base + static_cast<long long>(i) * N] = e;
#pragma unroll
    for (int j = i + 1; j < GS; ++j) r[j] = __fsub_rn(r[j], __fmul_rn(__ldg(urow + j), e));
  }
}

template <int GS>
int launch(const void* w, const void* u, long long u_group_stride, int u_row_stride, void* codes,
           void* s, void* z, void* err, int G, int N, float qmax, cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, G);
  gptq_group_kernel<GS><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(u), u_group_stride, u_row_stride,
      static_cast<uint8_t*>(codes), static_cast<float*>(s), static_cast<float*>(z),
      static_cast<float*>(err), N, qmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gs 32, 64 or 128; anything else is cudaErrorInvalidValue (the wrapper
// raises first).
extern "C" int dk_gptq_group(const void* w, const void* u, long long u_group_stride,
                             long long u_row_stride, void* codes, void* s, void* z, void* err,
                             int G, int gs, int N, float qmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ld = static_cast<int>(u_row_stride);
  switch (gs) {
    case 32: return launch<32>(w, u, u_group_stride, ld, codes, s, z, err, G, N, qmax, st);
    case 64: return launch<64>(w, u, u_group_stride, ld, codes, s, z, err, G, N, qmax, st);
    case 128: return launch<128>(w, u, u_group_stride, ld, codes, s, z, err, G, N, qmax, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
