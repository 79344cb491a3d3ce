// Kernel B: non-causal flash attention over (B, S, H, D) bf16 tensors.
//
// Replaces the Pallas kernel diffusionkit_tpu/ops/flash_attention.py:
// flash_attention_bshd (_flash_kernel_bshd). Computes
// softmax(q k^T * scale) v with the reference's numerics: the row max m and
// row sum l in fp32, m kept UNSCALED with the scale folded into the exponent,
// masked (ragged) key columns at the finite -1e30, P rounded to bf16 before
// P.V, an fp32 accumulator divided by l at the end and rounded once.
//
// Bound on the H100: at the SD3-medium 512^2 shape (2 x 1178 x 24 heads,
// d=64) the two products are ~17 GFLOP per call against ~14 MB of q/k/v/o,
// so the kernel is compute-bound and must run its products on the tensor
// cores; the score matrix must never reach device memory. Design: the
// (B, S, H, D) layout is read in place through strides (one head per
// blockIdx.y, no transposes, no padded copies); q/k/v tiles are staged in
// shared memory with rows padded by 8 elements so every fragment load is
// bank-conflict free; products are mma.sync m16n8k16 (bf16 in, fp32 out);
// the online softmax runs on the accumulator fragments in registers, and
// the ragged kv edge is masked in-kernel. The TPU kernel's two-heads-per-
// lane-tile packing, sequence padding and v5e-specific tile specialisations
// are not carried over. wgmma/TMA pipelines come later.
//
// Two tilings:
//  * d <= 128 (`flash_fwd_small`): 4 warps x 16 query rows; each warp keeps
//    its q fragments, scores and output accumulator (16 x d fp32) in
//    registers, FlashAttention-2 style.
//  * d = 512 (`flash_fwd_wide`, the VAE mid-block's single head): a 16 x 512
//    fp32 accumulator per warp would need 256 registers a thread, so the
//    block shares one 16-row query tile among 4 warps. Each warp computes an
//    8-column slice of the scores over the full d, the softmax runs once per
//    tile from shared memory, and each warp accumulates its own 128-column
//    slice of the output. ~87 KB of dynamic shared memory, 2 blocks per SM.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

// Stage ROWS x D bf16 from global memory (row stride `rs` elements) into a
// shared tile with row stride LD; rows at or past `valid` are zero-filled.
template <int ROWS, int D, int LD, int NT>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g, long long rs, int valid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) val = *reinterpret_cast<const uint4*>(g + r * rs + col);
    *reinterpret_cast<uint4*>(smem + r * LD + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_small(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int S, Strides qs,
                    Strides ks, Strides vs, Strides os, float scale_log2) {
  constexpr int BQ = 64, BK = 64, LD = D + 8, NT = 128;
  __shared__ __align__(16) bf16 Qs[BQ * LD];
  __shared__ __align__(16) bf16 Ks[BK * LD];
  __shared__ __align__(16) bf16 Vs[BK * LD];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  load_tile<BQ, D, LD, NT>(Qs, q + b * qs.b + q0 * qs.s + h * qs.h, qs.s, S - q0);
  __syncthreads();

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = dk::lds32(&Qs[(r0 + g) * LD + kk * 16 + 2 * t]);
    qa[kk][1] = dk::lds32(&Qs[(r0 + g + 8) * LD + kk * 16 + 2 * t]);
    qa[kk][2] = dk::lds32(&Qs[(r0 + g) * LD + kk * 16 + 8 + 2 * t]);
    qa[kk][3] = dk::lds32(&Qs[(r0 + g + 8) * LD + kk * 16 + 8 + 2 * t]);
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  // Rows g and g+8 of this warp's 16; l is this thread's partial row sum.
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb_ = v + b * vs.b + h * vs.h;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<BK, D, LD, NT>(Ks, kb + k0 * ks.s, ks.s, S - k0);
    load_tile<BK, D, LD, NT>(Vs, vb_ + k0 * vs.s, vs.s, S - k0);
    __syncthreads();

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = dk::lds32(&Ks[(j * 8 + g) * LD + kk * 16 + 2 * t]);
        const uint32_t b1 = dk::lds32(&Ks[(j * 8 + g) * LD + kk * 16 + 8 + 2 * t]);
        dk::mma_bf16_16816(s[j], qa[kk], b0, b1);
      }
    }
    if (k0 + BK > S) {  // ragged kv edge
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = k0 + j * 8 + 2 * t;
        if (col >= S) s[j][0] = s[j][2] = kNegInf;
        if (col + 1 >= S) s[j][1] = s[j][3] = kNegInf;
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Both operands are finite (m starts at -1e30, never -inf), so no
    // inf - inf; masked columns and the first tile's alpha underflow to 0.
    const float alpha0 = exp2f((m0 - mx0) * scale_log2);
    const float alpha1 = exp2f((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f((s[j][0] - mx0) * scale_log2);
      s[j][1] = exp2f((s[j][1] - mx0) * scale_log2);
      s[j][2] = exp2f((s[j][2] - mx1) * scale_log2);
      s[j][3] = exp2f((s[j][3] - mx1) * scale_log2);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      oacc[n][0] *= alpha0;
      oacc[n][1] *= alpha0;
      oacc[n][2] *= alpha1;
      oacc[n][3] *= alpha1;
    }

    // P (rounded to bf16) . V; the score fragments of n-tiles 2c and 2c+1
    // are exactly the A fragment of k-step c.
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t pa[4] = {dk::pack_bf16(s[2 * c][0], s[2 * c][1]),
                              dk::pack_bf16(s[2 * c][2], s[2 * c][3]),
                              dk::pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              dk::pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        dk::ldmatrix_x4_trans(vf, &Vs[(c * 16 + (mi & 1) * 8 + mr) * LD + dp * 16 + (mi >> 1) * 8]);
        dk::mma_bf16_16816(oacc[2 * dp], pa, vf[0], vf[1]);
        dk::mma_bf16_16816(oacc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * os.s + col) =
          dk::pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * os.s + col) =
          dk::pack_bf16(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

template <int D>
struct WideTile {
  static constexpr int BQ = 16, BK = 32, LD = D + 8, LDS = BK + 4, LDP = BK + 8;
  static constexpr size_t kBytes = (size_t)BQ * LD * 2 + 2 * (size_t)BK * LD * 2 +
                                   (size_t)BQ * LDS * 4 + (size_t)BQ * LDP * 2 + 3 * BQ * 4;
};

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int S, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale_log2) {
  using T = WideTile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD, LDS = T::LDS, LDP = T::LDP, NT = 128;
  constexpr int DW = D / 4;  // output columns per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;
  float* Ss = reinterpret_cast<float*>(Vs + BK * LD);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * LDS);
  float* m_s = reinterpret_cast<float*>(Ps + BQ * LDP);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  load_tile<BQ, D, LD, NT>(Qs, q + b * qs.b + q0 * qs.s + h * qs.h, qs.s, S - q0);
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float oacc[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb_ = v + b * vs.b + h * vs.h;
  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    load_tile<BK, D, LD, NT>(Ks, kb + k0 * ks.s, ks.s, S - k0);
    load_tile<BK, D, LD, NT>(Vs, vb_ + k0 * vs.s, vs.s, S - k0);
    __syncthreads();

    // Scores: this warp's 8 key columns over the full head dim.
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a[4] = {dk::lds32(&Qs[g * LD + kk * 16 + 2 * t]),
                             dk::lds32(&Qs[(g + 8) * LD + kk * 16 + 2 * t]),
                             dk::lds32(&Qs[g * LD + kk * 16 + 8 + 2 * t]),
                             dk::lds32(&Qs[(g + 8) * LD + kk * 16 + 8 + 2 * t])};
      const uint32_t b0 = dk::lds32(&Ks[(warp * 8 + g) * LD + kk * 16 + 2 * t]);
      const uint32_t b1 = dk::lds32(&Ks[(warp * 8 + g) * LD + kk * 16 + 8 + 2 * t]);
      dk::mma_bf16_16816(sacc, a, b0, b1);
    }
    const int col = k0 + warp * 8 + 2 * t;
    if (col >= S) sacc[0] = sacc[2] = kNegInf;
    if (col + 1 >= S) sacc[1] = sacc[3] = kNegInf;
    Ss[g * LDS + warp * 8 + 2 * t] = sacc[0];
    Ss[g * LDS + warp * 8 + 2 * t + 1] = sacc[1];
    Ss[(g + 8) * LDS + warp * 8 + 2 * t] = sacc[2];
    Ss[(g + 8) * LDS + warp * 8 + 2 * t + 1] = sacc[3];
    __syncthreads();

    // Online softmax: 8 threads per query row, 4 columns each.
    {
      const int row = tid >> 3, c = (tid & 7) * 4;
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[row * LDS + c + i];
      float mx = fmaxf(fmaxf(sv[0], sv[1]), fmaxf(sv[2], sv[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f((sv[i] - m_new) * scale_log2);
        sum += p;
        Ps[row * LDP + c + i] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if ((tid & 7) == 0) {
        const float alpha = exp2f((m_prev - m_new) * scale_log2);
        m_s[row] = m_new;
        l_s[row] = l_s[row] * alpha + sum;
        a_s[row] = alpha;
      }
    }
    __syncthreads();

    // P . V into this warp's DW output columns.
    const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      oacc[n][0] *= al0;
      oacc[n][1] *= al0;
      oacc[n][2] *= al1;
      oacc[n][3] *= al1;
    }
    const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      const uint32_t pa[4] = {dk::lds32(&Ps[g * LDP + c * 16 + 2 * t]),
                              dk::lds32(&Ps[(g + 8) * LDP + c * 16 + 2 * t]),
                              dk::lds32(&Ps[g * LDP + c * 16 + 8 + 2 * t]),
                              dk::lds32(&Ps[(g + 8) * LDP + c * 16 + 8 + 2 * t])};
#pragma unroll
      for (int dp = 0; dp < DW / 16; ++dp) {
        uint32_t vf[4];
        dk::ldmatrix_x4_trans(
            vf, &Vs[(c * 16 + (mi & 1) * 8 + mr) * LD + warp * DW + dp * 16 + (mi >> 1) * 8]);
        dk::mma_bf16_16816(oacc[2 * dp], pa, vf[0], vf[1]);
        dk::mma_bf16_16816(oacc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  __syncthreads();

  const float l0 = l_s[g], l1 = l_s[g + 8];
  const int row0 = q0 + g, row1 = row0 + 8;
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    const int col = warp * DW + n * 8 + 2 * t;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(ob + row0 * os.s + col) =
          dk::pack_bf16(oacc[n][0] / l0, oacc[n][1] / l0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(ob + row1 * os.s + col) =
          dk::pack_bf16(oacc[n][2] / l1, oacc[n][3] / l1);
  }
}

}  // namespace

extern "C" int dk_flash_attn_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                  int S, int H, int D, long long qsb, long long qss,
                                  long long qsh, long long ksb, long long kss, long long ksh,
                                  long long vsb, long long vss, long long vsh, long long osb,
                                  long long oss, long long osh, float scale, void* stream) {
  if (!(scale > 0.f) || B <= 0 || S <= 0 || H <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  const float scale_log2 = scale * kLog2e;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: {
      const dim3 grid((S + 63) / 64, H, B);
      flash_fwd_small<64><<<grid, 128, 0, st>>>(qp, kp, vp, op, S, qs, ks, vs, os, scale_log2);
      break;
    }
    case 512: {
      const size_t smem = WideTile<512>::kBytes;
      const cudaError_t e = cudaFuncSetAttribute(
          flash_fwd_wide<512>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      const dim3 grid((S + WideTile<512>::BQ - 1) / WideTile<512>::BQ, H, B);
      flash_fwd_wide<512><<<grid, 128, smem, st>>>(qp, kp, vp, op, S, qs, ks, vs, os, scale_log2);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
