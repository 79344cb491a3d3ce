// Non-causal flash attention over bf16 q/k/v read in place through strides:
// #14 at d = 64, and the C entry points of kernel B, #14 and #15 (kernel B
// and #15 at d = 64 and 128, and #14 at d = 128, run the Hopper kernels of
// flash_attention_sm90.cu; kernel B and #15 at d = 512 have their own entry
// point and kernel in flash_attention_wide_sm90.cu; each source has its own
// note).
//
// Replaces the Pallas kernels of diffusionkit_tpu/ops/flash_attention.py:
//  * kernel B, flash_attention_bshd (_flash_kernel_bshd): (B, S, H, D),
//    softmax(q k^T * scale) v with the row max m kept UNSCALED and the scale
//    folded into the exponent, exp((s - m) * scale);
//  * #15, flash_attention (_flash_kernel): (B, H, S, D), the scale before
//    the max: s = (q.k) * scale, m = max s, p = exp(s - m); output in q's
//    dtype;
//  * #14, flash_attention_stats (_flash_kernel with emit_stats): #15's
//    numerics for q (B, H, Sq, D) against a key chunk (B, H, Skv, D) whose
//    first `vlen` keys are valid; o in fp32 and the row statistics m (the
//    max of the SCALED scores) and l in fp32, (B, H, Sq, 1), as the ring
//    attention's combiner merges them (exp(m - m_new) weights the chunks, so
//    an unscaled m would weight them wrongly as soon as the ring has more
//    than one chunk).
// Shared numerics: fp32 m and l, masked (ragged) key columns at the finite
// -1e30, P rounded to bf16 before P.V, an fp32 accumulator divided by l at
// the end and rounded once (#14: by max(l, 1e-30), not rounded).
//
// Bound on the H100: at SD3 512² CFG's four-rank ring chunk (#14, 2 x 24
// heads x 295 tokens, d = 64) 0.33 GFLOP against ~5 MB, 0.0027 ms either
// way at 989 TFLOP/s and 3.35 TB/s.
// Products on the tensor cores, the score matrix never in device memory.
// Design: the layout is read in place through strides (one head per
// blockIdx.y, no transposes, no padded copies); q/k/v tiles are staged in
// shared memory with rows padded by 8 elements so every fragment load is
// bank-conflict free; products are mma.sync m16n8k16 (bf16 in, fp32 out);
// the online softmax runs on the accumulator fragments in registers, and
// the ragged kv edge is masked in-kernel. The TPU kernels' two-heads-per-
// lane-tile packing, sequence padding, (..., 128) lane-broadcast m/l and
// v5e-specific tile specialisations are not carried over. #14 at d = 64
// stays here because its chunks are small: 64-row blocks fill the card
// where the Hopper kernel's 128-row blocks leave a second wave (the times
// are in flash_attention_sm90.cu's note).
//
// Tiling:
//  * #14 at d = 64 (`flash_fwd_bhsd_small<64, true>`): 4 warps x 16 query
//    rows; each warp keeps its q fragments, scores and output accumulator
//    (16 x d fp32) in registers, FlashAttention-2 style. The q/k/v tiles
//    live in dynamic shared memory (27 KB). ptxas: 128 registers (4 blocks
//    an SM) and an 8-byte spill (the report is in _build/).
//    #14 skips the key tiles at or past vlen: they would change nothing
//    (their p are 0 and their alpha 1), so a fully masked chunk (vlen = 0)
//    runs no tile and writes o = 0, l = 0 and m = -1e30 exactly. (The
//    template's kStats = false branch, #15's until the Hopper kernel, is
//    not instantiated.)

#include <type_traits>

#include "common.cuh"

// Kernel B and #15 at d = 64 and 128: csrc/flash_attention_sm90.cu.
int dk_flash_attn_sm90_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                            int H, int D, const long long (&strides)[12], float sc,
                            bool scale_first, void* stream);
// #14 at d = 128: csrc/flash_attention_sm90.cu.
int dk_flash_attn_stats_sm90_bf16(const void* q, const void* k, const void* v, float* o,
                                  float* m, float* l, int B, int H, int Sq, int Skv, int D,
                                  int vlen, const long long (&strides)[12], float scale,
                                  void* stream);

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
struct SmallTile {
  static constexpr int BQ = 64, BK = 64, LD = D + 8;
  static constexpr size_t kBytes = (size_t)(BQ + 2 * BK) * LD * 2;
};

// #14 (kStats) and #15: q rows [0, Sq) of (B, H, Sq, D) against keys
// [0, vlen). #14 writes o in fp32 and the rows' m and l at
// (blockIdx.z * H + blockIdx.y) * Sq + row; #15 writes o in bf16.
template <int D, bool kStats>
__global__ void __launch_bounds__(128)
    flash_fwd_bhsd_small(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         typename std::conditional<kStats, float, bf16>::type* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out, int Sq, int vlen,
                         Strides qs, Strides ks, Strides vs, Strides os, float scale) {
  constexpr int BQ = SmallTile<D>::BQ, BK = SmallTile<D>::BK, LD = SmallTile<D>::LD, NT = 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + BK * LD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  load_tile<BQ, D, LD, NT>(Qs, q + b * qs.b + q0 * qs.s + h * qs.h, qs.s, Sq - q0);
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
  // Rows g and g+8 of this warp's 16 (m of the scaled scores); l is this
  // thread's partial row sum.
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb_ = v + b * vs.b + h * vs.h;
  for (int k0 = 0; k0 < vlen; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<BK, D, LD, NT>(Ks, kb + k0 * ks.s, ks.s, vlen - k0);
    load_tile<BK, D, LD, NT>(Vs, vb_ + k0 * vs.s, vs.s, vlen - k0);
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
      s[j][0] *= scale;
      s[j][1] *= scale;
      s[j][2] *= scale;
      s[j][3] *= scale;
    }
    if (k0 + BK > vlen) {  // the last valid tile: mask its columns >= vlen
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = k0 + j * 8 + 2 * t;
        if (col >= vlen) s[j][0] = s[j][2] = kNegInf;
        if (col + 1 >= vlen) s[j][1] = s[j][3] = kNegInf;
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
    // Every tile run holds a valid key, so mx is a real score: masked
    // columns and the first tile's alpha underflow to 0.
    const float alpha0 = exp2f((m0 - mx0) * kLog2e);
    const float alpha1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = exp2f((s[j][0] - mx0) * kLog2e);
      s[j][1] = exp2f((s[j][1] - mx0) * kLog2e);
      s[j][2] = exp2f((s[j][2] - mx1) * kLog2e);
      s[j][3] = exp2f((s[j][3] - mx1) * kLog2e);
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
  // l >= 1 wherever a key is valid; 0 only in a fully masked chunk.
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  auto* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if constexpr (kStats) {
      if (row0 < Sq)
        *reinterpret_cast<float2*>(ob + row0 * os.s + col) =
            make_float2(oacc[n][0] / d0, oacc[n][1] / d0);
      if (row1 < Sq)
        *reinterpret_cast<float2*>(ob + row1 * os.s + col) =
            make_float2(oacc[n][2] / d1, oacc[n][3] / d1);
    } else {
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * os.s + col) =
            dk::pack_bf16(oacc[n][0] / d0, oacc[n][1] / d0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row1 * os.s + col) =
            dk::pack_bf16(oacc[n][2] / d1, oacc[n][3] / d1);
    }
  }
  if constexpr (kStats) {
    if (t == 0) {
      const long long base = ((long long)b * gridDim.y + h) * Sq;
      if (row0 < Sq) {
        m_out[base + row0] = m0;
        l_out[base + row0] = l0;
      }
      if (row1 < Sq) {
        m_out[base + row1] = m1;
        l_out[base + row1] = l1;
      }
    }
  }
}

template <int D, bool kStats, typename OutT>
int launch_bhsd_small(const bf16* q, const bf16* k, const bf16* v, OutT* o, float* m, float* l,
                      int B, int H, int Sq, int vlen, Strides qs, Strides ks, Strides vs,
                      Strides os, float scale, cudaStream_t st) {
  const size_t smem = SmallTile<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bhsd_small<D, kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + SmallTile<D>::BQ - 1) / SmallTile<D>::BQ, H, B);
  flash_fwd_bhsd_small<D, kStats><<<grid, 128, smem, st>>>(q, k, v, o, m, l, Sq, vlen, qs, ks,
                                                           vs, os, scale);
  return (int)cudaGetLastError();
}

bool bad_dims(int B, int H, float scale) {
  return !(scale > 0.f) || B <= 0 || H <= 0 || H > 65535 || B > 65535;
}

}  // namespace

// Kernel B over (B, S, H, D) at d = 64 or 128; strides in elements, (batch,
// sequence, head). d = 512: dk_flash_attn_wide_bf16.
extern "C" int dk_flash_attn_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                  int S, int H, int D, long long qsb, long long qss,
                                  long long qsh, long long ksb, long long kss, long long ksh,
                                  long long vsb, long long vss, long long vsh, long long osb,
                                  long long oss, long long osh, float scale, void* stream) {
  if (bad_dims(B, H, scale) || S <= 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  return dk_flash_attn_sm90_bf16(q, k, v, o, B, S, H, D,
                                 {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh},
                                 scale * kLog2e, false, stream);
}

// #15 over (B, H, S, D) at d = 64 or 128: the same arguments as
// dk_flash_attn_bf16, the strides in (batch, sequence, head) order.
extern "C" int dk_flash_attn_bhsd_bf16(const void* q, const void* k, const void* v, void* o,
                                       int B, int S, int H, int D, long long qsb, long long qss,
                                       long long qsh, long long ksb, long long kss,
                                       long long ksh, long long vsb, long long vss,
                                       long long vsh, long long osb, long long oss,
                                       long long osh, float scale, void* stream) {
  if (bad_dims(B, H, scale) || S <= 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  return dk_flash_attn_sm90_bf16(q, k, v, o, B, S, H, D,
                                 {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh},
                                 scale, true, stream);
}

// #14: q (B, H, Sq, D) against k/v (B, H, Skv, D) with `vlen` valid leading
// keys (0 <= vlen <= Skv); o fp32 with strides, m and l fp32 contiguous
// (B, H, Sq).
extern "C" int dk_flash_attn_stats_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* m, void* l, int B, int H, int Sq, int Skv, int D,
                                        int vlen, long long qsb, long long qss, long long qsh,
                                        long long ksb, long long kss, long long ksh,
                                        long long vsb, long long vss, long long vsh,
                                        long long osb, long long oss, long long osh,
                                        float scale, void* stream) {
  if (bad_dims(B, H, scale) || Sq <= 0 || Skv <= 0 || vlen < 0 || vlen > Skv)
    return (int)cudaErrorInvalidValue;
  if (D == 128)
    return dk_flash_attn_stats_sm90_bf16(q, k, v, static_cast<float*>(o),
                                         static_cast<float*>(m), static_cast<float*>(l), B, H, Sq,
                                         Skv, D, vlen,
                                         {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss,
                                          osh},
                                         scale, stream);
  if (D != 64) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh}, os{osb, oss, osh};
  return launch_bhsd_small<64, true>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l), B, H, Sq, vlen, qs,
      ks, vs, os, scale, static_cast<cudaStream_t>(stream));
}
