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
// What the reference computes in fp32, and so this kernel: fp32 scores,
// an fp32 online softmax (exp2 of the scaled difference, the accurate
// exp2f), P NOT rounded (v is fp32), fp32 P.V, one fp32 division by l.
// Callers: the VAE mid-block of DiffusionPipeline(a16=False) (one head of
// d=512 over 4096 positions at 512^2), fp32 MMDiTs (SD3: 24 heads of 64
// over 1178 tokens; FLUX: 24 of 128 over 4352), SD3.5-large's fp32 block.
//
// Products: fp32 FMAs on the CUDA cores, not the tensor cores. A single
// TF32 mma keeps ~11 mantissa bits, ~3e-4 relative: it does not compute
// the reference's fp32 and misses the port's bound (2^-16 of max|out|
// against the fp32 plain version). 3xTF32 split products would recover
// fp32 at three tensor-core passes and a split per operand per tile; that
// is a later kernel's design. The FMA pipe's 67 TFLOP/s peak (SXM, 700 W)
// bounds this kernel: at FLUX's (1, 4352, 24, 128) the two products are
// 233 GFLOP, 3.5 ms at that peak, against 214 MB of q/k/v/o (0.064 ms).
//
// The bf16 kernels of csrc/flash_attention.cu are untouched: a separate
// source, so their ptxas register allocation cannot move (folding kernels
// into one template once cost kernel B 20-28 %).
//
// Tiling: 128 threads as 8 row groups x 16 lanes. A block takes BQ query
// rows (64 at d = 64 and 128, 16 at d = 512); each thread owns BQ/8 rows.
// Per BK-key tile (64, or 32 at d = 512): the K tile is staged in shared
// memory (rows padded by 4 floats, so the 16-byte loads of 8 lanes land in
// distinct banks), each thread computes BQ/8 x BK/16 scores with float4
// loads along d (q rows broadcast within a half warp), the online softmax
// reduces each row over its 16 lanes with shuffles and writes P to shared
// memory; then V is staged over K (the d=512 tiles could not hold both:
// a 64-key fp32 tile of K and V at d=512 alone is 256 KB, over the 227 KB a
// block may use) and each thread accumulates its rows x d/16 output columns
// in registers (64 floats). Shared memory: 52 KB at d=64, 85 KB at d=128,
// 101 KB at d=512. The ragged kv edge is zero-filled and masked in-kernel.

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int NT = 128, TX = 16, TY = NT / TX;

struct Strides {
  long long b, s, h;  // in elements; the head dim is contiguous
};

// kernel B (the max of the unscaled scores), #15 (the scale first) and #14
// (#15 against vlen valid keys, with m and l out).
enum Mode { kUnscaledMax = 0, kScaleFirst = 1, kStats = 2 };

template <int D>
struct F32Tile {
  static constexpr int BQ = D == 512 ? 16 : 64, BK = D == 512 ? 32 : 64;
  static constexpr int LD = D + 4, LDP = BK + 4;
  static constexpr size_t kBytes = ((size_t)(BQ + BK) * LD + (size_t)BQ * LDP) * 4;
};

// Stage ROWS x D fp32 from global memory (row stride `rs` elements) into a
// shared tile with row stride LD; rows at or past `valid` are zero-filled.
template <int ROWS, int D, int LD>
__device__ __forceinline__ void load_rows(float* smem, const float* g, long long rs, int valid) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) val = *reinterpret_cast<const float4*>(g + r * rs + col);
    *reinterpret_cast<float4*>(smem + r * LD + col) = val;
  }
}

// Query rows [0, Sq) of one (batch, head) against keys [0, vlen). `sc` is
// the softmax scale. o fp32 through strides; #14 writes m and l at
// (blockIdx.z * H + blockIdx.y) * Sq + row.
template <int D, int MODE>
__global__ void __launch_bounds__(NT)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out, int Sq, int vlen, Strides qs, Strides ks,
                  Strides vs, Strides os, float sc) {
  using T = F32Tile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LD = T::LD, LDP = T::LDP;
  constexpr int RQ = BQ / TY;  // query rows per thread
  constexpr int CK = BK / TX;  // score columns per thread: tx + TX * j
  constexpr int DU = D / 64;   // float4 output groups per thread: 64 u + 4 tx
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;

  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  // B folds the scale into the exponent; #14/#15 scale the scores first.
  const float e2 = MODE == kUnscaledMax ? sc * kLog2e : kLog2e;

  load_rows<BQ, D, LD>(Qs, q + b * qs.b + q0 * qs.s + h * qs.h, qs.s, Sq - q0);

  float oacc[RQ][DU][4];
  float mrow[RQ], lrow[RQ];  // l: this thread's partial row sum
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
#pragma unroll
    for (int u = 0; u < DU; ++u) oacc[i][u][0] = oacc[i][u][1] = oacc[i][u][2] = oacc[i][u][3] = 0.f;
  }

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  for (int k0 = 0; k0 < vlen; k0 += BK) {
    __syncthreads();  // the previous V tile and P are fully consumed
    load_rows<BK, D, LD>(KVs, kb + k0 * ks.s, ks.s, vlen - k0);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * RQ + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < CK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KVs[(tx + TX * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Online softmax. Every tile run holds a valid key, so each row's max
    // is a real score: masked columns (the finite -1e30) and the first
    // tile's alpha underflow to 0.
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      float mx = mrow[i];
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        if (MODE != kUnscaledMax) s[i][j] *= sc;
        if (k0 + tx + TX * j >= vlen) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = exp2f((mrow[i] - mx) * e2);
      mrow[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = exp2f((s[i][j] - mx) * e2);
        rs += p;
        Ps[(ty * RQ + i) * LDP + tx + TX * j] = p;
      }
      lrow[i] = lrow[i] * alpha + rs;
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        oacc[i][u][0] *= alpha;
        oacc[i][u][1] *= alpha;
        oacc[i][u][2] *= alpha;
        oacc[i][u][3] *= alpha;
      }
    }
    __syncthreads();  // P complete; every K read done
    load_rows<BK, D, LD>(KVs, vb + k0 * vs.s, vs.s, vlen - k0);
    __syncthreads();

    // O += P . V over this tile's keys (zero-filled rows past vlen have p = 0).
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = Ps[(ty * RQ + i) * LDP + kk];
#pragma unroll
      for (int u = 0; u < DU; ++u) {
        const float4 vv = *reinterpret_cast<const float4*>(&KVs[kk * LD + 64 * u + 4 * tx]);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          oacc[i][u][0] = fmaf(p[i], vv.x, oacc[i][u][0]);
          oacc[i][u][1] = fmaf(p[i], vv.y, oacc[i][u][1]);
          oacc[i][u][2] = fmaf(p[i], vv.z, oacc[i][u][2]);
          oacc[i][u][3] = fmaf(p[i], vv.w, oacc[i][u][3]);
        }
      }
    }
  }

  float* ob = o + b * os.b + h * os.h;
  const long long base = ((long long)b * gridDim.y + h) * Sq;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float l = lrow[i];
#pragma unroll
    for (int off = 1; off < TX; off <<= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = q0 + ty * RQ + i;
    if (row >= Sq) continue;
    // l >= 1 wherever a key is valid; 0 only in #14's fully masked chunk.
    const float dl = fmaxf(l, 1e-30f);
#pragma unroll
    for (int u = 0; u < DU; ++u)
      *reinterpret_cast<float4*>(ob + row * os.s + 64 * u + 4 * tx) =
          make_float4(oacc[i][u][0] / dl, oacc[i][u][1] / dl, oacc[i][u][2] / dl,
                      oacc[i][u][3] / dl);
    if constexpr (MODE == kStats) {
      if (tx == 0) {
        m_out[base + row] = mrow[i];
        l_out[base + row] = l;
      }
    }
  }
}

template <int D, int MODE>
int launch_f32(const void* q, const void* k, const void* v, void* o, void* m, void* l, int B,
               int H, int Sq, int vlen, Strides qs, Strides ks, Strides vs, Strides os, float sc,
               cudaStream_t st) {
  const size_t smem = F32Tile<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + F32Tile<D>::BQ - 1) / F32Tile<D>::BQ, H, B);
  flash_fwd_f32<D, MODE><<<grid, NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(m), static_cast<float*>(l), Sq, vlen, qs, ks,
      vs, os, sc);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_f32(const void* q, const void* k, const void* v, void* o, void* m, void* l, int B,
                 int H, int Sq, int vlen, int D, Strides qs, Strides ks, Strides vs, Strides os,
                 float sc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_f32<64, MODE>(q, k, v, o, m, l, B, H, Sq, vlen, qs, ks, vs, os, sc, st);
    case 128:
      return launch_f32<128, MODE>(q, k, v, o, m, l, B, H, Sq, vlen, qs, ks, vs, os, sc, st);
    case 512:  // kernel B and #15 only (#14 runs the MMDiT head dims)
      if constexpr (MODE != kStats)
        return launch_f32<512, MODE>(q, k, v, o, m, l, B, H, Sq, vlen, qs, ks, vs, os, sc, st);
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
