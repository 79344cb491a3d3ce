// Non-causal flash attention for Hopper at d = 512, bf16: kernel B and #15
// over the VAE decoder's mid-block attention (one head 512 wide over every
// latent position: 4096 at 512², 16384 at 1024², 65536 at 2048²), with
// split-KV partials and their merge.
//
// Replaces the Pallas kernels of diffusionkit_tpu/ops/flash_attention.py at
// this head dim:
//  * kernel B, flash_attention_bshd (_flash_kernel_bshd), kScaleFirst false:
//    the row max m kept UNSCALED and the scale folded into the exponent;
//  * #15, flash_attention (_flash_kernel), kScaleFirst true: the scale
//    applied before the max.
// The numerics of flash_attention_sm90.cu: fp32 scores, m and l; key
// columns past S at the finite -1e30 before the max; the exponent formed by
// one FMA of the raw q.k (B: m' = m scale log2 e; #15: m' = m log2 e) and
// ex2.approx; P rounded to bf16 before P.V; the fp32 accumulator divided by
// l and rounded once. With the keys split into chunks, each chunk's block
// writes its unrounded fp32 accumulator, its m' and its l, and the merge
// kernel weights them by exp2(m'_i - max m'), divides the weighted sum by
// the weighted l and rounds once.
//
// Bound on the H100: 4 S^2 D operations on the bf16 tensor cores, 34.4
// GFLOP at 4096 positions (0.0347 ms at 989 TFLOP/s), against 17 MB of
// q/k/v/o: compute-bound. What the design solves:
//  * Registers. A 64 x 512 fp32 output accumulator is 256 registers a
//    thread for one warpgroup. Two consumer warpgroups share the block's 64
//    query rows and each owns 256 output columns (128 registers). The block
//    is those 256 threads and no more, so ptxas may give each up to 255
//    registers (a producer warp would round the block up to three
//    warpgroups, and ptxas then allots 168: the first build, with one,
//    spilled 140 bytes); thread 0 issues the loads.
//  * Scores without repeated work. Each consumer computes the partial
//    scores of all 64 keys of a tile over its own half of d (wgmma m64n64k16
//    SS, 16 k-steps: N = 64 keeps the A operand's shared-memory reads at a
//    quarter of the tensor cores' rate, where splitting the keys instead
//    would make N 32 or 16). The halves are exchanged through shared memory
//    (16 floats a thread each way, in fragment order, conflict-free): each
//    consumer then owns the full scores of 32 of the keys, exchanges its row
//    maxima, and both apply the same m and alpha. Each writes its bf16 P
//    slice into one 64 x 64 P tile (128-byte swizzled as TMA would write
//    it); l is summed per slice and the two added at the end.
//  * O += P V: wgmma m64n256k16 SS, A = the P tile (K-major), B = the
//    consumer's 256 columns of the V tile read MN-major (the transpose bit).
//  * Shared memory: Q 64 KB (64 x 512 bf16, eight 64-column boxes), one K
//    tile and one V tile of 64 keys (64 KB each), P 8 KB, the exchange 16
//    KB: 217 KB, one block an SM. K and V each have a full barrier: the
//    next K tile is issued once both warpgroups have their scores (behind
//    the exchange's barrier), so it loads under this tile's softmax and
//    P.V; the next V tile once all 8 warps have arrived on an empty barrier
//    after their P.V, so it loads under the next scores.
//  * Loads: TMA through 4-d tensor maps (512, S, H, B) with the strides the
//    wrapper passes (bshd, bhsd and views alike, read in place), 128-byte
//    swizzle, boxes of 64 columns x 64 rows; the hardware zero-fills rows
//    past S and the softmax masks those columns.
//  * Grid fill. At 4096 positions there are 64 query tiles for 132 SMs, so
//    the wrapper splits the keys into n_split chunks of whole 64-key tiles
//    (two at 4096: 128 blocks; one at 16384 and above) and the merge kernel
//    (`flash_wide_merge`, one block a row) combines the chunks' fp32
//    partials from scratch the wrapper allocates. Both launches sit behind
//    one C entry.

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace dk::sm90;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int D = 512, BQ = 64, BK = 64;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr uint32_t kBox = 64 * 128;  // 64 rows x 128 bytes
constexpr uint32_t kTile = 8 * kBox;  // 64 rows x 512 bf16
// Offsets from the 1024-byte aligned base: Q, K, V, the P tile (64 x 64
// bf16), the score exchange (2 x 4 float4 x 128 threads), the row maxima /
// sums (2 x 64 floats), then the barriers q_full, k_full, v_full, v_empty.
constexpr uint32_t kQ = 0, kK = kTile, kV = 2 * kTile, kP = 3 * kTile;
constexpr uint32_t kX = kP + 64 * 128, kRed = kX + 2 * 4 * 128 * 16, kBar = kRed + 2 * 64 * 4;
constexpr size_t kSmem = kBar + 4 * 8 + 1024;  // + alignment
static_assert(kSmem <= 232448, "one block an SM");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// q rows [q0, q0 + 64) of one (batch, head) against the keys of chunk
// blockIdx.z / B, [kbeg, kend). kScaleFirst false (kernel B): `sc` is
// scale * log2(e), m unscaled. True (#15): `sc` is the scale. With po null
// (one chunk) o is written in bf16 through its strides; otherwise the
// chunk's unnormalised fp32 accumulator goes to po, its m' (in log2 units)
// and l to pm and pl, at ((chunk * B + b) * H + h) * S + row.
template <bool kScaleFirst>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_sm90(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                        float* __restrict__ po, float* __restrict__ pm, float* __restrict__ pl,
                        int B, int S, int chunk, long long osb, long long oss, long long osh,
                        float sc) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atoms' alignment
  unsigned char* gen = smem_raw + (base - raw);  // the same bytes, generic
  const uint32_t sQ = base + kQ, sK = base + kK, sV = base + kV, sP = base + kP;
  const uint32_t q_full = base + kBar, k_full = q_full + 8, v_full = q_full + 16;
  const uint32_t v_empty = q_full + 24;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int b = blockIdx.z % B, split = blockIdx.z / B;
  const int kbeg = split * chunk, kend = min(S, kbeg + chunk);
  const int nk = (kend - kbeg + BK - 1) / BK;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(v_empty, kWarps);
    mbar_fence_init();
  }
  __syncthreads();
  auto load_tile = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int row) {
    mbar_arrive_expect_tx(bar, kTile);
    for (int x = 0; x < 8; ++x) tma_load_4d(dst + x * kBox, map, bar, 64 * x, row, h, b);
  };
  if (threadIdx.x == 0) {
    load_tile(sQ, &tq, q_full, q0);
    load_tile(sK, &tk, k_full, kbeg);
    load_tile(sV, &tv, v_full, kbeg);
  }

  // Warpgroup wg: d in [256 wg, 256 wg + 256) of the scores, the
  // keys [32 wg, 32 wg + 32) of each tile for the softmax, and output
  // columns [256 wg, 256 wg + 256). Warp wi of it holds rows 16 wi + g and
  // 16 wi + g + 8.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wi = warp & 3, ctid = threadIdx.x & 127;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * wi + g, r1 = r0 + 8;
  const float cexp = kScaleFirst ? sc * kLog2e : sc;
  const float mscale = kScaleFirst ? sc : 1.f, malpha = kScaleFirst ? kLog2e : sc;
  float4* xs = reinterpret_cast<float4*>(gen + kX);
  float* red = reinterpret_cast<float*>(gen + kRed);

  float oacc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) oacc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const uint64_t desc_q = desc_sw128(sQ + 4 * wg * kBox, 16, 1024);
  const uint64_t desc_k = desc_sw128(sK + 4 * wg * kBox, 16, 1024);
  const uint64_t desc_p = desc_sw128(sP, 16, 1024);
  const uint64_t desc_v = desc_sw128(sV + 4 * wg * kBox, kBox, 1024);

  mbar_wait(q_full, 0);
  for (int j = 0; j < nk; ++j) {
    const int parity = j & 1;
    // Partial scores over this warpgroup's half of d: 16 k-steps, 4 a box.
    float sacc[32];
    mbar_wait(k_full, parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const uint32_t off = ((kk / 4) * kBox + (kk % 4) * 32) >> 4;
      wgmma_ss_n64(sacc, desc_q + off, desc_k + off, kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // Exchange halves: warpgroup 0 keeps key columns 0-31 (fragment chunks
    // 0-3), warpgroup 1 columns 32-63 (chunks 4-7); the sum is the same
    // either way round (fp32 addition commutes).
    float s[16];
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xs[(4 + i) * 128 + ctid] = make_float4(sacc[16 + 4 * i], sacc[17 + 4 * i],
                                               sacc[18 + 4 * i], sacc[19 + 4 * i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xs[i * 128 + ctid] =
            make_float4(sacc[4 * i], sacc[4 * i + 1], sacc[4 * i + 2], sacc[4 * i + 3]);
    }
    named_bar_sync(1, 256);  // both warpgroups are done with this K tile
    if (threadIdx.x == 0 && j + 1 < nk) load_tile(sK, &tk, k_full, kbeg + (j + 1) * BK);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = xs[(4 * wg + i) * 128 + ctid];
      s[4 * i] = (wg == 0 ? sacc[4 * i] : sacc[16 + 4 * i]) + x.x;
      s[4 * i + 1] = (wg == 0 ? sacc[4 * i + 1] : sacc[17 + 4 * i]) + x.y;
      s[4 * i + 2] = (wg == 0 ? sacc[4 * i + 2] : sacc[18 + 4 * i]) + x.z;
      s[4 * i + 3] = (wg == 0 ? sacc[4 * i + 3] : sacc[19 + 4 * i]) + x.w;
    }

    // Softmax over this warpgroup's 32 keys, its row maxima exchanged.
    const int kc = kbeg + j * BK + 32 * wg + 2 * t;  // key of s[4i], + 8i
    if (kbeg + (j + 1) * BK > kend) {  // the ragged kv edge: TMA's zero rows score 0
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kc + 8 * i >= kend) s[4 * i] = s[4 * i + 2] = kNegInf;
        if (kc + 8 * i + 1 >= kend) s[4 * i + 1] = s[4 * i + 3] = kNegInf;
      }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    if (t == 0) {
      red[64 * wg + r0] = mx0;
      red[64 * wg + r1] = mx1;
    }
    named_bar_sync(1, 256);
    mx0 = fmaxf(red[r0], red[64 + r0]);
    mx1 = fmaxf(red[r1], red[64 + r1]);
    // A positive scale commutes with the max. Every tile holds a valid key,
    // so the max is a real score: masked columns and the first tile's
    // alpha underflow to 0.
    mx0 = fmaxf(m0, mx0 * mscale);
    mx1 = fmaxf(m1, mx1 * mscale);
    const float al0 = ex2((m0 - mx0) * malpha), al1 = ex2((m1 - mx1) * malpha);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 * malpha, mc1 = mx1 * malpha;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p0 = ex2(fmaf(s[4 * i], cexp, -mc0)), p1 = ex2(fmaf(s[4 * i + 1], cexp, -mc0));
      const float p2 = ex2(fmaf(s[4 * i + 2], cexp, -mc1));
      const float p3 = ex2(fmaf(s[4 * i + 3], cexp, -mc1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      // P[row][32 wg + 8 i + 2t], 128-byte swizzled: 16-byte chunk 4 wg + i
      // of the row lands at chunk (4 wg + i) ^ (row % 8), and row % 8 = g.
      const uint32_t chunk16 = static_cast<uint32_t>((4 * wg + i) ^ g) << 4;
      *reinterpret_cast<uint32_t*>(gen + kP + r0 * 128 + chunk16 + 4 * t) = dk::pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(gen + kP + r1 * 128 + chunk16 + 4 * t) = dk::pack_bf16(p2, p3);
    }
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    fence_proxy_async();
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      oacc[4 * n] *= al0;
      oacc[4 * n + 1] *= al0;
      oacc[4 * n + 2] *= al1;
      oacc[4 * n + 3] *= al1;
    }
    named_bar_sync(1, 256);  // the whole P tile is written

    mbar_wait(v_full, parity);
    fence_regs(oacc);
    wgmma_fence();
#pragma unroll
    for (int kc4 = 0; kc4 < BK / 16; ++kc4)
      wgmma_ss_n256_tb(oacc, desc_p + ((kc4 * 32) >> 4), desc_v + ((kc4 * 2048) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    if (lane == 0) mbar_arrive(v_empty);
    if (threadIdx.x == 0 && j + 1 < nk) {
      mbar_wait(v_empty, parity);  // every warp is done with this V tile
      load_tile(sV, &tv, v_full, kbeg + (j + 1) * BK);
    }
  }

  // l: this thread's quad partial -> the row's slice sum -> both slices.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (t == 0) {  // every read of the last tile's maxima is behind the P barrier
    red[64 * wg + r0] = l0;
    red[64 * wg + r1] = l1;
  }
  named_bar_sync(1, 256);
  l0 = red[r0] + red[64 + r0];
  l1 = red[r1] + red[64 + r1];
  const int row0 = q0 + r0, row1 = q0 + r1;
  if (po == nullptr) {
    bf16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int col = 256 * wg + 8 * n + 2 * t;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(ob + row0 * oss + col) =
            dk::pack_bf16(oacc[4 * n] / l0, oacc[4 * n + 1] / l0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(ob + row1 * oss + col) =
            dk::pack_bf16(oacc[4 * n + 2] / l1, oacc[4 * n + 3] / l1);
    }
    return;
  }
  const long long rows = ((long long)split * B + b) * gridDim.y + h;
  float* pb = po + rows * S * D;
#pragma unroll
  for (int n = 0; n < 32; ++n) {
    const int col = 256 * wg + 8 * n + 2 * t;
    if (row0 < S)
      *reinterpret_cast<float2*>(pb + (long long)row0 * D + col) =
          make_float2(oacc[4 * n], oacc[4 * n + 1]);
    if (row1 < S)
      *reinterpret_cast<float2*>(pb + (long long)row1 * D + col) =
          make_float2(oacc[4 * n + 2], oacc[4 * n + 3]);
  }
  if (wg == 0 && t == 0) {
    if (row0 < S) {
      pm[rows * S + row0] = m0 * malpha;
      pl[rows * S + row0] = l0;
    }
    if (row1 < S) {
      pm[rows * S + row1] = m1 * malpha;
      pl[rows * S + row1] = l1;
    }
  }
}

// One row a block (grid (S, H, B)), 4 columns a thread: the n chunks'
// partials weighted by exp2(m'_i - max m'), the weighted sum of the
// accumulators over the weighted sum of l, rounded once to bf16 and stored
// through o's strides. kScaleFirst only names the kernel after its caller
// (#15 or kernel B); the arithmetic is the same.
template <bool kScaleFirst>
__global__ void __launch_bounds__(128)
    flash_wide_merge(const float* __restrict__ po, const float* __restrict__ pm,
                     const float* __restrict__ pl, bf16* __restrict__ o, int n, long long osb,
                     long long oss, long long osh) {
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long rows = (long long)gridDim.x * gridDim.y * gridDim.z;  // B * H * S
  const long long r = ((long long)b * gridDim.y + h) * gridDim.x + s;
  float mx = kNegInf;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, pm[i * rows + r]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const float w = exp2f(pm[i * rows + r] - mx);
    l += w * pl[i * rows + r];
    const float4 x = reinterpret_cast<const float4*>(po + (i * rows + r) * D)[threadIdx.x];
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  uint2 out;
  out.x = dk::pack_bf16(acc.x / l, acc.y / l);
  out.y = dk::pack_bf16(acc.z / l, acc.w / l);
  *reinterpret_cast<uint2*>(o + b * osb + s * oss + h * osh + 4 * threadIdx.x) = out;
}

// The tensor map of one (B, S, H, 512) operand read through its strides (in
// elements, batch / sequence / head), a box of 64 columns x 64 rows; a dim
// of size 1 takes a stride of 16 bytes, which TMA accepts whatever torch
// reports for it.
int encode_operand(CUtensorMap* map, const void* p, int B, int S, int H, long long sb,
                   long long ss, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {S == 1 ? 16 : 2 * (cuuint64_t)ss,
                                 H == 1 ? 16 : 2 * (cuuint64_t)sh,
                                 B == 1 ? 16 : 2 * (cuuint64_t)sb};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return encode_tmap_bf16_4d(map, p, dims, strides, box);
}

template <bool kScaleFirst>
int launch_wide(const void* q, const void* k, const void* v, void* o, float* po, float* pm,
                float* pl, int B, int S, int H, const long long (&st)[12], float sc, int n_split,
                int chunk, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = encode_operand(&tq, q, B, S, H, st[0], st[1], st[2]);
  if (e == 0) e = encode_operand(&tk, k, B, S, H, st[3], st[4], st[5]);
  if (e == 0) e = encode_operand(&tv, v, B, S, H, st[6], st[7], st[8]);
  if (e != 0) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_fwd_wide_sm90<kScaleFirst>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid((S + BQ - 1) / BQ, H, B * n_split);
  bf16* op = static_cast<bf16*>(o);
  flash_fwd_wide_sm90<kScaleFirst><<<grid, kThreads, kSmem, stream>>>(
      tq, tk, tv, op, n_split > 1 ? po : nullptr, pm, pl, B, S, chunk, st[9], st[10], st[11],
      sc);
  if (n_split > 1) {
    const cudaError_t l = cudaGetLastError();
    if (l != cudaSuccess) return (int)l;
    flash_wide_merge<kScaleFirst><<<dim3(S, H, B), 128, 0, stream>>>(po, pm, pl, op, n_split,
                                                                      st[9], st[10], st[11]);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel B (scale_first 0) or #15 (1) at d = 512 over bf16 q, k, v and o
// (B, S, H, 512) read through their strides (in elements, (batch, sequence,
// head) for q, k, v and o in turn). The keys split into n_split chunks of
// `chunk` keys (a multiple of 64; the last chunk takes the rest); with
// n_split > 1, po (n_split, B, H, S, 512), pm and pl (n_split, B, H, S) are
// fp32 scratch the caller allocated, and the merge kernel writes o.
extern "C" int dk_flash_attn_wide_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* po, void* pm, void* pl, int B, int S, int H,
                                       long long qsb, long long qss, long long qsh,
                                       long long ksb, long long kss, long long ksh,
                                       long long vsb, long long vss, long long vsh,
                                       long long osb, long long oss, long long osh, float scale,
                                       int scale_first, int n_split, int chunk, void* stream) {
  if (!(scale > 0.f) || B <= 0 || S <= 0 || H <= 0 || H > 65535 || n_split < 1 ||
      (long long)B * n_split > 65535 || chunk <= 0 || chunk % BK != 0 ||
      (long long)(n_split - 1) * chunk >= S || (long long)n_split * chunk < S)
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && (po == nullptr || pm == nullptr || pl == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fo = static_cast<float*>(po);
  float* fm = static_cast<float*>(pm);
  float* fl = static_cast<float*>(pl);
  return scale_first
             ? launch_wide<true>(q, k, v, o, fo, fm, fl, B, S, H, st, scale, n_split, chunk, s)
             : launch_wide<false>(q, k, v, o, fo, fm, fl, B, S, H, st, scale * kLog2e, n_split,
                                  chunk, s);
}
