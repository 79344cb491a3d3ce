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
// Design. A column's work is a serial chain: four sums over its rows taken
// in row order for each of the 9 evaluations, and the recursion's gs steps,
// each a division that needs the step before. One thread a column (the
// first design, run AB) left the card idle and ran each chain on one lane:
// 0.02724-0.03034 ms a step at N 1536-21504 and gs 32, flat in N, GS = 128
// spilling at 255 registers. Here a warp takes 8 neighbouring columns and
// spreads each column's rows over 4 lanes (lane = 8 row group + column; the
// lane holds rows rg, rg + 4, ...), so a 128-thread block takes 32 columns:
//  - the ALS terms (d^2, q, q^2, w q) of a row are computed in parallel,
//    staged 32 rows at a time in shared memory as one float4 a (row,
//    column), and summed in row order by the warp's 32 lanes at once, lane
//    (column lane / 4, term lane % 4) running one sum on from row 0: the
//    order of the plain version, so the bits; every lane then holds its
//    column's four sums by shuffles and runs the refit itself;
//  - in the recursion, at step i the row group holding row i computes q_i
//    and e_i, one shuffle hands e_i to the column's other lanes, and each
//    lane updates its own rows j > i, each row's updates still in i order.
//    The step holds no branch and no store (a lane keeps its rows' err and
//    codes in registers and stores them at the end), and U's block is
//    copied to shared memory (cp.async, in flight during the ALS fit).
// Every product, sum and quotient is written __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn (nvcc's default -fmad=true would contract a * b + c
// into one FMA), so the kernel is its plain torch version (ops/gptq.py
// gptq_group_plain) bit for bit on the card; on the CPU that version is
// numpy's _als_refine_host bit for bit when U is the identity.
//
// Bound on the H100: it reads w once and writes err and the codes once, 9
// bytes a weight; FLUX's q/k/v + fc1 group (32 x 21504) is 6.2 MB, 1.8 us at
// 3.35 TB/s. What holds it far above that is one warp's chain: 9 x (gs
// ordered adds + a refit with two IEEE divisions), then gs recursion steps
// of ~15 dependent operations and a shuffle each; a launch alone takes
// ~1.5 us in a CUDA graph. At large N the SMs' instruction throughput
// adds to it.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;                      // columns a warp takes
constexpr int kRowLanes = 4;                  // lanes a column's rows are spread over
constexpr int kWarps = 4;                     // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunkRows = 32;                // rows a column stages at once for the sums
constexpr int kSlots = kChunkRows / kRowLanes;  // of them, a lane's
constexpr int kIters = 8;                     // least-squares refits; kIters + 1 evaluations
constexpr unsigned kFull = 0xffffffffu;

// Blocks an SM for __launch_bounds__: the register cap that leaves no spill.
template <int GS>
constexpr int min_blocks() {
  return GS == 32 ? 6 : (GS == 64 ? 4 : 3);
}

__device__ __forceinline__ float f16_round(float x) {
  return __half2float(__float2half_rn(x));
}

__device__ __forceinline__ float clip_code(float v, float qmax) {
  return fminf(fmaxf(rintf(v), 0.f), qmax);
}

// One chunk of a column's rows: the lane's kSlots rows (slots h * kSlots
// on) staged as float4 terms, then the sums over the chunk's 32 rows in row
// order, lane (column lane / 4, term lane % 4) carrying its sum on from the
// chunks before. kEval: the ALS terms (d^2, q, q^2, w q) of the grid (s, z);
// otherwise (w, 0, 0, 0).
template <int R, bool kEval>
__device__ __forceinline__ float chunk_sum(float4* tb, const float (&r)[R], int h, float acc,
                                           int lane, float s, float z, float qmax) {
  const int c = lane & (kCols - 1), rg = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kSlots; ++kk) {
    const float x = r[h * kSlots + kk];
    float4 t = make_float4(x, 0.f, 0.f, 0.f);
    if constexpr (kEval) {
      const float a = __fsub_rn(x, z);
      const float q = clip_code(__fdiv_rn(a, s), qmax);
      const float d = __fsub_rn(__fadd_rn(__fmul_rn(s, q), z), x);
      t = make_float4(__fmul_rn(d, d), q, __fmul_rn(q, q), __fmul_rn(x, q));
    }
    tb[(rg + kRowLanes * kk) * kCols + c] = t;
  }
  __syncwarp();
  const float* tf = reinterpret_cast<const float*>(tb);
#pragma unroll
  for (int i = 0; i < kChunkRows; ++i) {
    const float v = tf[i * 32 + lane];
    acc = (h == 0 && i == 0) ? v : __fadd_rn(acc, v);
  }
  return acc;
}

// The column's gs rows summed from row 0 in order, each of the four terms;
// the staging buffers alternate, so one __syncwarp a chunk keeps a buffer
// from being written while a lane still reads it.
template <int R, bool kEval>
__device__ __forceinline__ float4 ordered_sums(float4 (*buf)[kChunkRows * kCols], int& turn,
                                               const float (&r)[R], int lane, float s, float z,
                                               float qmax) {
  float acc = 0.f;
#pragma unroll
  for (int h = 0; h < R / kSlots; ++h) {
    acc = chunk_sum<R, kEval>(buf[turn], r, h, acc, lane, s, z, qmax);
    turn ^= 1;
  }
  const int src = (lane & (kCols - 1)) * 4;
  return make_float4(__shfl_sync(kFull, acc, src), __shfl_sync(kFull, acc, src + 1),
                     __shfl_sync(kFull, acc, src + 2), __shfl_sync(kFull, acc, src + 3));
}

// U's diagonal block, in shared memory.
template <int GS>
constexpr int u_smem_bytes() {
  return GS * GS * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// The in-group recursion over a column: step i = 4 ki + gi runs in row
// group gi's lanes (slot ki; the other lanes compute on their own slot ki
// and drop it), one shuffle hands e_i to the column's lanes, and each lane
// updates its rows j > i. The step's chain holds no branch and no store:
// each lane keeps its rows' err in r and their codes packed four a
// register, and stores them after the last step. U's block (GS x GS) comes
// from shared memory.
template <int GS>
__device__ __forceinline__ void recurse(float (&r)[GS / kRowLanes], const float* __restrict__ ushm,
                                        float s, float z, float qmax, uint8_t* __restrict__ codes,
                                        float* __restrict__ err, long long base, int N, bool valid,
                                        int lane) {
  constexpr int R = GS / kRowLanes;
  const int c = lane & (kCols - 1), rg = lane >> 3;
  unsigned cq[R / 4] = {};
#pragma unroll
  for (int i = 0; i < GS; ++i) {
    const int gi = i % kRowLanes, ki = i / kRowLanes;
    const float* urow = ushm + i * GS;
    const float x = r[ki];
    const float q = clip_code(__fdiv_rn(__fsub_rn(x, z), s), qmax);
    const float e = __fdiv_rn(__fsub_rn(x, __fadd_rn(__fmul_rn(s, q), z)), urow[i]);
    if (rg == gi) {
      r[ki] = e;
      cq[ki / 4] |= static_cast<unsigned>(q) << (8 * (ki % 4));
    }
    const float ei = __shfl_sync(kFull, e, gi * kCols + c);
#pragma unroll
    for (int k = ki; k < R; ++k) {
      if (k > ki || rg > gi) r[k] = __fsub_rn(r[k], __fmul_rn(urow[rg + kRowLanes * k], ei));
    }
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long at = base + static_cast<long long>(rg + kRowLanes * k) * N;
      codes[at] = static_cast<uint8_t>(cq[k / 4] >> (8 * (k % 4)));
      err[at] = r[k];
    }
  }
}

template <int GS>
__global__ void __launch_bounds__(kThreads, min_blocks<GS>())
    gptq_group_kernel(const float* __restrict__ w, const float* __restrict__ u,
                      long long u_group_stride, int u_row_stride, uint8_t* __restrict__ codes,
                      float* __restrict__ s_out, float* __restrict__ z_out,
                      float* __restrict__ err, int N, float qmax) {
  constexpr int R = GS / kRowLanes;
  __shared__ float4 stage[kWarps][2][kChunkRows * kCols];
  extern __shared__ float ushm[];  // U's block (GS x GS)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & (kCols - 1), rg = lane >> 3;
  // A warp past N runs on zeros and stores nothing: every warp reaches the
  // block's barriers.
  const int col = (blockIdx.x * kWarps + warp) * kCols + c;
  const bool valid = col < N;
  const long long g = blockIdx.y;
  const long long base = g * GS * static_cast<long long>(N) + col;
  const float* ug = u + g * u_group_stride;

  float r[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    r[k] = valid ? w[base + static_cast<long long>(rg + kRowLanes * k) * N] : 0.f;
  // U's block, in flight while the ALS fit runs.
  for (int idx = threadIdx.x; idx < GS * GS; idx += kThreads)
    cp_async4(ushm + idx, ug + static_cast<long long>(idx / GS) * u_row_stride + idx % GS);

  // 1. The ALS fit.
  float wmin = r[0], wmax = r[0];
#pragma unroll
  for (int k = 1; k < R; ++k) {
    wmin = fminf(wmin, r[k]);
    wmax = fmaxf(wmax, r[k]);
  }
#pragma unroll
  for (int o = kCols; o < 32; o <<= 1) {
    wmin = fminf(wmin, __shfl_xor_sync(kFull, wmin, o));
    wmax = fmaxf(wmax, __shfl_xor_sync(kFull, wmax, o));
  }
  float4 (*buf)[kChunkRows * kCols] = stage[warp];
  int turn = 0;
  const float sw = ordered_sums<R, false>(buf, turn, r, lane, 0.f, 0.f, qmax).x;
  const float n = static_cast<float>(GS);
  float s = fmaxf(__fdiv_rn(__fsub_rn(wmax, wmin), qmax), 1e-8f);
  float z = wmin;
  float best_s = s, best_z = z, best_e = __int_as_float(0x7f800000);
#pragma unroll 1
  for (int it = 0; it <= kIters; ++it) {
    const float4 t = ordered_sums<R, true>(buf, turn, r, lane, s, z, qmax);
    const float e = t.x, sq = t.y, sqq = t.z, swq = t.w;
    if (e < best_e) best_s = s, best_z = z, best_e = e;
    if (it == kIters) break;
    const float denom = __fsub_rn(__fmul_rn(n, sqq), __fmul_rn(sq, sq));
    const bool pos = denom > 1e-10f;
    const float s_new =
        __fdiv_rn(__fsub_rn(__fmul_rn(n, swq), __fmul_rn(sq, sw)), pos ? denom : 1.f);
    if (pos && s_new > 1e-8f) {
      z = __fdiv_rn(__fsub_rn(sw, __fmul_rn(s_new, sq)), n);
      s = s_new;
    }
  }
  s = fmaxf(f16_round(best_s), 6.1e-8f);
  z = f16_round(best_z);
  if (valid && rg == 0) {
    s_out[g * N + col] = f16_round(s);
    z_out[g * N + col] = z;
  }

  // 2. The in-group recursion.
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  recurse<GS>(r, ushm, s, z, qmax, codes, err, base, N, valid, lane);
}

template <int GS>
int launch(const void* w, const void* u, long long u_group_stride, int u_row_stride, void* codes,
           void* s, void* z, void* err, int G, int N, float qmax, cudaStream_t stream) {
  constexpr int smem = u_smem_bytes<GS>();
  // The static stage (32 KB) and U's block pass 48 KB at gs 128.
  static const int raised = static_cast<int>(cudaFuncSetAttribute(
      gptq_group_kernel<GS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (raised) return raised;
  const int cols = kWarps * kCols;
  const dim3 grid((N + cols - 1) / cols, G);
  gptq_group_kernel<GS><<<grid, kThreads, smem, stream>>>(
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
