// Kernel E: w4a8 matmul, int4-packed weights x int8 activations on the int8
// tensor cores, with the four epilogues of the reference.
//
// Replaces the Pallas kernel diffusionkit_tpu/ops/w4a8_matmul.py:w4a8_matmul
// (_kernel, _kernel_gelu_quant, _kernel_norm_rope, _kernel_grouped_xs).
// Main loop, shared by all modes:
//   s8 = scales * (1 / wscale), z8 = zeros * (1 / wscale)   (IEEE, in that order)
//   w8 = clip(round_half_even(q * s8 + z8), -127, 127)     (a product and a sum,
//        each rounded: no FMA contraction)
//   acc = x8 @ w8                                           (exact int32)
// Epilogues, every step separately rounded in the reference's order:
//   plain       y = ((float(acc) * xs[m]) * ws[n]) + b[n] -> bf16
//   grouped_xs  per 512-wide k group: accf = accf + float(part) * xs[m, kg];
//               y = (accf * ws[n]) + b[n] -> bf16 (a 512-term int32 partial
//               is exact: 512 * 127^2 < 2^24)
//   gelu_quant  g = GELU(y) with the Abramowitz-Stegun erf of
//               fused_quant.py:_erf; per (row, 512-column tile)
//               amax = max(max|g|, 1e-8), y8 = clip(rne(g * (127 / amax))),
//               yscale = amax / 127
//   norm_rope   per 128-column head: yn = y * rsqrt(mean(y^2) + eps) * nw,
//               then rotate-half RoPE with the (S, 64) cos/sin tables at row
//               m mod S -> bf16
// The reference's (M, 128) lane-broadcast scale tensors and its
// [cos|cos|-sin|sin] table are TPU layouts and are not carried over.
//
// Two main loops run it. At M > 16, w4a8_matmul_sm90.cu (TMA, int8
// wgmma, warp specialisation; every mode). Here, the `ada` GEMVs (mode
// plain at M <= 16, ops/w4a8_matmul.py routes by M and mode): bound by
// reading the packed weight (28 MB for a dual block's `ada`), in 16-row
// tiles. The nibble -> float and float -> int8 steps use exact bit tricks
// (2^23 + q, and adding 1.5 * 2^23, which rounds half to even), not the
// slow conversion instructions.
//
// Tiling: 256 threads (8 warps), BK = 128 k per tile (four m16n8k32 steps
// between barriers), warp tiles of 16 rows by 16 columns. Per k tile:
// cp.async stages the x8 tile (16-byte chunks, rows past M zero-filled: no
// padded copy), the packed (16 x BN) words and their scale/zero rows into a
// double buffer; each word (8 consecutive k of one column) is requantised
// from shared memory into one 8-byte store of an int8 tile Bs[n][k], rows
// padded to 144 bytes and lanes split over two word rows so both those
// stores and the ldmatrix fragment loads are bank-conflict free; then
// mma.sync m16n8k32 (s8 in, s32 out). Groups of 32, 64 or a multiple of
// 128 (a tile never straddles a group it cannot see).

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 128, NTHREADS = 256;
constexpr int LDA = BK + 16, LDB = BK + 16;  // padded shared rows (bytes)
constexpr int QROWS = BK / 8;                // packed word rows per k tile
constexpr int SROWS = BK / 32;               // scale rows per k tile (group 32 -> 4)
// The activation-scale tile of the FFN hidden: gelu_quant's column tile and
// grouped_xs's k group. The reference's fc1 n block at every FLUX shape on
// the CPU and on a v5e (its CPU tests hold this value); fixed here.

enum Mode { PLAIN = 0, GELU_QUANT = 1, GROUPED_XS = 2, NORM_ROPE = 3 };

struct Params {
  const int8_t* x8;
  const uint32_t* q4;
  const float* scales;
  const float* zeros;
  const float* wscale;
  const float* xscale;  // (M,) or, for grouped_xs, (M, K / 512)
  const bf16* bias;     // (N,) or null
  const bf16* norm_w;   // (128,) norm_rope only
  const float* cos;     // (S, 64) norm_rope only
  const float* sin;
  void* y;              // bf16 (M, N), or int8 (M, N) for gelu_quant
  float* yscale;        // gelu_quant: (M, N / 512)
  long long lda;
  int S, M, N, K, group;
  float eps;
};

template <int BM, int BN>
struct Layout {
  static constexpr int QLD = BN + 16;  // padded word rows
  static constexpr size_t a = 2 * (size_t)BM * LDA;
  static constexpr size_t q = 2 * (size_t)QROWS * QLD * 4;
  static constexpr size_t s = 2 * (size_t)SROWS * BN * 4;
  static constexpr size_t b = (size_t)BN * LDB;
  static constexpr size_t v = 4 * (size_t)BN * 4;  // 1/ws, ws, bias, norm weight
  static constexpr size_t bytes = a + q + 2 * s + b + v;
};

// Two blocks an SM (registers <= 128 a thread).
template <int MODE, int WARPS_M, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS, 2)
    w4a8_mm(const Params p) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = WARPS_M * MT * 16;
  constexpr int BN = WARPS_N * NT * 8;
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  using L = Layout<BM, BN>;
  constexpr int QLD = L::QLD;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);                          // [2][BM][LDA]
  uint32_t* Qs = reinterpret_cast<uint32_t*>(smem + L::a);               // [2][QROWS][QLD]
  float* Ss = reinterpret_cast<float*>(smem + L::a + L::q);              // [2][SROWS][BN]
  float* Zs = Ss + 2 * SROWS * BN;                                       // [2][SROWS][BN]
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + L::a + L::q + 2 * L::s);  // [BN][LDB]
  float* Rs = reinterpret_cast<float*>(smem + L::a + L::q + 2 * L::s + L::b);
  float* Ws = Rs + BN;
  float* Bv = Ws + BN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, K = p.K, group = p.group;
  const int srows = group < BK ? BK / group : 1;
  const int KT = K / BK;

  for (int n = tid; n < BN; n += NTHREADS) {
    const float ws = p.wscale[n0 + n];
    Rs[n] = __fdiv_rn(1.f, ws);
    Ws[n] = ws;
    Bv[n] = p.bias ? __bfloat162float(p.bias[n0 + n]) : 0.f;
  }

  auto load_stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / 16); c += NTHREADS) {
      const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
      const int row = m0 + r;
      const int8_t* src = p.x8 + (long long)(row < M ? row : 0) * p.lda + k0 + col;
      dk::cp_async16(&As[(buf * BM + r) * LDA + col], src, row < M ? 16 : 0);
    }
    for (int c = tid; c < QROWS * (BN / 4); c += NTHREADS) {
      const int r = c / (BN / 4), col = (c % (BN / 4)) * 4;
      dk::cp_async16(&Qs[(buf * QROWS + r) * QLD + col],
                     p.q4 + (long long)(k0 / 8 + r) * N + n0 + col, 16);
    }
    for (int c = tid; c < srows * (BN / 4); c += NTHREADS) {
      const int r = c / (BN / 4), col = (c % (BN / 4)) * 4;
      const long long off = (long long)(k0 / group + r) * N + n0 + col;
      dk::cp_async16(&Ss[(buf * SROWS + r) * BN + col], p.scales + off, 16);
      dk::cp_async16(&Zs[(buf * SROWS + r) * BN + col], p.zeros + off, 16);
    }
    dk::cp_async_commit();
  };

  // Requantisation: this thread's word row and columns (lanes alternate
  // between two word rows so a half-warp's 8-byte stores hit 16 distinct
  // 8-byte slots of the 144-byte-pitch tile).
  static_assert(QROWS == 2 * 8, "8 warps x 2 word rows");
  const int rq = 2 * warp + (lane & 1);
  const int nq = lane >> 1;
  const int srow_q = group < BK ? (8 * rq) / group : 0;
  const int g = lane >> 2, t = lane & 3;

  int acc[MT][NT][4] = {};

  load_stage(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) {
      load_stage(kt + 1, buf ^ 1);  // the buffer's last reader finished (sync below)
      dk::cp_async_wait<1>();
    } else {
      dk::cp_async_wait<0>();
    }
    __syncthreads();

    {
      const uint32_t* qrow = &Qs[(buf * QROWS + rq) * QLD];
      const float* sp = &Ss[(buf * SROWS + srow_q) * BN];
      const float* zp = &Zs[(buf * SROWS + srow_q) * BN];
#pragma unroll
      for (int i = 0; i < BN / 16; ++i) {
        const int n = nq + 16 * i;
        const float rw = Rs[n];
        *reinterpret_cast<uint2*>(&Bs[n * LDB + 8 * rq]) =
            dk::requant_word(qrow[n], __fmul_rn(sp[n], rw), __fmul_rn(zp[n], rw));
      }
    }
    __syncthreads();

    const int8_t* Ab = As + buf * BM * LDA;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        dk::ldmatrix_x4(a[mt], &Ab[(wm * MT * 16 + mt * 16 + (lane & 15)) * LDA + ks * 32 +
                                   (lane >> 4) * 16]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        dk::ldmatrix_x4(b, &Bs[(wn * NT * 8 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDB +
                              ks * 32 + ((lane >> 3) & 1) * 16]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          dk::mma_s8_16832(acc[mt][2 * np], a[mt], b[0], b[1]);
          dk::mma_s8_16832(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    __syncthreads();  // As[buf] and Bs are free for the next tile
  }

  {
    bf16* y = static_cast<bf16*>(p.y);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + mt * 16 + g + 8 * h;
        if (row >= M) continue;
        const float xs = p.xscale[row];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int cl = wn * NT * 8 + nt * 8 + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * h + e]), xs), Ws[cl + e]);
            v[e] = __fadd_rn(v[e], Bv[cl + e]);
          }
          *reinterpret_cast<uint32_t*>(y + (long long)row * N + n0 + cl) = dk::pack_bf16(v[0], v[1]);
        }
      }
  }

}

template <int MODE, int WARPS_M, int MT, int NT>
int launch(const Params& p, cudaStream_t st) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = WARPS_M * MT * 16, BN = WARPS_N * NT * 8;
  if (p.N % BN || (p.M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout<BM, BN>::bytes;
  auto kernel = w4a8_mm<MODE, WARPS_M, MT, NT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(p.N / BN, (p.M + BM - 1) / BM);
  kernel<<<grid, NTHREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Mode plain at M <= 16; the wrapper sends every other call to
// dk_w4a8_matmul_sm90 (w4a8_matmul_sm90.cu), which takes the same arguments.
extern "C" int dk_w4a8_matmul(const void* x8, const void* q4, const void* scales,
                              const void* zeros, const void* wscale, const void* xscale,
                              const void* bias, const void* norm_w, const void* cos,
                              const void* sin, int S, void* y, void* yscale, int mode, int M,
                              int N, int K, int group, long long lda, float eps, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK || group <= 0 || K % group ||
      !(group == 32 || group == 64 || group % BK == 0) || lda < K || lda % 16)
    return (int)cudaErrorInvalidValue;
  if (mode != PLAIN || M > 16) return (int)cudaErrorInvalidValue;
  Params p;
  p.x8 = static_cast<const int8_t*>(x8);
  p.q4 = static_cast<const uint32_t*>(q4);
  p.scales = static_cast<const float*>(scales);
  p.zeros = static_cast<const float*>(zeros);
  p.wscale = static_cast<const float*>(wscale);
  p.xscale = static_cast<const float*>(xscale);
  p.bias = static_cast<const bf16*>(bias);
  p.norm_w = static_cast<const bf16*>(norm_w);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.y = y;
  p.yscale = static_cast<float*>(yscale);
  p.lda = lda;
  p.S = S;
  p.M = M;
  p.N = N;
  p.K = K;
  p.group = group;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch<PLAIN, 1, 1, 2>(p, st);
}
