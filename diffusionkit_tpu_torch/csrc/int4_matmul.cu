// Kernel C: y[M, N] = x[M, K] @ dequant(q4, scales, zeros), bf16 x.
// Kernel #13: the same with an int8 weight-only q8 (bytes for nibbles).
//
// Replaces the Pallas kernel diffusionkit_tpu/ops/int4_matmul.py:int4_matmul
// (_kernel). q4 is (K/8, N) 32-bit words; nibble j of word r is row 8r + j
// (bits [4j, 4j+4)). scales and zeros are fp32 (K/g, N) and w = q*s + z. As
// in the reference, the weight is dequantised in fp32 (a product and a sum,
// each rounded: no FMA), ROUNDED TO BF16 before the product, the product is
// accumulated in fp32 and the output rounded to bf16 once.
//
// Two main loops run it: at M > 16 int4_matmul_sm90.cu (TMA, bf16 wgmma,
// warp specialisation; its note), and here the AdaLN `ada` GEMVs (M <= 16,
// ops/int4_matmul.py routes by M), bound by reading the 4-bit weights (28
// MB per dual-block `ada`); a 16-row tile keeps the wasted tensor-core work
// small there.
//
// Tiling: 256 threads (8 warps), BN = 128 columns, BK = 64 (a multiple of
// every group size taken: 32, or a multiple of 64, so a tile never straddles
// a group boundary it cannot see), BM = 16 (1 x 8 warps of 16 x 16).
// Per k tile: cp.async stages the x tile (16-byte chunks, rows past M
// zero-filled: no padded copy of x), the packed (8 x 128) words and their
// scale/zero rows into a double buffer, coalesced along N; the words of the
// current tile are dequantised from shared memory into Bs, stored [n][k]
// with rows padded by 8 so both the 16-byte dequant stores and the ldmatrix
// fragment loads are bank-conflict free; then mma.sync m16n8k16 (bf16 in,
// fp32 out) with A and B fragments from ldmatrix. The ragged M edge is
// masked at the store. K and N that the tiling does not take are refused.
//
// #13 replaces diffusionkit_tpu/ops/int4_matmul.py:int8_matmul (_kernel8):
// q8 is uint8 (K, N), values 0..255 (loaded unsigned), w = q*s + z in fp32
// (each step rounded) and rounded to bf16, as C. It shares C's main loop:
// cp.async stages the (64 x 128) byte tile, coalesced along N; each thread
// gathers 8 consecutive k of one column (8 byte loads, a warp on 32
// consecutive bytes: conflict-free) and writes them dequantised as one
// 16-byte store into Bs[n][k]. One byte a weight instead of half: at the
// M = 2 `ada` GEMVs it reads 14 MB (SD3 medium's 1536 x 9216) and is bound
// by that.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64, BN = 128, NTHREADS = 256;
constexpr int LDA = BK + 8, LDB = BK + 8;  // padded shared rows (elements)
constexpr int QROWS = BK / 8;              // packed word rows per k tile
constexpr int SROWS = 2;                   // scale rows per k tile (group 32 -> 2)

// BITS = 4: (QROWS x BN) packed words a stage; BITS = 8: (BK x BN) bytes.
template <int BITS, int BM>
struct Smem {
  static constexpr size_t a = 2 * (size_t)BM * LDA * sizeof(bf16);
  static constexpr size_t q = BITS == 4 ? 2 * (size_t)QROWS * BN * 4 : 2 * (size_t)BK * BN;
  static constexpr size_t s = 2 * (size_t)SROWS * BN * 4;
  static constexpr size_t b = (size_t)BN * LDB * sizeof(bf16);
  static constexpr size_t bytes = a + q + 2 * s + b;
};

template <int BITS, int WARPS_M, int MT, int NT>
__device__ __forceinline__ void dequant_mm(const bf16* __restrict__ x, const void* __restrict__ qw,
                                           const float* __restrict__ scales,
                                           const float* __restrict__ zeros, bf16* __restrict__ y,
                                           int M, int N, int K, int group, long long lda) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = WARPS_M * MT * 16;
  static_assert(WARPS_N * NT * 8 == BN, "warp tiles must cover BN");
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
  using L = Smem<BITS, BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);                    // [2][BM][LDA]
  uint32_t* Qs = reinterpret_cast<uint32_t*>(smem + L::a);     // [2][QROWS][BN] (BITS 4)
  uint8_t* Q8s = smem + L::a;                                  // [2][BK][BN] (BITS 8)
  const uint32_t* q4 = static_cast<const uint32_t*>(qw);
  const uint8_t* q8 = static_cast<const uint8_t*>(qw);
  float* Ss = reinterpret_cast<float*>(smem + L::a + L::q);    // [2][SROWS][BN]
  float* Zs = Ss + 2 * SROWS * BN;                             // [2][SROWS][BN]
  bf16* Bs = reinterpret_cast<bf16*>(smem + L::a + L::q + 2 * L::s);  // [BN][LDB]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int srows = group < BK ? BK / group : 1;
  const int KT = K / BK;

  auto load_stage = [&](int kt, int buf) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * (BK / 8); c += NTHREADS) {
      const int r = c >> 3, col = (c & 7) * 8;
      const int row = m0 + r;
      const bf16* src = x + (long long)(row < M ? row : 0) * lda + k0 + col;
      dk::cp_async16(&As[(buf * BM + r) * LDA + col], src, row < M ? 16 : 0);
    }
    if constexpr (BITS == 4) {  // QROWS x BN words: one 16-byte chunk per thread
      const int r = tid >> 5, col = (tid & 31) * 4;
      dk::cp_async16(&Qs[(buf * QROWS + r) * BN + col],
                     q4 + (long long)(k0 / 8 + r) * N + n0 + col, 16);
    } else {  // BK x BN bytes: two 16-byte chunks per thread
      for (int c = tid; c < BK * (BN / 16); c += NTHREADS) {
        const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
        dk::cp_async16(&Q8s[(buf * BK + r) * BN + col], q8 + (long long)(k0 + r) * N + n0 + col,
                       16);
      }
    }
    if (tid < srows * 32) {
      const int r = tid >> 5, col = (tid & 31) * 4;
      const long long off = (long long)(k0 / group + r) * N + n0 + col;
      dk::cp_async16(&Ss[(buf * SROWS + r) * BN + col], scales + off, 16);
      dk::cp_async16(&Zs[(buf * SROWS + r) * BN + col], zeros + off, 16);
    }
    dk::cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

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

    {  // Dequantise this tile's words into Bs[n][k]: thread -> word row r,
       // columns l, l+32, l+64, l+96; one 16-byte store of 8 k values each.
      const int r = tid >> 5, l = tid & 31;
      const int srow = group < BK ? (8 * r) / group : 0;
      const uint32_t* qrow = &Qs[(buf * QROWS + r) * BN];
      const uint8_t* q8rows = &Q8s[(buf * BK + 8 * r) * BN];
      const float* sp = &Ss[(buf * SROWS + srow) * BN];
      const float* zp = &Zs[(buf * SROWS + srow) * BN];
#pragma unroll
      for (int i = 0; i < BN / 32; ++i) {
        const int n = l + 32 * i;
        const float s = sp[n], z = zp[n];
        float q[8];
        if constexpr (BITS == 4) {
          const uint32_t w = qrow[n];
#pragma unroll
          for (int j = 0; j < 8; ++j) q[j] = (float)((w >> (4 * j)) & 0xFu);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) q[j] = (float)q8rows[j * BN + n];
        }
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo = __fadd_rn(__fmul_rn(q[2 * j], s), z);
          const float hi = __fadd_rn(__fmul_rn(q[2 * j + 1], s), z);
          p[j] = dk::pack_bf16(lo, hi);
        }
        *reinterpret_cast<uint4*>(&Bs[n * LDB + 8 * r]) = make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
    __syncthreads();

    const bf16* Ab = As + buf * BM * LDA;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        dk::ldmatrix_x4(a[mt], &Ab[(wm * MT * 16 + mt * 16 + (lane & 15)) * LDA + ks * 16 +
                                   (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        dk::ldmatrix_x4(r, &Bs[(wn * NT * 8 + np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDB +
                              ks * 16 + ((lane >> 3) & 1) * 8]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) dk::mma_bf16_16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    __syncthreads();  // As[buf] and Bs are free for the next tile
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = m0 + wm * MT * 16 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = n0 + wn * NT * 8 + nt * 8 + 2 * t;
      if (row < M)
        *reinterpret_cast<uint32_t*>(y + (long long)row * N + col) =
            dk::pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(y + (long long)(row + 8) * N + col) =
            dk::pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// Kernel C (int4 words) and kernel #13 (uint8 bytes): one body, two names.
template <int WARPS_M, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS)
    int4_mm(const bf16* __restrict__ x, const void* __restrict__ q4,
            const float* __restrict__ scales, const float* __restrict__ zeros,
            bf16* __restrict__ y, int M, int N, int K, int group, long long lda) {
  dequant_mm<4, WARPS_M, MT, NT>(x, q4, scales, zeros, y, M, N, K, group, lda);
}

template <int WARPS_M, int MT, int NT>
__global__ void __launch_bounds__(NTHREADS)
    int8_mm(const bf16* __restrict__ x, const void* __restrict__ q8,
            const float* __restrict__ scales, const float* __restrict__ zeros,
            bf16* __restrict__ y, int M, int N, int K, int group, long long lda) {
  dequant_mm<8, WARPS_M, MT, NT>(x, q8, scales, zeros, y, M, N, K, group, lda);
}

template <int BITS, int WARPS_M, int MT, int NT>
int launch(const void* x, const void* qw, const void* scales, const void* zeros, void* y, int M,
           int N, int K, int group, long long lda, cudaStream_t st) {
  constexpr int BM = WARPS_M * MT * 16;
  const size_t smem = Smem<BITS, BM>::bytes;
  auto kernel = BITS == 4 ? int4_mm<WARPS_M, MT, NT> : int8_mm<WARPS_M, MT, NT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, NTHREADS, smem, st>>>(
      static_cast<const bf16*>(x), qw, static_cast<const float*>(scales),
      static_cast<const float*>(zeros), static_cast<bf16*>(y), M, N, K, group, lda);
  return (int)cudaGetLastError();
}

template <int BITS>
int dispatch(const void* x, const void* qw, const void* scales, const void* zeros, void* y,
             int M, int N, int K, int group, long long lda, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % BN || K % BK || group <= 0 || K % group ||
      !(group == 32 || group % BK == 0) || lda < K || lda % 8 || M > 65535 * 128)
    return (int)cudaErrorInvalidValue;
  if (M > 16) return (int)cudaErrorInvalidValue;  // int4_matmul_sm90.cu's
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch<BITS, 1, 1, 2>(x, qw, scales, zeros, y, M, N, K, group, lda, st);
}

}  // namespace

// At M <= 16; the wrappers send M > 16 to the _sm90 entries
// (int4_matmul_sm90.cu), which take the same arguments.
extern "C" int dk_int4_matmul_bf16(const void* x, const void* q4, const void* scales,
                                   const void* zeros, void* y, int M, int N, int K, int group,
                                   long long lda, void* stream) {
  return dispatch<4>(x, q4, scales, zeros, y, M, N, K, group, lda, stream);
}

extern "C" int dk_int8_matmul_bf16(const void* x, const void* q8, const void* scales,
                                   const void* zeros, void* y, int M, int N, int K, int group,
                                   long long lda, void* stream) {
  return dispatch<8>(x, q8, scales, zeros, y, M, N, K, group, lda, stream);
}
