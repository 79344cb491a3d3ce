// Non-causal flash attention over bf16 q/k/v read in place through strides:
// the C entry points of kernel B, #14 and #15.
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
// The kernels live elsewhere, each source with its own note: kernel B and
// #15 at d = 64 and 128, and #14 at d = 64 and 128, in
// flash_attention_sm90.cu (TMA, wgmma); kernel B and #15 at d = 512 in
// flash_attention_wide_sm90.cu (its own entry point); the fp32 kernels in
// flash_attention_f32.cu. This file checks the arguments and routes.

#include "common.cuh"

// Kernel B and #15 at d = 64 and 128: csrc/flash_attention_sm90.cu.
int dk_flash_attn_sm90_bf16(const void* q, const void* k, const void* v, void* o, int B, int S,
                            int H, int D, const long long (&strides)[12], float sc,
                            bool scale_first, void* stream);
// #14 at d = 64 and 128: csrc/flash_attention_sm90.cu.
int dk_flash_attn_stats_sm90_bf16(const void* q, const void* k, const void* v, float* o,
                                  float* m, float* l, int B, int H, int Sq, int Skv, int D,
                                  int vlen, const long long (&strides)[12], float scale,
                                  void* stream);

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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
  if (bad_dims(B, H, scale) || Sq <= 0 || Skv <= 0 || vlen < 0 || vlen > Skv ||
      (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  return dk_flash_attn_stats_sm90_bf16(q, k, v, static_cast<float*>(o), static_cast<float*>(m),
                                       static_cast<float*>(l), B, H, Sq, Skv, D, vlen,
                                       {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss,
                                        osh},
                                       scale, stream);
}
