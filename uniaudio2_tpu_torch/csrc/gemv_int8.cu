// Per-channel int8 GEMV with optional RMSNorm prologue and residual
// epilogue, for sm_90a.
//
// Replaces: `_int8_matmul_kernel` / `_pallas_int8_matmul`,
// uniaudio2_tpu/ops/quant.py:463-565.
//
//   out (M, N) = [rmsnorm(x)] (M, K) @ W (K, N) * scale (N,) [+ res]
//
// W is (K, ldw) int8 with ldw >= N (512-aligned storage). Under int4
// weights it is the text lm_head, 3072 x 128256 (stored 128512), f32 logits,
// read once per ASR frame; under int8 weights it is every projection.
//
// Bound: weight bytes (K*N: 395 MB for the lm_head, about 118 us at the
// H100's 3.35 TB/s) against M*K*N multiply-adds. The shared design
// (gemv_common.cuh) reads each weight byte once, coalesced, two columns per
// lane, and spreads the 2004 column tiles of the lm_head over all SMs.
#include "gemv_common.cuh"

extern "C" int ua2_gemv_int8(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2::launch_gemv<ua2::INT8, false>(x, w, scale, norm_w, residual, out, M, K,
                                          N, ldw, G, eps, out_f32,
                                          static_cast<cudaStream_t>(stream));
}
