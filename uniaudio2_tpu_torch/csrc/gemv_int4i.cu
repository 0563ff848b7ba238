// Row-interleaved int4 GEMV with optional RMSNorm prologue and residual
// epilogue, for sm_90a.
//
// Replaces: `_int4i_matmul_kernel` / `_pallas_int4i_matmul`,
// uniaudio2_tpu/ops/quant.py:919-1038, with per-channel (G = 0) or grouped
// (G > 0) scales.
//
//   out (M, N) = [rmsnorm(x)] (M, K) @ unpack(W) (K, N) * scale [+ res]
//
// W is (K/2, ldw) int8: byte [r, c] holds row 2r of column c in its low
// nibble and row 2r+1 in its high nibble (levels -7..7); ldw >= N is the
// 512-aligned storage width and only the N = scale-width true columns are
// written. x, the norm weight and the residual are bf16; the output is
// bf16 or f32 (the audio-head logits). The scale is (N,) f32, applied to
// the f32 sum, or (G, N) f32, multiplied into the levels and rounded to
// bf16 before the product (both rows of a byte lie in group 2r / (K/G)).
//
// Bound: weight bytes. K*N/2 bytes per call (attn_proj 3072x3072: 4.7 MB,
// audio head 2048x12800: 13 MB), plus 4*G*N of scales when grouped (6 % at
// groups of 128 rows), against M*K*N multiply-adds, i.e. 2*M operations per
// byte, far below the card's ~295.
//
// Design: at decode (M <= 16) the split-K cluster kernel of
// gemv_int4_splitk.cuh, with the plan (K-slices, activation rows a block,
// slice length) chosen on the host from the shape and the SM count
// (`quant.gemv_plan`); above that (the prefills) the tiled template of
// gemv_common.cuh, which `ua2_gemv_int4i_tiled` also launches on its own.
#include "gemv_int4_splitk.cuh"

// splits = 0: the tiled instance; else the split-K kernel with `splits`
// K-slices of `span` byte rows and `mt` activation rows a block.
extern "C" int ua2_gemv_int4i(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    int splits, int mt, int span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits == 0)
    return G > 0 ? ua2::launch_gemv<ua2::I4, true>(x, w, scale, norm_w, residual, out,
                                                   M, K, N, ldw, G, eps, out_f32, s)
                 : ua2::launch_gemv<ua2::I4, false>(x, w, scale, norm_w, residual, out,
                                                    M, K, N, ldw, G, eps, out_f32, s);
  return G > 0 ? ua2::splitk::launch<ua2::I4, true>(x, w, scale, norm_w, residual, out,
                                                    M, K, N, ldw, G, eps, out_f32,
                                                    splits, mt, span, s)
               : ua2::splitk::launch<ua2::I4, false>(x, w, scale, norm_w, residual,
                                                     out, M, K, N, ldw, G, eps,
                                                     out_f32, splits, mt, span, s);
}

// The tiled instance at any M (the prefill's kernel, and the yardstick the
// split-K kernel is timed against).
extern "C" int ua2_gemv_int4i_tiled(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2_gemv_int4i(x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps,
                        out_f32, 0, 0, 0, stream);
}

extern "C" const char* ua2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
