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
// Bound: weight bytes at decode. K*N/2 bytes per call (attn_proj
// 3072x3072: 4.7 MB, audio head 2048x12800: 13 MB), plus 4*G*N of scales
// when grouped (6 % at groups of 128 rows), against M*K*N multiply-adds,
// i.e. 2*M operations per byte, far below the card's ~295. At a prefill
// (M = 63 to 510: the QKV projection with the norm folded, attn_proj with
// the residual, gate, up and down above 128 rows) 126-1020 operations a
// byte: bound by operations (8.1 us for the QKV projection at M = 255).
//
// Design, one launch of the kernel the host's plan names:
//  * at decode (M <= 16) the split-K cluster kernel of
//    gemv_int4_splitk.cuh, with the plan (K-slices, activation rows a
//    block, slice length) chosen on the host from the shape and the SM
//    count (`quant.gemv_plan`);
//  * above that (the prefills) the tensor-core tile kernel of
//    gemv_int4_tc.cuh (`quant.tc_plan`): one interleaved byte is one A
//    register of its wgmma; a norm runs first as its row kernel, into the
//    scratch buffer `xn`; the residual is added in f32 before the one
//    rounding;
//  * the tiled template of gemv_common.cuh, which `ua2_gemv_int4i_tiled`
//    launches on its own at any M (the yardstick), takes what the plan
//    sends it: shapes the tile kernel does not take (K % 8, grouped
//    K/G % 16).
#include "gemv_int4_splitk.cuh"
#include "gemv_int4_tc.cuh"

// splits = 0: the tiled instance; else `splits` K-slices of `span` rows and
// `mt` activation rows a block: mt = splitk::MROWS the split-K kernel
// (span in byte rows), mt = tc::BN the tile kernel (span in input rows,
// `xn` its scratch for a norm).
extern "C" int ua2_gemv_int4i(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    int splits, int mt, int span, void* xn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits == 0)
    return G > 0 ? ua2::launch_gemv<ua2::I4, true>(x, w, scale, norm_w, residual, out,
                                                   M, K, N, ldw, G, eps, out_f32, s)
                 : ua2::launch_gemv<ua2::I4, false>(x, w, scale, norm_w, residual, out,
                                                    M, K, N, ldw, G, eps, out_f32, s);
  if (mt == ua2::tc::BN)
    return G > 0 ? ua2::tc::launch<ua2::I4, true>(x, w, scale, norm_w, residual, out, xn,
                                                  M, K, N, ldw, G, eps, out_f32, splits,
                                                  span, s)
                 : ua2::tc::launch<ua2::I4, false>(x, w, scale, norm_w, residual, out, xn,
                                                   M, K, N, ldw, G, eps, out_f32, splits,
                                                   span, s);
  return G > 0 ? ua2::splitk::launch<ua2::I4, true>(x, w, scale, norm_w, residual, out,
                                                    M, K, N, ldw, G, eps, out_f32,
                                                    splits, mt, span, s)
               : ua2::splitk::launch<ua2::I4, false>(x, w, scale, norm_w, residual,
                                                     out, M, K, N, ldw, G, eps,
                                                     out_f32, splits, mt, span, s);
}

// The tiled instance at any M (the yardstick the split-K and tile kernels
// are timed against).
extern "C" int ua2_gemv_int4i_tiled(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2_gemv_int4i(x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps,
                        out_f32, 0, 0, 0, nullptr, stream);
}

extern "C" const char* ua2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
