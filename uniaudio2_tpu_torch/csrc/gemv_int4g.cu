// K-split int4 GEMV with group-wise scales, optional RMSNorm prologue and
// residual epilogue, for sm_90a.
//
// Replaces: `_int4g_matmul_kernel` / `_pallas_int4g_matmul`,
// uniaudio2_tpu/ops/quant.py:688-786 (and `_scale_rows`, :677-685).
//
//   out (M, N) = [rmsnorm(x)] (M, K) @ bf16(unpack(W) * scale[group]) [+ res]
//
// W as in gemv_int4.cu (byte [r, c] = row r low, row r + K/2 high); the
// scale is (G, N) f32, one per K/G input rows and column. Rows of the low
// nibbles take groups [0, G/2), rows of the high nibbles [G/2, G): byte row
// r uses scale[r / group] and scale[G/2 + r / group], so K/2 must hold
// whole groups. As in the Pallas kernel the level is multiplied by its f32
// scale and rounded to bf16 before the product, and nothing is scaled after
// the f32 sum: the arithmetic of the dequantize-then-product form, up to
// the order of the sum.
//
// Bound: weight bytes (K*N/2 + 4*G*N of scales, 6 % more at groups of 128)
// at decode; operations at a prefill of more than 128 rows.
//
// Design: at decode (M <= 16) the split-K cluster kernel of
// gemv_int4_splitk.cuh (each block stages only its slice's groups of the
// scales, low and high halves), with the plan chosen on the host from the
// shape and the SM count (`quant.gemv_plan`); above that the tiled template
// of gemv_common.cuh (the block stages its (G, 64) tile of the scales once,
// 6 KB at K = 3072), which `ua2_gemv_int4g_tiled` also launches on its own.
#include "gemv_int4_splitk.cuh"

// splits = 0: the tiled instance; else the split-K kernel with `splits`
// K-slices of `span` byte rows and `mt` activation rows a block.
extern "C" int ua2_gemv_int4g(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    int splits, int mt, int span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits == 0)
    return ua2::launch_gemv<ua2::K4, true>(x, w, scale, norm_w, residual, out, M, K,
                                            N, ldw, G, eps, out_f32, s);
  return ua2::splitk::launch<ua2::K4, true>(x, w, scale, norm_w, residual, out, M, K,
                                             N, ldw, G, eps, out_f32, splits, mt, span,
                                             s);
}

// The tiled instance at any M (the prefill's kernel, and the yardstick the
// split-K kernel is timed against).
extern "C" int ua2_gemv_int4g_tiled(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2_gemv_int4g(x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps,
                        out_f32, 0, 0, 0, stream);
}
