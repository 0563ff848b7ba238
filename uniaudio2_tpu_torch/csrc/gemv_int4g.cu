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
// at decode; operations at a prefill (M = 63 to 510: 8.1 us for the QKV
// projection at M = 255).
//
// Design, one launch of the kernel the host's plan names (two at a
// prefill):
//  * at decode (M <= 16) the split-K cluster kernel of
//    gemv_int4_splitk.cuh (each block stages only its slice's groups of the
//    scales, low and high halves), with the plan chosen on the host from
//    the shape and the SM count (`quant.gemv_plan`);
//  * above that the tensor-core tile kernel of gemv_int4_tc.cuh
//    (`quant.tc_plan`), after its row kernel has written x in the k order
//    x[0], x[K/2], x[1], x[K/2 + 1], ... (normalised when the call folds a
//    norm) into the scratch buffer `xn`: a byte's two nibbles then meet
//    consecutive rows, as in the interleaved layout; the residual is added
//    in f32 before the one rounding;
//  * the tiled template of gemv_common.cuh (the block stages its (G, 64)
//    tile of the scales once, 6 KB at K = 3072), which
//    `ua2_gemv_int4g_tiled` launches on its own at any M (the yardstick),
//    takes what the plan sends it: shapes the tile kernel does not take
//    (K % 8, K/G % 16).
#include "gemv_int4_splitk.cuh"
#include "gemv_int4_tc.cuh"

// splits = 0: the tiled instance; else `splits` K-slices of `span` rows and
// `mt` activation rows a block: mt = splitk::MROWS the split-K kernel
// (span in byte rows), mt = tc::BN the tile kernel (span in input rows of
// the reordered x, `xn` its scratch).
extern "C" int ua2_gemv_int4g(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    int splits, int mt, int span, void* xn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits == 0)
    return ua2::launch_gemv<ua2::K4, true>(x, w, scale, norm_w, residual, out, M, K,
                                            N, ldw, G, eps, out_f32, s);
  if (mt == ua2::tc::BN)
    return ua2::tc::launch<ua2::K4, true>(x, w, scale, norm_w, residual, out, xn, M, K,
                                           N, ldw, G, eps, out_f32, splits, span, s);
  return ua2::splitk::launch<ua2::K4, true>(x, w, scale, norm_w, residual, out, M, K,
                                             N, ldw, G, eps, out_f32, splits, mt, span,
                                             s);
}

// The tiled instance at any M (the yardstick the split-K and tile kernels
// are timed against).
extern "C" int ua2_gemv_int4g_tiled(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2_gemv_int4g(x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps,
                        out_f32, 0, 0, 0, nullptr, stream);
}
