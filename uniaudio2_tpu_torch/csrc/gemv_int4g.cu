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
// at decode; operations at a prefill of more than 128 rows. The block stages
// its (G, 64) tile of the scales in shared memory once (6 KB at K = 3072).
#include "gemv_common.cuh"

extern "C" int ua2_gemv_int4g(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2::launch_gemv<ua2::K4, true>(x, w, scale, norm_w, residual, out, M, K,
                                          N, ldw, G, eps, out_f32,
                                          static_cast<cudaStream_t>(stream));
}
