// K-split int4 GEMV with optional RMSNorm prologue and residual epilogue, for sm_90a.
//
// Replaces: `_int4_matmul_kernel` / `_pallas_int4_matmul`,
// uniaudio2_tpu/ops/quant.py:577-674.
//
//   out (M, N) = [rmsnorm(x)] (M, K) @ unpack(W) (K, N) * scale (N,) [+ res]
//
// W is (K/2, ldw) int8 in the layout the quantizer writes: byte [r, c]
// holds row r of column c in its low nibble and row r + K/2 in its high
// nibble. The Pallas kernel takes two dots over the K halves and scales
// the f32 sum; here the low level multiplies x[r] and the high one
// x[K/2 + r], unscaled, in f32, and the epilogue applies the scale, then
// the residual, then one cast.
//
// Bound: weight bytes (K*N/2) at decode, M = 1 or 2. A prefill of more than
// 128 rows sends every projection here with M = 255 or 511: each tile of 4
// rows reads the weights again (through L2), and the bound is then the
// 2*M*K*N operations.
//
// Design: at decode (M <= 16) the split-K cluster kernel of
// gemv_int4_splitk.cuh, whose staged activations follow the K-split
// pairing (byte row r: x[r] with the low level, x[K/2 + r] with the high),
// with the plan chosen on the host from the shape and the SM count
// (`quant.gemv_plan`); above that the tiled template of gemv_common.cuh,
// which `ua2_gemv_int4_tiled` also launches on its own.
#include "gemv_int4_splitk.cuh"

// splits = 0: the tiled instance; else the split-K kernel with `splits`
// K-slices of `span` byte rows and `mt` activation rows a block.
extern "C" int ua2_gemv_int4(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    int splits, int mt, int span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits == 0)
    return ua2::launch_gemv<ua2::K4, false>(x, w, scale, norm_w, residual, out, M, K,
                                             N, ldw, G, eps, out_f32, s);
  return ua2::splitk::launch<ua2::K4, false>(x, w, scale, norm_w, residual, out, M, K,
                                              N, ldw, G, eps, out_f32, splits, mt, span,
                                              s);
}

// The tiled instance at any M (the prefill's kernel, and the yardstick the
// split-K kernel is timed against).
extern "C" int ua2_gemv_int4_tiled(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2_gemv_int4(x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps,
                       out_f32, 0, 0, 0, stream);
}
