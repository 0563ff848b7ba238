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
// 16 rows (configuration D's QKV projection with its norm, attn_proj with
// its residual, and above 128 rows gate, up and down, at M = 63 to 510) is
// bound by its 2*M*K*N operations (8.1 us for the QKV projection at
// M = 255).
//
// Design, one launch of the kernel the host's plan names (two with a row
// kernel):
//  * at decode (M <= 16) the split-K cluster kernel of
//    gemv_int4_splitk.cuh, whose staged activations follow the K-split
//    pairing (byte row r: x[r] with the low level, x[K/2 + r] with the
//    high), with the plan chosen on the host from the shape and the SM
//    count (`quant.gemv_plan`);
//  * above that the tensor-core tile kernel of gemv_int4_tc.cuh
//    (`quant.tc_plan`), after its row kernel has written x in the k order
//    x[0], x[K/2], x[1], x[K/2 + 1], ... (normalised when the call folds a
//    norm) into the scratch buffer `xn`, as for gemv_int4g.cu; the
//    per-channel scale and the residual are applied in the epilogue, on
//    the f32 sum;
//  * the tiled template of gemv_common.cuh, which `ua2_gemv_int4_tiled`
//    launches on its own at any M (the yardstick), takes what the plan
//    sends it: shapes the tile kernel does not take (K % 8).
#include "gemv_int4_splitk.cuh"
#include "gemv_int4_tc.cuh"

// splits = 0: the tiled instance; else `splits` K-slices of `span` rows and
// `mt` activation rows a block: mt = splitk::MROWS the split-K kernel
// (span in byte rows), mt = tc::BN the tile kernel (span in input rows of
// the reordered x, `xn` its scratch).
extern "C" int ua2_gemv_int4(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    int splits, int mt, int span, void* xn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits == 0)
    return ua2::launch_gemv<ua2::K4, false>(x, w, scale, norm_w, residual, out, M, K,
                                             N, ldw, G, eps, out_f32, s);
  if (mt == ua2::tc::BN)
    return ua2::tc::launch<ua2::K4, false>(x, w, scale, norm_w, residual, out, xn, M, K,
                                            N, ldw, G, eps, out_f32, splits, span, s);
  return ua2::splitk::launch<ua2::K4, false>(x, w, scale, norm_w, residual, out, M, K,
                                              N, ldw, G, eps, out_f32, splits, mt, span,
                                              s);
}

// The tiled instance at any M (the yardstick the split-K and tile kernels
// are timed against).
extern "C" int ua2_gemv_int4_tiled(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2_gemv_int4(x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps,
                       out_f32, 0, 0, 0, nullptr, stream);
}
