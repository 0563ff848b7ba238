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
// read once per ASR frame; under int8 weights it is every projection
// outside the fused QKV and MLP steps (attn_proj with its residual, the
// decoder's projections, the audio heads, the projection) and, at every
// prefill, the QKV projection with the norm folded.
//
// Bound: weight bytes at decode (K*N: 395 MB for the lm_head, about 118 us
// at the H100's 3.35 TB/s; 9.4 MB for attn_proj 3072x3072) against M*K*N
// multiply-adds; at a prefill (M = 63 to 510) operations (8.1 us for the
// QKV projection 3072 -> 5120 at M = 255).
//
// Design, one launch of the kernel the host's plan names:
//  * at decode (M <= 16) the split-K cluster kernel of
//    gemv_int4_splitk.cuh in its INT8 layout (pairs of rows 16 s + j and
//    16 s + j + 8 in steps of 16, levels unpacked exactly under the f32
//    exponent of 2^23), with the plan (K-slices, slice length) chosen on
//    the host from the shape and the SM count (`quant.gemv_plan`);
//  * at decode over a wide output (the lm_head: 501 tiles of 256 columns
//    alone fill the grid the plan aims at) the split-K kernel's wide-N
//    mode, one slice, `ua2_gemv_int8_wide`: each warp walks all of K for
//    its own 64 columns, so a block reads 256 contiguous bytes of a row;
//  * above that (the prefills) the tensor-core tile kernel of
//    gemv_int4_tc.cuh in its INT8 layout (`quant.tc_plan`); a norm runs
//    first as its row kernel, into the scratch buffer `xn`; the scale and
//    the residual are added in f32 in the epilogue before the one rounding;
//  * the tiled template of gemv_common.cuh (two columns a lane, eight rows
//    in flight a warp, f32 FMAs on the CUDA cores), the first design, takes
//    what the plan sends it (K not a multiple of 16 at decode, of 8 above)
//    and is what `ua2_gemv_int8_tiled` launches at any M: the yardstick the
//    split-K and tile kernels are timed against.
#include "gemv_int4_splitk.cuh"
#include "gemv_int4_tc.cuh"

// splits = 0: the tiled instance; else `splits` K-slices of `span` rows and
// `mt` activation rows a block: mt = splitk::MROWS the split-K kernel
// (span in pairs of rows), mt = tc::BN the tile kernel (span in input rows,
// `xn` its scratch for a norm).
extern "C" int ua2_gemv_int8(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    int splits, int mt, int span, void* xn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits == 0)
    return ua2::launch_gemv<ua2::INT8, false>(x, w, scale, norm_w, residual, out, M, K,
                                              N, ldw, G, eps, out_f32, s);
  if (mt == ua2::tc::BN)
    return ua2::tc::launch<ua2::INT8, false>(x, w, scale, norm_w, residual, out, xn, M,
                                             K, N, ldw, G, eps, out_f32, splits, span, s);
  return ua2::splitk::launch<ua2::INT8, false>(x, w, scale, norm_w, residual, out, M, K,
                                               N, ldw, G, eps, out_f32, splits, mt, span,
                                               s);
}

// The split-K kernel's wide-N mode (`quant.gemv_plan`'s tile of 256 columns,
// one slice: splits = 1, mt = splitk::MROWS, M <= 16); `xn` is not read.
extern "C" int ua2_gemv_int8_wide(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    int splits, int mt, int span, void* xn, void* stream) {
  return ua2::splitk::launch<ua2::INT8, false, ua2::splitk::GEMV_WIDE>(
      x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps, out_f32, splits, mt,
      span, static_cast<cudaStream_t>(stream));
}

// The tiled instance at any M (the yardstick the split-K and tile kernels
// are timed against).
extern "C" int ua2_gemv_int8_tiled(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2_gemv_int8(x, w, scale, norm_w, residual, out, M, K, N, ldw, G, eps,
                       out_f32, 0, 0, 0, nullptr, stream);
}
