// Column-packed int4 GEMV with group-wise scales, for sm_90a.
//
// Replaces: `_int4cg_matmul_kernel` / `_pallas_int4cg_matmul`,
// uniaudio2_tpu/ops/quant.py:853-916.
//
//   out (M, N) = x (M, K) @ bf16(unpack(W) * scale[group]) (K, N)
//
// W as in gemv_int4c.cu; the scale is (G, N) f32. Byte [k, c] takes
// scale[k / group, c] for its low nibble and scale[k / group, N/2 + c] for
// its high one; each level is scaled in f32 and rounded to bf16 before the
// product, as the Pallas kernel rounds the scaled tile.
//
// Two kernels behind one entry point, as in gemv_int4c.cu: above
// quant.SPLITK_MAX_M rows the tensor-core tile kernel of gemv_int4_tc.cuh
// (which fetches each k-step's two scales of a thread a stage ahead; a
// group is a whole number of k-steps of 16), else (and for a call with a
// norm or a residual) the tiled template of gemv_common.cuh, which stages both (G, 64) scale tiles of a block in
// shared memory (32 KB at K = 8192); `ua2_gemv_int4cg_tiled` launches the
// tiled template at any M.
//
// Bound: as gemv_int4c.cu, plus 4*G*N bytes of scales.
#include "gemv_int4_tc.cuh"

extern "C" int ua2_gemv_int4cg(const void* x, const void* w, const void* scale,
                               const void* norm_w, const void* residual, void* out, int M,
                               int K, int N, int ldw, int G, float eps, int out_f32, int splits,
                               int span, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits == 0 || norm_w != nullptr || residual != nullptr)
    return ua2::launch_gemv<ua2::C4, true>(x, w, scale, norm_w, residual, out, M, K, N,
                                           ldw, G, eps, out_f32, st);
  return ua2::tc::launch<ua2::C4, true>(x, w, scale, nullptr, nullptr, out, nullptr, M, K,
                                        N, ldw, G, eps, out_f32, splits, span, st);
}

extern "C" int ua2_gemv_int4cg_tiled(const void* x, const void* w, const void* scale,
                                     const void* norm_w, const void* residual, void* out,
                                     int M, int K, int N, int ldw, int G, float eps,
                                     int out_f32, void* stream) {
  return ua2::launch_gemv<ua2::C4, true>(x, w, scale, norm_w, residual, out, M, K, N,
                                         ldw, G, eps, out_f32,
                                         static_cast<cudaStream_t>(stream));
}
