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
// product, as the Pallas kernel rounds the scaled tile. The block stages
// both (G, 64) scale tiles in shared memory (32 KB at K = 8192).
//
// Bound: as gemv_int4c.cu, plus 4*G*N bytes of scales.
#include "gemv_common.cuh"

extern "C" int ua2_gemv_int4cg(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2::launch_gemv<ua2::C4, true>(x, w, scale, norm_w, residual, out, M, K,
                                          N, ldw, G, eps, out_f32,
                                          static_cast<cudaStream_t>(stream));
}
