// Column-packed int4 GEMV, for sm_90a.
//
// Replaces: `_int4c_matmul_kernel` / `_pallas_int4c_matmul`,
// uniaudio2_tpu/ops/quant.py:789-850.
//
//   out (M, N) = x (M, K) @ unpack(W) (K, N) * scale (N,)
//
// W is (K, ldw) int8, ldw >= ceil(N/2): byte [k, c] holds column c in its
// low nibble and column N/2 + c in its high nibble, the layout of the MLP
// down-projection under int4 (8192 -> 3072 or 2048). One byte feeds two
// far-apart output columns, so the epilogue writes column c (c < N/2) and
// column N/2 + c (c < N - N/2); the Pallas kernel's (2, M, halfpad) block
// and its re-concatenation do not exist here. `quant.matmul` calls it with
// neither norm nor residual, as the Pallas kernel has neither (the fused
// SwiGLU's second pass runs the tiled template with a residual, which it
// adds in f32 before the one rounding).
//
// Two kernels behind one entry point, as the host's plan says
// (`quant.tc_plan`, splits = 0: the tiled one):
//  * above quant.SPLITK_MAX_M rows, the tensor-core tile kernel of
//    gemv_int4_tc.cuh (a prefill of more than 128 rows: bound by
//    operations);
//  * at up to 16 rows, at shapes the tile kernel does not take, and for a
//    call with a norm or a residual (its C4 instance folds neither), the
//    tiled template of gemv_common.cuh (bound by weight bytes at M <= 2);
//    `ua2_gemv_int4c_tiled` launches it at any M (the yardstick).
#include "gemv_int4_tc.cuh"

extern "C" int ua2_gemv_int4c(const void* x, const void* w, const void* scale,
                              const void* norm_w, const void* residual, void* out, int M,
                              int K, int N, int ldw, int G, float eps, int out_f32, int splits,
                              int span, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits == 0 || norm_w != nullptr || residual != nullptr)
    return ua2::launch_gemv<ua2::C4, false>(x, w, scale, norm_w, residual, out, M, K, N,
                                            ldw, G, eps, out_f32, st);
  return ua2::tc::launch<ua2::C4, false>(x, w, scale, nullptr, nullptr, out, nullptr, M, K,
                                        N, ldw, G, eps, out_f32, splits, span, st);
}

extern "C" int ua2_gemv_int4c_tiled(const void* x, const void* w, const void* scale,
                                    const void* norm_w, const void* residual, void* out,
                                    int M, int K, int N, int ldw, int G, float eps,
                                    int out_f32, void* stream) {
  return ua2::launch_gemv<ua2::C4, false>(x, w, scale, norm_w, residual, out, M, K, N,
                                          ldw, G, eps, out_f32,
                                          static_cast<cudaStream_t>(stream));
}

// The clusters of `splits` blocks of the tile kernel that the card holds at
// once (cudaOccupancyMaxActiveClusters), into *clusters: what the plan's
// one-wave rule (`quant.tc_wave`) approximates from the SM count. Every
// instance of the kernel takes the same threads and shared memory.
extern "C" int ua2_tc_max_clusters(int splits, int* clusters) {
  auto kernel = ua2::tc::gemv_tc_kernel<ua2::C4, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ua2::tc::SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits, 1);
  cfg.blockDim = dim3(ua2::tc::THREADS);
  cfg.dynamicSmemBytes = ua2::tc::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}
