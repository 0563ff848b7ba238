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
// far-apart output columns, so a thread keeps two accumulator sets and the
// epilogue writes column c (c < N/2) and column N/2 + c (c < N - N/2); the
// Pallas kernel's (2, M, halfpad) block and its re-concatenation do not
// exist here. `quant.matmul` calls it with neither norm nor residual, as the
// Pallas kernel has neither (the fused SwiGLU's second pass does pass a
// residual, which this kernel adds in f32 before the one rounding).
//
// Bound: weight bytes (K*N/2) at M <= 128, where the fused SwiGLU runs it;
// alone it runs at a prefill of more than 128 rows, bound by operations.
#include "gemv_common.cuh"

extern "C" int ua2_gemv_int4c(const void* x, const void* w, const void* scale,
                    const void* norm_w, const void* residual, void* out, int M,
                    int K, int N, int ldw, int G, float eps, int out_f32,
                    void* stream) {
  return ua2::launch_gemv<ua2::C4, false>(x, w, scale, norm_w, residual, out, M, K,
                                          N, ldw, G, eps, out_f32,
                                          static_cast<cudaStream_t>(stream));
}
