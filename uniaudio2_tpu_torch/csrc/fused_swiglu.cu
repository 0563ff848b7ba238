// Fused SwiGLU MLP half-block over quantized weights, for sm_90a:
//
//   out (M, N) = [res +] (silu(n(x) @ W1 * s1) * (n(x) @ W2 * s2)) @ W3 * s3
//
// Replaces: `_kernel` / `fused_swiglu`, uniaudio2_tpu/ops/fused_mlp.py:41-166
// and 225-406, in every weight form it has. Gate and up (W1, W2, one type):
// int8 (K, I), K-split int4 (K/2, I) or row-interleaved int4 (K/2, I), the
// int4 forms with per-channel (I,) or grouped (G12, I) scales. Down (W3):
// int8 (I, ldw3), column-packed int4 (I, ldw3 >= N/2) or row-interleaved
// int4 (I/2, ldw3), the int4 forms per-channel (N,) or grouped (G3, N).
//
// Bound: weight bytes (int4: 3*K*I/2, 37.7 MB for the backbone's 3072 ->
// 8192 -> 3072, 25.2 MB for the decoder's 2048 -> 8192 -> 2048; int8 twice
// that; grouped scales add 6 %).
//
// The Pallas kernel walks I in chunks on a sequential grid and carries the
// W3 product in an f32 scratch accumulator. Blocks on the GPU run in no
// order, so this is two deterministic passes instead (both are one call of
// the Python wrapper):
//   pass 1 (swiglu_up_kernel): blocks own 64 columns of I; each stages the
//     normed rows once and streams the matching W1 and W2 columns together,
//     then writes h = bf16(silu(a) * b) with a, b kept in f32 (the Pallas
//     kernel rounds only h). h is M x I bf16, 16 KB at M = 1.
//   pass 2: the GEMV of gemv_common.cuh over h in W3's layout, with the s3
//     scale and the residual folded in the epilogue. Grouped W3 scales are
//     chunk-local blocks in the Pallas kernel; here they are simply
//     scale[row / group, column]. The column-packed form writes true output
//     columns, not the Pallas scratch's [low ++ pad][high ++ pad] order.
// No split-K and no atomics: the sum order is fixed from run to run.
#include "gemv_common.cuh"

namespace {

using ua2::MT;
using ua2::THREADS;

template <int COLS, int LAYOUT, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
swiglu_up_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w1,
                 const float* __restrict__ s1, const int8_t* __restrict__ w2,
                 const float* __restrict__ s2, const __nv_bfloat16* __restrict__ nw,
                 __nv_bfloat16* __restrict__ h, int M, int K, int I, int G,
                 float eps) {
  constexpr int TN = 32 * COLS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + ua2::align16(MT * K * 2));
  float* st = red + 2 * ua2::WARPS * MT * TN;
  const int col0 = blockIdx.x * TN, m0 = blockIdx.y * MT;
  ua2::stage_rows(x, nw, M, K, m0, eps, xs, red);
  if (GROUPED) {
    ua2::stage_scales<COLS, LAYOUT>(s1, I, G, col0, st);
    ua2::stage_scales<COLS, LAYOUT>(s2, I, G, col0, st + G * TN);
  }
  float acc[2][MT][COLS] = {};
  const int8_t* const ws[2] = {w1, w2};
  ua2::gemv_partial<COLS, 2, LAYOUT, GROUPED>(
      xs, K, ws, I, col0 + (threadIdx.x & 31) * COLS, st, G, acc);
  ua2::park_partials<COLS, 2>(acc, red);
  for (int t = threadIdx.x; t < MT * TN; t += THREADS) {
    const int m = t / TN, c = col0 + t % TN, row = m0 + m;
    if (row >= M || c >= I) continue;
    float a = ua2::warp_total<COLS>(red, 0, t);
    float b = ua2::warp_total<COLS>(red, 1, t);
    if (!GROUPED) {
      a *= s1[c];
      b *= s2[c];
    }
    const float silu = a / (1.f + expf(-a));
    h[(size_t)row * I + c] = __float2bfloat16(silu * b);
  }
}

template <int LAYOUT, bool GROUPED>
int launch_up(const void* x, const void* w1, const void* s1, const void* w2,
              const void* s2, const void* nw, void* h, int M, int K, int I, int G,
              float eps, cudaStream_t s) {
  constexpr int COLS = 2, TN = 32 * COLS;
  const dim3 grid((I + TN - 1) / TN, (M + MT - 1) / MT);
  const int smem = ua2::smem_bytes(K, COLS, 2, 0, G);
  cudaError_t e = ua2::allow_smem(swiglu_up_kernel<COLS, LAYOUT, GROUPED>, smem);
  if (e != cudaSuccess) return (int)e;
  swiglu_up_kernel<COLS, LAYOUT, GROUPED><<<grid, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w1),
      static_cast<const float*>(s1), static_cast<const int8_t*>(w2),
      static_cast<const float*>(s2), static_cast<const __nv_bfloat16*>(nw),
      static_cast<__nv_bfloat16*>(h), M, K, I, G, eps);
  return (int)cudaGetLastError();
}

// Pass 2: the GEMV over h in W3's layout (int8, row-interleaved or
// column-packed) and scale mode.
int launch_down(int layout, const void* h, const void* w, const void* scale,
                const void* res, void* out, int M, int K, int N, int ldw, int G,
                float eps, cudaStream_t s) {
  switch (layout * 2 + (G > 0)) {
    case ua2::INT8 * 2:
      return ua2::launch_gemv<ua2::INT8, false>(h, w, scale, nullptr, res, out, M, K, N,
                                                ldw, G, eps, 0, s);
    case ua2::I4 * 2:
      return ua2::launch_gemv<ua2::I4, false>(h, w, scale, nullptr, res, out, M, K, N,
                                              ldw, G, eps, 0, s);
    case ua2::I4 * 2 + 1:
      return ua2::launch_gemv<ua2::I4, true>(h, w, scale, nullptr, res, out, M, K, N,
                                             ldw, G, eps, 0, s);
    case ua2::C4 * 2:
      return ua2::launch_gemv<ua2::C4, false>(h, w, scale, nullptr, res, out, M, K, N,
                                              ldw, G, eps, 0, s);
    case ua2::C4 * 2 + 1:
      return ua2::launch_gemv<ua2::C4, true>(h, w, scale, nullptr, res, out, M, K, N,
                                             ldw, G, eps, 0, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// layout12 is one of ua2::INT8, I4, K4 and layout3 one of INT8, I4, C4; G12
// and G3 are the numbers of scale groups of W1 / W2 and of W3 (0 =
// per-channel).
extern "C" int ua2_fused_swiglu(const void* x, const void* w1, const void* s1,
                                const void* w2, const void* s2, const void* w3,
                                const void* s3, const void* norm_w,
                                const void* residual, void* h, void* out, int M,
                                int K, int I, int N, int ldw3, int layout12, int G12,
                                int layout3, int G3, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout3 != ua2::INT8 && layout3 != ua2::I4 && layout3 != ua2::C4)
    return (int)cudaErrorInvalidValue;
  int e;
  switch (layout12 * 2 + (G12 > 0)) {
    case ua2::INT8 * 2:
      e = launch_up<ua2::INT8, false>(x, w1, s1, w2, s2, norm_w, h, M, K, I, G12, eps, s);
      break;
    case ua2::I4 * 2:
      e = launch_up<ua2::I4, false>(x, w1, s1, w2, s2, norm_w, h, M, K, I, G12, eps, s);
      break;
    case ua2::I4 * 2 + 1:
      e = launch_up<ua2::I4, true>(x, w1, s1, w2, s2, norm_w, h, M, K, I, G12, eps, s);
      break;
    case ua2::K4 * 2:
      e = launch_up<ua2::K4, false>(x, w1, s1, w2, s2, norm_w, h, M, K, I, G12, eps, s);
      break;
    case ua2::K4 * 2 + 1:
      e = launch_up<ua2::K4, true>(x, w1, s1, w2, s2, norm_w, h, M, K, I, G12, eps, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != (int)cudaSuccess) return e;
  return launch_down(layout3, h, w3, s3, residual, out, M, I, N, ldw3, G3, eps, s);
}
