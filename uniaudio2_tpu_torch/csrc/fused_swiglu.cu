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
// Bound: weight bytes at decode (int4: 3*K*I/2, 37.7 MB for the backbone's
// 3072 -> 8192 -> 3072, 11.3 us at 3.35 TB/s; 25.2 MB for the decoder's
// 2048 -> 8192 -> 2048; int8 twice that; grouped scales add 6 %). At the
// bucket-64 prefill the 6*M*K*I operations reach it: 9.5 GFLOP (9.7 us at
// 989 TFLOP/s) at M = 63, 19.0 at the CFG pair's 126, bound by operations.
//
// The Pallas kernel walks I in chunks on a sequential grid and carries the
// W3 product in an f32 scratch accumulator. Blocks on the GPU run in no
// order, so a call is two deterministic passes, one call of the Python
// wrapper (`fused_mlp.fused_swiglu`, planned by `fused_mlp.swiglu_plan`):
//  * at decode (M <= quant.SPLITK_MAX_M = 16), `ua2_fused_swiglu`: two
//    launches of the split-K cluster kernel of gemv_int4_splitk.cuh, in
//    every weight form. Pass 1 covers 2 I / 64
//    column tiles, the first I / 64 reading W1 and its scale, the rest W2,
//    with the RMSNorm prologue, and writes a = n(x) W1 s1 and b = n(x) W2 s2
//    in f32 to a workspace `ab` (M, 2 I) (64 KB at M = 1). Pass 2 runs over
//    W3 (I4, C4 or INT8), staging bf16(silu(a) * b) of its K-slice where
//    pass 1 staged bf16(n(x)), and adds the residual in the epilogue;
//  * above that (the bucket-64 prefill: 63 rows, 126 for a CFG pair; up
//    to the 128 `fused_mlp.can_fuse` takes), `ua2_fused_swiglu_tc`: two
//    launches of the tensor-core tile kernel of gemv_int4_tc.cuh (a norm
//    adds its `rows_kernel` first). Pass 1 is its instance of its own,
//    `swiglu_tc_kernel`: a block's two warpgroups take the same 64 columns
//    of I, of W1 and of W2, and its epilogue writes h = bf16(silu(a) * b)
//    (M, I) after the cluster's rank-order sum, with a, b in f32; K4 reads
//    the k order x has, so it sums what I4 sums in I4's order, and the
//    K-split and interleaved trees of the same levels get the same h.
//    Pass 2 is the served tile GEMV over h in W3's layout (I4, C4 or
//    INT8), the residual in its epilogue. Both plans come from the host
//    (`fused_mlp.swiglu_plan`: I4's `quant.tc_plan` over 2 I columns, and
//    W3's), equal for C4 and I4 at an even N, so C4 and I4 give the same
//    output bits too;
//  * `ua2_fused_swiglu_tiled`, the first design, the yardstick at any M:
//    two tiled passes (swiglu_up_kernel: blocks own 64 columns of I, stage
//    the normed rows once and stream the matching W1 and W2 columns
//    together on the CUDA cores, then write h = bf16(silu(a) * b) with a,
//    b kept in f32; then the tiled GEMV of gemv_common.cuh over h with the
//    s3 scale and the residual folded in the epilogue).
// The rounding is the same in all: a and b in f32 (the Pallas kernel
// rounds only h), h rounded once to bf16; grouped levels are scaled in f32
// and rounded to bf16 before the product. The column-packed form writes
// true output columns, not the Pallas scratch's [low ++ pad][high ++ pad]
// order, and its grouped W3 scales are scale[row / group, column] (chunk-
// local blocks in the Pallas kernel). The split-K and tile passes' partial
// sums meet in rank order through distributed shared memory: no atomics,
// the same bits every run.
#include "gemv_common.cuh"
#include "gemv_int4_splitk.cuh"
#include "gemv_int4_tc.cuh"

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

// The two tiled passes. layout12 is one of ua2::INT8, I4, K4 and layout3 one
// of INT8, I4, C4; G12 and G3 are the numbers of scale groups of W1 / W2 and
// of W3 (0 = per-channel); h (M, I) bf16 the workspace between the passes.
extern "C" int ua2_fused_swiglu_tiled(const void* x, const void* w1, const void* s1,
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

namespace {

// Pass 1 at decode: the split-K kernel over W1 | W2 into ab (M, 2 I) f32.
int splitk_up(int layout, int G, const ua2::splitk::Args& a, int splits,
              cudaStream_t s) {
  namespace sk = ua2::splitk;
  switch (layout * 2 + (G > 0)) {
    case ua2::INT8 * 2: return sk::launch_args<ua2::INT8, false, sk::UP>(a, splits, sk::MROWS, s);
    case ua2::I4 * 2: return sk::launch_args<ua2::I4, false, sk::UP>(a, splits, sk::MROWS, s);
    case ua2::I4 * 2 + 1: return sk::launch_args<ua2::I4, true, sk::UP>(a, splits, sk::MROWS, s);
    case ua2::K4 * 2: return sk::launch_args<ua2::K4, false, sk::UP>(a, splits, sk::MROWS, s);
    case ua2::K4 * 2 + 1: return sk::launch_args<ua2::K4, true, sk::UP>(a, splits, sk::MROWS, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Pass 2 at decode: the split-K kernel over W3, staging h from ab.
int splitk_down(int layout, int G, const ua2::splitk::Args& a, int splits,
                cudaStream_t s) {
  namespace sk = ua2::splitk;
  switch (layout * 2 + (G > 0)) {
    case ua2::INT8 * 2: return sk::launch_args<ua2::INT8, false, sk::SWIGLU>(a, splits, sk::MROWS, s);
    case ua2::I4 * 2: return sk::launch_args<ua2::I4, false, sk::SWIGLU>(a, splits, sk::MROWS, s);
    case ua2::I4 * 2 + 1: return sk::launch_args<ua2::I4, true, sk::SWIGLU>(a, splits, sk::MROWS, s);
    case ua2::C4 * 2: return sk::launch_args<ua2::C4, false, sk::SWIGLU>(a, splits, sk::MROWS, s);
    case ua2::C4 * 2 + 1: return sk::launch_args<ua2::C4, true, sk::SWIGLU>(a, splits, sk::MROWS, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The fused SwiGLU at decode as the host's plan says (`fused_mlp.swiglu_plan`):
// the two split-K passes, pass 1 `splits1` K-slices of `span1` pair rows of
// K, pass 2 `splits3` of `span3` of I. W1 and W2 are (K or K/2, I) of one
// layout and G12 groups, unpadded; W3 (I or I/2, ldw3). ab (M, 2 I) f32 is
// the workspace between the passes, allocated by the caller.
extern "C" int ua2_fused_swiglu(const void* x, const void* w1, const void* s1,
                                const void* w2, const void* s2, const void* w3,
                                const void* s3, const void* norm_w,
                                const void* residual, void* ab, void* out, int M,
                                int K, int I, int N, int ldw3, int layout12, int G12,
                                int layout3, int G3, float eps, int splits1, int span1,
                                int splits3, int span3, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ab == nullptr) return (int)cudaErrorInvalidValue;
  ua2::splitk::Args up = {};
  up.x = static_cast<const __nv_bfloat16*>(x);
  up.w = static_cast<const int8_t*>(w1);
  up.scale = static_cast<const float*>(s1);
  up.w2 = static_cast<const int8_t*>(w2);
  up.scale2 = static_cast<const float*>(s2);
  up.nw = static_cast<const __nv_bfloat16*>(norm_w);
  up.out = ab;
  up.M = M, up.K = K, up.N = 2 * I, up.n1 = I, up.ldw = I, up.G = G12;
  up.out_f32 = 1, up.span = span1, up.eps = eps;
  int e = splitk_up(layout12, G12, up, splits1, s);
  if (e != (int)cudaSuccess) return e;
  ua2::splitk::Args down = {};
  down.ab = static_cast<const float*>(ab);
  down.w = static_cast<const int8_t*>(w3);
  down.scale = static_cast<const float*>(s3);
  down.res = static_cast<const __nv_bfloat16*>(residual);
  down.out = out;
  down.M = M, down.K = I, down.N = N, down.n1 = N, down.ldw = ldw3, down.G = G3;
  down.span = span3, down.eps = eps;
  return splitk_down(layout3, G3, down, splits3, s);
}

// Pass 2 of the tile passes: the tile GEMV of W3's layout, through the
// served entry points of gemv_int8.cu and gemv_int4i.cu (with a plan of the
// tile kernel) and, for the column-packed layout, whose entry points keep
// a residual on the tiled template, through the tile kernel's launch.
extern "C" int ua2_gemv_int8(const void*, const void*, const void*, const void*,
                             const void*, void*, int, int, int, int, int, float, int, int,
                             int, int, void*, void*);
extern "C" int ua2_gemv_int4i(const void*, const void*, const void*, const void*,
                              const void*, void*, int, int, int, int, int, float, int, int,
                              int, int, void*, void*);

// The fused SwiGLU above the decode rows as the host's plan says
// (`fused_mlp.swiglu_plan`, kind "tile"): pass 1, `splits1` K-slices of
// `span1` input rows of K, writes h (M, I) bf16, the workspace the caller
// allocates (with a norm weight after `rows_kernel` has written the
// normalised rows into xn (M, K) bf16, also the caller's); pass 2, the
// tile GEMV of W3's layout over h, `splits3` slices of `span3` rows of I,
// adds the residual. W1 and W2 are (K or K/2, I) of one layout and G12
// groups, unpadded; W3 (I or I/2, ldw3).
extern "C" int ua2_fused_swiglu_tc(const void* x, const void* w1, const void* s1,
                                   const void* w2, const void* s2, const void* w3,
                                   const void* s3, const void* norm_w,
                                   const void* residual, void* xn, void* h, void* out,
                                   int M, int K, int I, int N, int ldw3, int layout12,
                                   int G12, int layout3, int G3, float eps, int splits1,
                                   int span1, int splits3, int span3, void* stream) {
  namespace tc = ua2::tc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h == nullptr) return (int)cudaErrorInvalidValue;
  int e;
  switch (layout12 * 2 + (G12 > 0)) {
    case ua2::INT8 * 2:
      e = tc::launch_up<ua2::INT8, false>(x, w1, s1, w2, s2, norm_w, xn, h, M, K, I, G12,
                                          eps, splits1, span1, s);
      break;
    case ua2::I4 * 2:
      e = tc::launch_up<ua2::I4, false>(x, w1, s1, w2, s2, norm_w, xn, h, M, K, I, G12,
                                        eps, splits1, span1, s);
      break;
    case ua2::I4 * 2 + 1:
      e = tc::launch_up<ua2::I4, true>(x, w1, s1, w2, s2, norm_w, xn, h, M, K, I, G12,
                                       eps, splits1, span1, s);
      break;
    case ua2::K4 * 2:
      e = tc::launch_up<ua2::K4, false>(x, w1, s1, w2, s2, norm_w, xn, h, M, K, I, G12,
                                        eps, splits1, span1, s);
      break;
    case ua2::K4 * 2 + 1:
      e = tc::launch_up<ua2::K4, true>(x, w1, s1, w2, s2, norm_w, xn, h, M, K, I, G12,
                                       eps, splits1, span1, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != (int)cudaSuccess) return e;
  const int bn = tc::BN;      // the row-packed entry points' mt of the tile kernel
  switch (layout3 * 2 + (G3 > 0)) {
    case ua2::INT8 * 2:
      return ua2_gemv_int8(h, w3, s3, nullptr, residual, out, M, I, N, ldw3, G3, eps, 0,
                           splits3, bn, span3, nullptr, stream);
    case ua2::I4 * 2:
    case ua2::I4 * 2 + 1:
      return ua2_gemv_int4i(h, w3, s3, nullptr, residual, out, M, I, N, ldw3, G3, eps, 0,
                            splits3, bn, span3, nullptr, stream);
    // the column-packed entry points send a residual to the tiled template
    case ua2::C4 * 2:
      return tc::launch<ua2::C4, false>(h, w3, s3, nullptr, residual, out, nullptr, M, I, N,
                                        ldw3, G3, eps, 0, splits3, span3, s);
    case ua2::C4 * 2 + 1:
      return tc::launch<ua2::C4, true>(h, w3, s3, nullptr, residual, out, nullptr, M, I, N,
                                       ldw3, G3, eps, 0, splits3, span3, s);
  }
  return (int)cudaErrorInvalidValue;
}
