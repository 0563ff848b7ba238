// Fused decode-step QKV: RMSNorm -> quantized GEMV -> half-split RoPE on q
// and k -> three outputs, for sm_90a.
//
// Replaces: `_kernel` / `qkv_rope_step`, uniaudio2_tpu/ops/qkv_step.py:65-123
// and 172-262, in its five modes: "int8", "int4" and "int4g" (K-split int4,
// per-channel and grouped scales), "int4i" and "int4ig" (row-interleaved).
//
// x (B, K) bf16 un-normed; W int8 (K, N) or packed int4 (K/2, N) with
// N = (H + 2G) * hd unpadded; scale (N,) f32 or grouped (groups, N) f32;
// cos/sin (hd,) f32, one row shared by the batch. Outputs q (B, H*hd),
// k (B, G*hd), v (B, G*hd) bf16.
//
// Bound: weight bytes (int4: K*N/2, 7.9 MB for the backbone's 3072 -> 5120,
// 3.1 MB for the decoder's 2048 -> 3072; int8 twice that; grouped scales add
// 6 %). Design: the GEMV of gemv_common.cuh (layout and scale mode are its
// template parameters) with one block per HEAD (TN = hd = 32 * COLS
// columns), so a block holds the whole head in f32 shared memory after the
// scale and can rotate it there:
// out[j] = y[j] cos[j] + rot[j] sin[j], rot = (-y[j + hd/2] | y[j - hd/2]),
// in f32 as the Pallas kernel does, then one cast to bf16. The head index
// selects the stream: q heads and k heads are rotated, v heads are not.
#include "gemv_common.cuh"

namespace {

using ua2::MT;
using ua2::THREADS;

template <int HD, int LAYOUT, bool GROUPED>
__global__ void __launch_bounds__(THREADS)
qkv_rope_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, const __nv_bfloat16* __restrict__ nw,
                const float* __restrict__ cos_r, const float* __restrict__ sin_r,
                __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ k,
                __nv_bfloat16* __restrict__ v, int B, int K, int n_head,
                int n_groups, int G, float eps) {
  constexpr int COLS = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + ua2::align16(MT * K * 2));
  float* y = red + ua2::WARPS * MT * HD;
  float* st = y + MT * HD;
  const int head = blockIdx.x, col0 = head * HD, m0 = blockIdx.y * MT;
  const int N = (n_head + 2 * n_groups) * HD;

  ua2::stage_rows(x, nw, B, K, m0, eps, xs, red);
  if (GROUPED) ua2::stage_scales<COLS, LAYOUT>(scale, N, G, col0, st);
  float acc[1][MT][COLS] = {};
  const int8_t* const ws[1] = {w};
  ua2::gemv_partial<COLS, 1, LAYOUT, GROUPED>(
      xs, K, ws, N, col0 + (threadIdx.x & 31) * COLS, st, G, acc);
  ua2::park_partials<COLS, 1>(acc, red);
  for (int t = threadIdx.x; t < MT * HD; t += THREADS) {
    const float total = ua2::warp_total<COLS>(red, 0, t);
    y[t] = GROUPED ? total : total * scale[col0 + t % HD];
  }
  __syncthreads();

  __nv_bfloat16* dst;
  int ld, dcol;
  bool rope = true;
  if (head < n_head) {
    dst = q, ld = n_head * HD, dcol = col0;
  } else if (head < n_head + n_groups) {
    dst = k, ld = n_groups * HD, dcol = col0 - n_head * HD;
  } else {
    dst = v, ld = n_groups * HD, dcol = col0 - (n_head + n_groups) * HD;
    rope = false;
  }
  constexpr int HALF = HD / 2;
  for (int t = threadIdx.x; t < MT * HD; t += THREADS) {
    const int m = t / HD, j = t % HD, row = m0 + m;
    if (row >= B) continue;
    float o = y[t];
    if (rope) {
      const float rot = j < HALF ? -y[t + HALF] : y[t - HALF];
      o = __fadd_rn(__fmul_rn(o, cos_r[j]), __fmul_rn(rot, sin_r[j]));
    }
    dst[(size_t)row * ld + dcol + j] = __float2bfloat16(o);
  }
}

struct Args {
  const void *x, *w, *scale, *nw, *cos_r, *sin_r;
  void *q, *k, *v;
  int B, K, n_head, n_groups, G;
  float eps;
  cudaStream_t stream;
};

template <int HD, int LAYOUT, bool GROUPED>
int launch(const Args& a) {
  constexpr int COLS = HD / 32;
  if (GROUPED != (a.G > 0)) return (int)cudaErrorInvalidValue;
  const dim3 grid(a.n_head + 2 * a.n_groups, (a.B + MT - 1) / MT);
  const int smem = ua2::smem_bytes(a.K, COLS, 1, MT * HD * 4, a.G);
  cudaError_t e = ua2::allow_smem(qkv_rope_kernel<HD, LAYOUT, GROUPED>, smem);
  if (e != cudaSuccess) return (int)e;
  qkv_rope_kernel<HD, LAYOUT, GROUPED><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const int8_t*>(a.w),
      static_cast<const float*>(a.scale), static_cast<const __nv_bfloat16*>(a.nw),
      static_cast<const float*>(a.cos_r), static_cast<const float*>(a.sin_r),
      static_cast<__nv_bfloat16*>(a.q), static_cast<__nv_bfloat16*>(a.k),
      static_cast<__nv_bfloat16*>(a.v), a.B, a.K, a.n_head, a.n_groups, a.G, a.eps);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mode(int layout, const Args& a) {
  switch (layout * 2 + (a.G > 0)) {
    case ua2::INT8 * 2: return launch<HD, ua2::INT8, false>(a);
    case ua2::I4 * 2: return launch<HD, ua2::I4, false>(a);
    case ua2::I4 * 2 + 1: return launch<HD, ua2::I4, true>(a);
    case ua2::K4 * 2: return launch<HD, ua2::K4, false>(a);
    case ua2::K4 * 2 + 1: return launch<HD, ua2::K4, true>(a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// `layout` is one of ua2::INT8, I4, K4; G is the number of scale groups
// (0 = per-channel).
extern "C" int ua2_qkv_rope(const void* x, const void* w, const void* scale,
                            const void* norm_w, const void* cos_r, const void* sin_r,
                            void* q, void* k, void* v, int B, int K, int n_head,
                            int n_groups, int head_size, int layout, int G,
                            float eps, void* stream) {
  const Args a{x, w, scale, norm_w, cos_r, sin_r, q, k, v, B, K, n_head, n_groups,
               G, eps, static_cast<cudaStream_t>(stream)};
  if (head_size == 128) return launch_mode<128>(layout, a);
  if (head_size == 64) return launch_mode<64>(layout, a);
  return (int)cudaErrorInvalidValue;
}
