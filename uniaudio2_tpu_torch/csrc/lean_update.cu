// Fused adamw_lean per-leaf update, for sm_90a.
//
// Replaces: `_kernel` / `fused_lean_update`,
// uniaudio2_tpu/ops/lean_update.py:81-184.
//
// One leaf seen as (rows, C), C % 256 == 0, rows = lead * R; per element
//   m    = fma(m_q, b1 * m_scale, (1 - b1) * g)
//   upd  = -lr * fma(wd, p, (m * inv_mc) / fma(a_row, b_col, eps))
// and per 256-wide block of a row
//   m_scale' = max|m| * (1 / 127),  m_q' = rint(m / max(m_scale', 1e-30)).
// That is the Pallas kernel's arithmetic as XLA compiles it for the CPU,
// where the JAX package's tests run it in interpret mode: XLA contracts the
// products and sums into FMAs, moves b1 onto the per-block scale and
// multiplies by the reciprocal of 127. The plain twin follows the same
// rounding, so kernel, twin and the JAX reference agree to the bit.
// g, p, upd: T (bf16 or f32), m_q: int8, m_scale (rows, C/256) f32,
// a (rows,) f32, b (lead, C) f32 (the column factor of the leaf's own
// lead index), inv_mc and lr f32 scalars.
//
// Bound: bytes. Each element reads g, p (2 B each in bf16) and m_q (1 B)
// and writes upd (2 B) and m_q' (1 B): 8 B per parameter, plus 8 B per
// 256-block for the scales. The 4.66 B parameters of the fused leaves of
// the full model are about 11 ms at 3.35 TB/s; the arithmetic (~14 float32
// operations an element, 3 FMAs and 2 divisions, 0.13 ms at 67 TFLOP/s for
// the largest leaf) is far below that.
//
// Design (simple and exact first):
//  * one warp per (row, 256-column block); lane l owns elements
//    [8l, 8l + 8) of the block, so g, p and upd move as one 16-byte access
//    per lane in bf16 (two in f32) and m_q as one 8-byte access;
//  * the block's absmax is a __shfl_xor_sync max over the 32 lanes, and
//    lane 0 writes the block's scale in the public (rows, C/256) layout;
//  * a grid-stride loop over all rows * C/256 blocks;
//  * every operation is rounded explicitly (__fmul_rn, __fmaf_rn,
//    __fdiv_rn), so nvcc contracts nothing on its own; IEEE division
//    throughout; rintf rounds half to even, as jnp.round and torch.round.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 256;
constexpr int PER_LANE = QBLOCK / 32;   // 8 elements per lane
constexpr int WARPS = 8;                // warps per block of threads
constexpr float INV127 = 1.0f / 127.0f;  // rounded once, as XLA folds it

struct Consts {
  float b1, omb1, wd, eps, inv_mc, neg_lr;
};

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&v)[PER_LANE]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < PER_LANE / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float (&v)[PER_LANE]) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[PER_LANE]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < PER_LANE / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = raw;
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[PER_LANE]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
lean_update_kernel(const T* __restrict__ g, const int8_t* __restrict__ mq,
                   const float* __restrict__ ms, const T* __restrict__ p,
                   const float* __restrict__ a, const float* __restrict__ b,
                   T* __restrict__ upd, int8_t* __restrict__ nmq,
                   float* __restrict__ nms, long long rows, int rows_per_lead,
                   int cols, Consts k) {
  const int lane = threadIdx.x & 31;
  const int nsb = cols / QBLOCK;
  const long long total = rows * nsb;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); w < total;
       w += stride) {
    const long long row = w / nsb;
    const int blk = (int)(w - row * nsb);
    const long long lead = row / rows_per_lead;
    const int col = blk * QBLOCK + lane * PER_LANE;
    const long long off = row * cols + col;

    float gv[PER_LANE], pv[PER_LANE], bv[PER_LANE], m[PER_LANE];
    load8(g + off, gv);
    load8(p + off, pv);
    load8(b + lead * cols + col, bv);
    const int2 qraw = *reinterpret_cast<const int2*>(mq + off);
    const int8_t* q = reinterpret_cast<const int8_t*>(&qraw);
    const float scale = ms[w];
    const float arow = a[row];

    const float b1ms = __fmul_rn(k.b1, scale);
    float u[PER_LANE];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      m[i] = __fmaf_rn((float)q[i], b1ms, __fmul_rn(k.omb1, gv[i]));
      const float den = __fmaf_rn(arow, bv[i], k.eps);
      const float x = __fmaf_rn(k.wd, pv[i], __fdiv_rn(__fmul_rn(m[i], k.inv_mc), den));
      u[i] = __fmul_rn(k.neg_lr, x);
      amax = fmaxf(amax, fabsf(m[i]));
    }
    store8(upd + off, u);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, s));
    const float ns = __fmul_rn(amax, INV127);
    const float den = fmaxf(ns, 1e-30f);
    int2 oraw;
    int8_t* o = reinterpret_cast<int8_t*>(&oraw);
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) o[i] = (int8_t)rintf(__fdiv_rn(m[i], den));
    *reinterpret_cast<int2*>(nmq + off) = oraw;
    if (lane == 0) nms[w] = ns;
  }
}

template <typename T>
int launch(const void* g, const void* mq, const void* ms, const void* p, const void* a,
           const void* b, void* upd, void* nmq, void* nms, long long rows,
           int rows_per_lead, int cols, Consts k, cudaStream_t stream) {
  const long long warps = rows * (cols / QBLOCK);
  long long grid = (warps + WARPS - 1) / WARPS;
  if (grid > 132LL * 64) grid = 132LL * 64;   // the grid-stride loop does the rest
  if (grid < 1) grid = 1;
  lean_update_kernel<T><<<(unsigned)grid, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int8_t*>(mq),
      static_cast<const float*>(ms), static_cast<const T*>(p),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<T*>(upd),
      static_cast<int8_t*>(nmq), static_cast<float*>(nms), rows, rows_per_lead, cols, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ua2_lean_update(const void* g, const void* mq, const void* ms,
                               const void* p, const void* a, const void* b, void* upd,
                               void* nmq, void* nms, long long rows, int rows_per_lead,
                               int cols, int is_bf16, float b1, float omb1, float wd,
                               float eps, float inv_mc, float neg_lr, void* stream) {
  const Consts k{b1, omb1, wd, eps, inv_mc, neg_lr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(g, mq, ms, p, a, b, upd, nmq, nms, rows, rows_per_lead,
                                 cols, k, s);
  return launch<float>(g, mq, ms, p, a, b, upd, nmq, nms, rows, rows_per_lead, cols, k,
                       s);
}
