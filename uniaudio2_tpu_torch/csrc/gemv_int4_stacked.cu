// Stacked-layer K-split int4 GEMV with a device-side layer index, for sm_90a.
//
// Replaces: `kernel` in `run_prefetch`, scripts/profile_scan_slice.py:101-133
// (`pallas_call` at :114), the TPU probe that reads layer l of a stacked
// (L, K/2, N) int4 container straight out of the stack, the index delivered
// by scalar prefetch into the block index map, so that no per-layer slice
// is copied.
//
//   out (M, N) = x (M, K) @ unpack(W[l]) (K, N) * scale[l] (N,), bf16 out
//
// with l = *layer read ON THE DEVICE: each block loads the index itself
// (the card's counterpart of scalar prefetch) and offsets the stacked base
// pointers by l times the per-layer strides. Nothing is sliced on the host,
// so a CUDA graph that replays one layer's launch with an index it advances
// on the device walks the whole stack (the counterpart of `lax.scan`'s one
// compiled body).
//
// W is (L, K/2, ldw) int8 in the layout the quantizer writes (byte [l, r, c]
// holds row r of column c in its low nibble and row r + K/2 in its high
// nibble); scale is (L, N) f32. The body is `gemv_int4.cu`'s (the
// gemv_common.cuh steps of gemv_kernel<2, K4, false, false> with no norm and
// no residual), so on every layer it gives that kernel's bits on the
// layer's slice. An index outside [0, L) writes NaN rather than reading
// past the stack.
//
// Bound: the layer's weight bytes, K*N/2 (12.6 MB at (3072, 8192): 3.8 us
// at 3.35 TB/s). Like row 5's kernel it is a simple first version (64-column
// tiles, 8 warps a block, 8 weight rows in flight a warp): no TMA, no
// split-K, so the time is the latency of ~24 rounds of loads, one block an
// SM. That makes the schedule of each round's eight loads the kernel's
// speed: with the index a loaded value, ptxas kept the default bound's 48
// registers and spread the eight loads through the round's arithmetic, and
// the kernel read ~35 % slower than row 5's; `__launch_bounds__(THREADS, 1)`
// (one block an SM is all the grid fills anyway) lets it issue them
// together. It reads the index once a block: one dependent load before
// the weight stream starts.
#include "gemv_common.cuh"

namespace {

using namespace ua2;

template <int COLS>
__global__ void __launch_bounds__(THREADS, 1)
gemv_int4_stacked_kernel(const __nv_bfloat16* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ scale,
                         const int* __restrict__ layer,
                         __nv_bfloat16* __restrict__ out, int M, int K, int N,
                         int ldw, long long w_stride, long long s_stride,
                         int L) {
  constexpr int TN = 32 * COLS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* red = reinterpret_cast<float*>(smem + align16(MT * K * 2));
  const int col0 = blockIdx.x * TN, m0 = blockIdx.y * MT;
  const int l = __ldg(layer);
  if (l < 0 || l >= L) {
    const __nv_bfloat16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
    for (int t = threadIdx.x; t < MT * TN; t += THREADS) {
      const int row = m0 + t / TN, c = col0 + t % TN;
      if (row < M && c < N) out[(size_t)row * N + c] = nan;
    }
    return;
  }
  const int8_t* wl = w + (size_t)l * w_stride;
  const float* sl = scale + (size_t)l * s_stride;
  stage_rows(x, nullptr, M, K, m0, 0.f, xs, red);
  float acc[1][MT][COLS] = {};
  const int8_t* const ws[1] = {wl};
  gemv_partial<COLS, 1, K4, false>(xs, K, ws, ldw, col0 + (threadIdx.x & 31) * COLS,
                                   nullptr, 0, acc);
  park_partials<COLS, 1>(acc, red);
  for (int t = threadIdx.x; t < MT * TN; t += THREADS) {
    const int m = t / TN, c = col0 + t % TN, row = m0 + m;
    if (row >= M || c >= N) continue;
    const float v = warp_total<COLS>(red, 0, t) * sl[c];
    out[(size_t)row * N + c] = __float2bfloat16(v);
  }
}

}  // namespace

// x (M, K) bf16, w (L, K/2, ldw) int8, scale (L, N) f32 (per-layer strides
// w_stride bytes and s_stride floats), layer: one int32 on the device, out
// (M, N) bf16. Returns cudaGetLastError().
extern "C" int ua2_gemv_int4_stacked(const void* x, const void* w,
                                     const void* scale, const void* layer,
                                     void* out, int M, int K, int N, int ldw,
                                     long long w_stride, long long s_stride,
                                     int L, void* stream) {
  constexpr int COLS = 2, TN = 32 * COLS;
  const dim3 grid((N + TN - 1) / TN, (M + MT - 1) / MT);
  const int smem = smem_bytes(K, COLS, 1);
  cudaError_t e = allow_smem(gemv_int4_stacked_kernel<COLS>, smem);
  if (e != cudaSuccess) return (int)e;
  gemv_int4_stacked_kernel<COLS><<<grid, THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const int*>(layer),
      static_cast<__nv_bfloat16*>(out), M, K, N, ldw, w_stride, s_stride, L);
  return (int)cudaGetLastError();
}
