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
// with l = *layer read ON THE DEVICE (the card's counterpart of scalar
// prefetch). Nothing is sliced on the host, so a CUDA graph that replays
// one layer's launch with an index it advances on the device walks the
// whole stack (the counterpart of `lax.scan`'s one compiled body).
//
// W is (L, K/2, ldw) int8 in the layout the quantizer writes (byte [l, r, c]
// holds row r of column c in its low nibble and row r + K/2 in its high
// nibble); scale is (L, N) f32. An index outside [0, L) writes NaN rather
// than reading past the stack.
//
// Bound: the layer's weight bytes, K*N/2 (12.6 MB at (3072, 8192): 3.8 us
// at 3.35 TB/s).
//
// Design: the TMA-ring split-K GEMV of gemv_int4_stream.cuh, K4, in row
// 13's form 0 (64-column tiles, boxes of 64 byte rows, a 4-stage ring,
// `quant.gemv_plan`'s slices, the conversion-free unpack), its stacked
// instance: one 2-D tensor map over the whole stack (ldw bytes x L K/2
// rows), encoded on the host from the stack's base; the producer thread
// reads the index and adds l K/2 to every box's row, the consumers read it
// for the scale row while they stage x. So at M <= 16 every layer gives
// `quant.int4_matmul`'s bits on its slice (the split-K kernel's, the same
// plan and order).
//
// The first design, `ua2_gemv_int4_stacked_simt`, stays as the yardstick:
// the tiled instance of row 5's kernel (`gemv_int4.cu`, gemv_common.cuh's
// gemv_kernel<2, K4, false, false>, no norm, no residual) with the index
// loaded by each block, whose bits it gives on every layer's slice; 64-
// column tiles, 8 warps a block, 8 weight rows in flight a warp, no TMA,
// no split-K: the latency of ~24 rounds of loads, one block an SM
// (`__launch_bounds__(THREADS, 1)` lets ptxas issue each round's eight
// loads together where the loaded index had it spread them).
#include "gemv_common.cuh"
#include "gemv_int4_stream.cuh"

namespace {

using namespace ua2;

// The ring's form (`ops/int4_stream.py` DEFAULT; slice rule 0, the plan's)
namespace ring {
constexpr int TN = 64, BK = 64, STAGES = 4, UNPACK = stream::MAGIC;
}

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

// x (M, K) bf16, w (L, K/2, ldw) int8, scale (L, N) f32 (s_stride floats
// a layer), layer: one int32 on the device, out (M, N) bf16; `splits`
// K-slices of `span` byte rows (`int4_stream.stream_plan` of the default
// form). Returns cudaGetLastError(), or cudaErrorInvalidValue for what the
// kernel does not take.
extern "C" int ua2_gemv_int4_stacked(const void* x, const void* w, const void* scale,
                                     const void* layer, void* out, int M, int K, int N,
                                     int ldw, long long s_stride, int L, int splits,
                                     int span, void* stream) {
  return ua2::stream::launch_stacked<ring::TN, ring::BK, ring::STAGES, ring::UNPACK>(
      x, w, scale, static_cast<const int*>(layer), out, M, K, N, ldw, s_stride, L, splits,
      span, static_cast<cudaStream_t>(stream));
}

// The first design: the same operands but the plan, w_stride = K/2 ldw
// bytes a layer.
extern "C" int ua2_gemv_int4_stacked_simt(const void* x, const void* w,
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
