// Row-interleaved int4 GEMV with a conversion-free nibble unpack, for sm_90a.
//
// Replaces: `int4_native_matmul` / its `_kernel`,
// scripts/int4_native_probe.py:43-84 (`pallas_call` at :72), the TPU probe
// that let the hardware's i4 -> bf16 unpack replace `quant._unpack4`'s
// shift chain in row 1's GEMV:
//
//   out (M, N) bf16 = x (M, K) bf16 @ W (K, N) int4 * scale (N,) f32
//
// W as int8 bytes of row-interleaved nibbles (row 2r low, 2r+1 high,
// levels -8..7), row-major (K/2, ldw) or chunk-major (C, K/2, bn).
//
// Design: the TMA-ring split-K GEMV of gemv_int4_stream.cuh, I4, in its
// default form (64-column tiles, boxes of 64 byte rows, a 4-stage ring,
// the host's `quant.gemv_plan`, the conversion-free unpack): the bytes come
// by TMA into a ring in shared memory and the products run on the tensor
// cores in the split-K kernel's order, so at M <= 16 the output is
// `quant.int4i_matmul`'s to the bit, row-major and chunk-major alike.
// The first design, `ua2_gemv_int4_native_simt` (gemv_int4_probe.cuh:
// the CUDA cores, the tiled template's order, `gemv_int4i.cu`'s tiled
// instance's bits), stays as the yardstick.
//
// Bound: weight bytes, K*N/2 (3072 x 8192: 12.6 MB, 3.8 us at 3.35 TB/s).
#include "gemv_int4_probe.cuh"
#include "gemv_int4_stream.cuh"

namespace {

namespace st = ua2::stream;

// The default form (`ops/int4_stream.py` DEFAULT; slice rule 0, the plan's)
constexpr int TN = 64, BK = 64, STAGES = 4, UNPACK = st::MAGIC;

}  // namespace

// (tn, bk, stages, slice rule, unpack) of the default form into params[0..4]
extern "C" int ua2_gemv_int4_native_form(int* params) {
  params[0] = TN;
  params[1] = BK;
  params[2] = STAGES;
  params[3] = 0;
  params[4] = UNPACK;
  return 0;
}

// ldw: the bytes' padded width (row-major: the row pitch; chunk-major: C x
// bn); bn = 0 for row-major bytes; `splits` K-slices of `span` byte rows.
extern "C" int ua2_gemv_int4_native(const void* x, const void* w, const void* scale,
                                    void* out, int M, int K, int N, int ldw, int bn,
                                    int splits, int span, void* stream) {
  return st::launch<ua2::I4, TN, BK, STAGES, UNPACK>(x, w, scale, out, M, K, N, ldw, bn,
                                                     splits, span,
                                                     static_cast<cudaStream_t>(stream));
}

// The first design: 8 warps of CUDA-core FMAs over 64-column tiles, 4
// activation rows a block, the MAGIC unpack (ldw unread for chunk-major).
extern "C" int ua2_gemv_int4_native_simt(const void* x, const void* w, const void* scale,
                                         void* out, int M, int K, int N, int ldw, int bn,
                                         void* stream) {
  return ua2::probe::launch_probe<ua2::I4, 2, 8, 4, ua2::probe::MAGIC>(
      x, w, scale, out, M, K, N, ldw, bn, static_cast<cudaStream_t>(stream));
}
