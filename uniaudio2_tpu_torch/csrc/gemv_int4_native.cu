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
// Design: the production template's (`gemv_common.cuh`, COLS 2, 8 rows in
// flight, 4 activation rows a block) with the MAGIC unpack of
// `gemv_int4_probe.cuh`: each byte's two levels become exact bf16 numbers
// by an XOR, a multiply-add, a LOP3 and one bf16x2 subtraction, where
// `gemv_int4i.cu` spends two shifts and two int -> float conversions. The
// sums run in the production kernel's order, so on the same bytes the two
// give the same bits.
//
// Bound: weight bytes, K*N/2 (3072 x 8192: 12.6 MB, 3.8 us at 3.35 TB/s).
#include "gemv_int4_probe.cuh"

extern "C" int ua2_gemv_int4_native(const void* x, const void* w, const void* scale,
                                    void* out, int M, int K, int N, int ldw, int bn,
                                    void* stream) {
  return ua2::probe::launch_probe<ua2::I4, 2, 8, 4, ua2::probe::MAGIC>(
      x, w, scale, out, M, K, N, ldw, bn, static_cast<cudaStream_t>(stream));
}
