// K-split int4 GEMV in twelve tile forms, for sm_90a.
//
// Replaces: `matmul_bn` / its `_kernel`, scripts/sweep_gemv_blocks.py:37-75
// (`pallas_call` at :60), the TPU probe that swept the tile width (bn 512,
// 1024, 2048) and the unpack width (int32 or int16 shifts) of row 5's
// K-split GEMV at four serving shapes:
//
//   out (M, N) bf16 = (x[:, :K/2] @ lo + x[:, K/2:] @ hi) * scale (N,)
//
// over (K/2, ldw) bytes, byte [r, c] = row r (low nibble) and row r + K/2
// (high nibble) of column c.
//
// On the H100 the parameters are the template's (`gemv_int4_probe.cuh`):
// byte columns a lane loads (COLS), weight rows in flight (UNROLL), the
// unpack (SHIFT or MAGIC) and activation rows a block reuses (MT). Form 0
// is `gemv_int4.cu`'s own (COLS 2, UNROLL 8, MT 4, SHIFT: the same bits);
// the others change one or two parameters. At M = 8 and 16 the production
// MT = 4 reads every weight byte two and four times (the later reads through
// L2); MT 8 and 16 read it once.
//
// Bound: weight bytes, K*N/2 (3072 x 5120: 7.9 MB, 2.3 us at 3.35 TB/s).
#include "gemv_int4_probe.cuh"

namespace {

using Launch = int (*)(const void*, const void*, const void*, void*, int, int, int,
                       int, int, cudaStream_t);

struct Form {
  int cols, unroll, mt, unpack;
  Launch launch;
};

using ua2::K4;
using ua2::probe::launch_probe;
constexpr int S = ua2::probe::SHIFT, G = ua2::probe::MAGIC;

// The order is part of the C interface (`ops/int4_sweep.py` FORMS).
const Form FORMS[] = {
    {2, 8, 4, S, launch_probe<K4, 2, 8, 4, S>},
    {2, 8, 4, G, launch_probe<K4, 2, 8, 4, G>},
    {4, 8, 4, S, launch_probe<K4, 4, 8, 4, S>},
    {4, 8, 4, G, launch_probe<K4, 4, 8, 4, G>},
    {2, 4, 4, S, launch_probe<K4, 2, 4, 4, S>},
    {2, 16, 4, S, launch_probe<K4, 2, 16, 4, S>},
    {2, 8, 8, S, launch_probe<K4, 2, 8, 8, S>},
    {2, 8, 16, S, launch_probe<K4, 2, 8, 16, S>},
    {2, 8, 8, G, launch_probe<K4, 2, 8, 8, G>},
    {2, 8, 16, G, launch_probe<K4, 2, 8, 16, G>},
    {4, 8, 16, G, launch_probe<K4, 4, 8, 16, G>},
    {2, 16, 16, G, launch_probe<K4, 2, 16, 16, G>},
};
constexpr int N_FORMS = sizeof(FORMS) / sizeof(FORMS[0]);

}  // namespace

// The parameters of form i (cols, unroll, mt, unpack) into params[0..3];
// returns the number of forms, or -1 when i is out of range.
extern "C" int ua2_gemv_int4_sweep_form(int i, int* params) {
  if (i < 0 || i >= N_FORMS) return -1;
  params[0] = FORMS[i].cols;
  params[1] = FORMS[i].unroll;
  params[2] = FORMS[i].mt;
  params[3] = FORMS[i].unpack;
  return N_FORMS;
}

extern "C" int ua2_gemv_int4_sweep(int form, const void* x, const void* w,
                                   const void* scale, void* out, int M, int K, int N,
                                   int ldw, void* stream) {
  if (form < 0 || form >= N_FORMS) return (int)cudaErrorInvalidValue;
  return FORMS[form].launch(x, w, scale, out, M, K, N, ldw, 0,
                            static_cast<cudaStream_t>(stream));
}
