// K-split int4 GEMV in twelve forms, for sm_90a.
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
// On the H100 a form is a point of the TMA-ring split-K GEMV's own
// parameters (gemv_int4_stream.cuh, K4): the tile width TN (64 or 128
// columns), the box BK (32, 64 or 128 byte rows), the ring's STAGES (2-8),
// the slice rule (the host's plan, one slice, or twice the plan's) and the
// unpack (the conversion-free MAGIC or gemv_common.cuh's SHIFT: does the
// unpack's cost show once the bytes come by TMA?). Form 0 is row 11's
// default form on K4 with `quant.gemv_plan`'s slices: the split-K K4
// kernel's bits (`quant.int4_matmul`, M <= 16). Forms on the same slices
// give the same bits.
//
// The first design's forms (gemv_int4_probe.cuh: COLS, UNROLL, MT, unpack
// on the CUDA cores) stay as the yardstick, `ua2_gemv_int4_sweep_simt`:
// its form 0 (`gemv_int4.cu`'s tiled instance, the same bits), COLS 4 at
// MT 4 in both unpacks (the fastest at M = 16) and UNROLL 16 (the fastest
// at M = 1).
//
// Bound: weight bytes, K*N/2 (3072 x 5120: 7.9 MB, 2.3 us at 3.35 TB/s).
#include "gemv_int4_probe.cuh"
#include "gemv_int4_stream.cuh"

namespace {

using ua2::K4;
namespace st = ua2::stream;

using Launch = int (*)(const void*, const void*, const void*, void*, int, int, int, int,
                       int, int, int, cudaStream_t);

// slice rules (`ops/int4_stream.py` SLICE_RULES)
constexpr int PLAN = 0, ONE = 1, DOUBLE = 2;
constexpr int G = st::MAGIC, H = st::SHIFT;

struct Form {
  int tn, bk, stages, slices, unpack;
  Launch launch;
};

// The order is part of the C interface (`ops/int4_sweep.py` FORMS).
const Form FORMS[] = {
    {64, 64, 4, PLAN, G, st::launch<K4, 64, 64, 4, G>},
    {64, 64, 4, PLAN, H, st::launch<K4, 64, 64, 4, H>},
    {64, 32, 4, PLAN, G, st::launch<K4, 64, 32, 4, G>},
    {64, 32, 8, PLAN, G, st::launch<K4, 64, 32, 8, G>},
    {64, 128, 4, PLAN, G, st::launch<K4, 64, 128, 4, G>},
    {64, 64, 2, PLAN, G, st::launch<K4, 64, 64, 2, G>},
    {64, 64, 8, PLAN, G, st::launch<K4, 64, 64, 8, G>},
    {128, 64, 4, PLAN, G, st::launch<K4, 128, 64, 4, G>},
    {128, 64, 8, PLAN, G, st::launch<K4, 128, 64, 8, G>},
    {64, 64, 4, ONE, G, st::launch<K4, 64, 64, 4, G>},
    {64, 64, 4, DOUBLE, G, st::launch<K4, 64, 64, 4, G>},
    {128, 64, 4, PLAN, H, st::launch<K4, 128, 64, 4, H>},
};
constexpr int N_FORMS = sizeof(FORMS) / sizeof(FORMS[0]);

using SimtLaunch = int (*)(const void*, const void*, const void*, void*, int, int, int,
                           int, int, cudaStream_t);

struct SimtForm {
  int cols, unroll, mt, unpack;
  SimtLaunch launch;
};

using ua2::probe::launch_probe;
constexpr int PS = ua2::probe::SHIFT, PG = ua2::probe::MAGIC;

// The order is part of the C interface (`ops/int4_sweep.py` SIMT_FORMS).
const SimtForm SIMT_FORMS[] = {
    {2, 8, 4, PS, launch_probe<K4, 2, 8, 4, PS>},
    {4, 8, 4, PS, launch_probe<K4, 4, 8, 4, PS>},
    {4, 8, 4, PG, launch_probe<K4, 4, 8, 4, PG>},
    {2, 16, 4, PS, launch_probe<K4, 2, 16, 4, PS>},
};
constexpr int N_SIMT = sizeof(SIMT_FORMS) / sizeof(SIMT_FORMS[0]);

}  // namespace

// The parameters of form i (tn, bk, stages, slice rule, unpack) into
// params[0..4]; returns the number of forms, or -1 when i is out of range.
extern "C" int ua2_gemv_int4_sweep_form(int i, int* params) {
  if (i < 0 || i >= N_FORMS) return -1;
  params[0] = FORMS[i].tn;
  params[1] = FORMS[i].bk;
  params[2] = FORMS[i].stages;
  params[3] = FORMS[i].slices;
  params[4] = FORMS[i].unpack;
  return N_FORMS;
}

// `splits` K-slices of `span` byte rows (`int4_stream.stream_plan` of the
// form's slice rule).
extern "C" int ua2_gemv_int4_sweep(int form, const void* x, const void* w,
                                   const void* scale, void* out, int M, int K, int N,
                                   int ldw, int splits, int span, void* stream) {
  if (form < 0 || form >= N_FORMS) return (int)cudaErrorInvalidValue;
  return FORMS[form].launch(x, w, scale, out, M, K, N, ldw, 0, splits, span,
                            static_cast<cudaStream_t>(stream));
}

// Dynamic shared bytes of a launch of (tn, bk, stages) at M rows and slices
// of `span` byte rows (what `int4_stream.smem_bytes` mirrors).
extern "C" int ua2_gemv_int4_stream_smem(int tn, int bk, int stages, int M, int span) {
  return st::smem_bytes(tn, bk, stages, M, span);
}

// The first design's form i (cols, unroll, mt, unpack) into params[0..3];
// returns the number of its forms, or -1 when i is out of range.
extern "C" int ua2_gemv_int4_sweep_simt_form(int i, int* params) {
  if (i < 0 || i >= N_SIMT) return -1;
  params[0] = SIMT_FORMS[i].cols;
  params[1] = SIMT_FORMS[i].unroll;
  params[2] = SIMT_FORMS[i].mt;
  params[3] = SIMT_FORMS[i].unpack;
  return N_SIMT;
}

extern "C" int ua2_gemv_int4_sweep_simt(int form, const void* x, const void* w,
                                        const void* scale, void* out, int M, int K, int N,
                                        int ldw, void* stream) {
  if (form < 0 || form >= N_SIMT) return (int)cudaErrorInvalidValue;
  return SIMT_FORMS[form].launch(x, w, scale, out, M, K, N, ldw, 0,
                                 static_cast<cudaStream_t>(stream));
}
