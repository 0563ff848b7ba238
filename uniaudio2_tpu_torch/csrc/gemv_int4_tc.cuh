// Tensor-core tile kernel of the quantized GEMVs above the decode rows, for
// sm_90a. Included by gemv_int4c.cu and gemv_int4cg.cu (the column-packed
// layout, C4, per column and grouped), gemv_int4i.cu (the row-interleaved
// layout, I4, per column and grouped), gemv_int4g.cu and gemv_int4.cu (the
// K-split layout, K4, grouped and per column) and gemv_int8.cu (int8, one
// level a byte, INT8, per column). A layout enters only through the W
// stage's box, `unpack` and the epilogue's column map.
//
//   out (M, N) = [rmsnorm(x)] (M, K) @ unpack(W) (K, N) [* scale] [+ res]
//
// Replaces, above quant.SPLITK_MAX_M activation rows, the tiled template of
// gemv_common.cuh for `_pallas_int4c_matmul` / `_pallas_int4cg_matmul`
// (uniaudio2_tpu/ops/quant.py:789-916), `_pallas_int4i_matmul` (:919-1038),
// `_pallas_int4g_matmul` (:688-786) and `_pallas_int8_matmul` (:463-565).
// The serving path calls them at every prefill: the QKV projection (I4 /
// K4 / INT8, with the RMSNorm folded), attn_proj (with the residual folded)
// and, above 128 rows (the fused MLP takes up to 128), gate, up and the
// down-projection, at M = 63 to 510.
//
// Bound: operations. At (M = 255, K = 8192, N = 3072) a call is 12.8 GFLOP
// (13 us at 989 TFLOP/s) against 12.6 MB of weights (3.8 us at 3.35 TB/s);
// at (255, 3072 -> 5120), the QKV projection, 8.0 GFLOP (8.1 us) against
// 7.9 MB. The tiled template gives every 4 activation rows a block that
// reads all of W through L2 and spends f32 FMAs on the CUDA cores (0.19 ms
// at 67 TFLOP/s before any unpacking), so only the tensor cores can reach
// the bound.
//
// Design:
//  * products on wgmma, operands swapped: out^T = W^T . x^T. The unpacked
//    weights are the A operand (64 output columns a warpgroup, from
//    registers) and the activations are B (BN = 256 rows, bf16,
//    contraction-major as x (M, K) already is, from shared memory); f32
//    sums. A thread of an A fragment holds rows g and g + 8 of its warp's
//    16 (g = lane / 4) and, of a k-step of 16, the input-row pairs (2t,
//    2t + 1) and (2t + 8, 2t + 9) (t = lane % 4):
//     - C4: row g is the low nibble and row g + 8 the high nibble of one
//       byte column, so each byte a thread loads gives it both of its
//       rows' levels, and the epilogue writes columns c and N/2 + c;
//     - I4: byte [r, c] holds input rows 2r and 2r + 1 of column c, so one
//       byte is exactly one A register (its two nibbles, one pair), and
//       rows g and g + 8 are output columns c and c + 8;
//     - INT8: byte [k, c] is input row k of column c, so the two halves of
//       an A register are a box row apart. A thread's A rows g and g + 8
//       are the adjacent byte columns 16 u + 2 g and 16 u + 2 g + 1 of its
//       warpgroup's 64 (the epilogue's column map permutes the 64 so), and
//       one 2-byte load of a row gives both rows' levels of that k: four
//       loads a k-step (rows 2t, 2t + 1, 2t + 8, 2t + 9), one byte permute
//       pairing two rows, where one byte a register would take eight byte
//       loads. Under the 128-byte swizzle the four rows a load instruction
//       reads (2t, t < 4, or 2t + 1) put the warp's 16-byte run in four
//       distinct 16-byte chunks: no bank conflict;
//     - K4: byte [r, c] holds rows r and K/2 + r, the Pallas kernel's two
//       dots. A small row kernel (`rows_kernel`) writes the activations in
//       the k order x'[2r] = x[r], x'[2r + 1] = x[K/2 + r] into a scratch
//       buffer the wrapper allocates, and the tile kernel runs I4's
//       products on x'; only the grouped scales differ (low nibbles
//       groups r / (K/G), high nibbles G/2 + r / (K/G)). Reading the byte
//       as two runs of k-steps instead (the low nibbles against x at r,
//       the high ones against a second x box at K/2 + r) pairs the same
//       nibble of byte rows 2t and 2t + 1 in an A register: twice the
//       shared-memory loads and a byte permute a register, and a second x
//       box a stage (three stages in the 227 KB, not four). The permuted
//       copy costs one pass over x (2 M K bytes each way) and a launch,
//       and the served QKV call writes a normalised copy anyway;
//  * a block is WGS = 2 consumer warpgroups (128 output columns: 64 byte
//    columns of C4, 128 of I4 / K4 / INT8) and one producer warp. The
//    producer keeps a ring of STAGES stages (`stages`: INT8's W box is twice
//    the others', and its ring takes as many stages as 227 KB hold, five)
//    of BK = 64 input rows full by TMA (x: a (BN, 64) bf16 box, 128-byte
//    swizzled as wgmma reads it; W: C4 a (64, 64) byte box, 64-byte
//    swizzled, I4 / K4 a (32, 128) byte box and INT8 a (64, 128) one,
//    128-byte swizzled, so that the bytes a thread reads of a k-step fall
//    in distinct banks across its warp), each stage with a `full`
//    mbarrier (the box bytes) and an `empty` one (every consumer thread
//    arrives once its products of the stage have completed), so the loads
//    of later stages run under the products of this one. Rows past M and K
//    are zero-filled by the TMA unit; the epilogue masks columns past N;
//  * each weight byte is read once per row tile of BN rows: at M = 255 one
//    row tile reads the 12.6 MB once;
//  * unpack without conversions, as gemv_int4_splitk.cuh: XOR 0x88 makes a
//    nibble n + 8, one LOP3 puts two nibbles under the bf16 exponent of 128
//    and one bf16x2 FMA subtracts 136: the exact levels (I4 / K4: the byte
//    times 0x1001 puts its high nibble 16 bits above its low one, and the
//    LOP3 flips the sign bits too). Grouped: each level becomes f32 the
//    same way, is multiplied by its f32 scale (fetched from L2 a stage
//    ahead) and rounded to bf16 before the product, as the Pallas kernel
//    rounds the scaled tile. INT8: a level needs 8 bits, more than bf16's
//    7 under one exponent, so a byte permute puts (b ^ 0x80) = level + 128
//    under the f32 exponent of 2^23, one FADD subtracts 2^23 + 128 and one
//    cvt packs two levels as bf16x2 (exact: |level| <= 127), as
//    gemv_int4_splitk.cuh does;
//  * the RMSNorm prologue (I4 / K4 / INT8; the served QKV call) is `rows_kernel`,
//    launched by the same C entry point before the tile kernel: f32 sums
//    of squares in a fixed order, bf16(x * rsqrt(mean + eps) * w), the
//    twin's rounding, into the scratch buffer the tile kernel then reads
//    by TMA (1.6 MB at (255, 3072));
//  * the host (`quant.tc_plan`) picks a split of K into S <= 8 slices of
//    whole stages (and whole scale groups, of both K halves for K4) from
//    the shape and the SM count. The S slices of a tile are one
//    thread-block cluster; each block parks its f32 partial tile in its
//    shared memory (the drained ring) and rank r finishes rows r, r + S,
//    ... of the tile, adding the ranks' partials in rank order through
//    distributed shared memory, then the scale (per column), the residual
//    (f32, before the one rounding, as gemv_int4_splitk.cuh) and one
//    rounding (bf16 or f32 output). No atomics, no workspace, the same
//    bits on every run;
//  * one row tile of BN = 256: at the serving path's M (255 and 510) a
//    smaller tile would only add blocks that read the weights again; rows
//    past M are zero-filled and never written;
//  * C4 folds neither the norm nor the residual: the serving path applies
//    both around these GEMVs (`quant.matmul`, as the JAX package does),
//    and its C entry points send a call that passes either to the tiled
//    template.
// Not here: a persistent schedule, TMA multicast of x across a cluster of
// column tiles, overlapping a stage's unpacking with the previous stage's
// products inside a warpgroup (the two warpgroups of a block interleave
// instead). Tried for that overlap, and none ran faster than this step at
// every M: two sets of A fragments with wait_group 1 spill at BN = 256 (a
// block of 288 threads gets 168 registers a thread: registers go by whole
// warpgroups); handing the producer's registers over with setmaxnreg left
// ptxas's allocation, and the spills, as they were; one commit group a
// k-step with four A slots made ptxas serialize the products (C7513:
// registers of a wgmma defined inside the pipeline stage).
//
// `quant.tc_plan` reads BK, BN, BC and MAX_SPLITS from this file.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include "gemv_common.cuh"

namespace ua2 {
namespace tc {

namespace cg = cooperative_groups;

constexpr int BK = 64;                    // input rows a stage
constexpr int BN = 256;                   // activation rows a block (wgmma's N)
constexpr int STAGES = 4;
constexpr int WGS = 2;                    // consumer warpgroups a block
constexpr int BC = 64;                    // byte columns a block, C4
constexpr int COLS = 2 * BC;              // output columns a block, every layout
constexpr int CONSUMERS = 128 * WGS;
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int PITCH = COLS + 4;           // floats a row of the partial tile
constexpr int X_BYTES = BN * 128;         // an x stage: BN rows of BK bf16
constexpr int W_BYTES = BK * BC;          // a W stage: (BK, BC) C4, (BK/2, COLS) I4 / K4
constexpr int MAX_SPLITS = 8;
constexpr int SMEM_CAP = 232448;          // the 227 KB a block may take
constexpr unsigned OFFSET = 0x88888888u;  // two's complement -> n + 8
constexpr unsigned MAGIC2 = 0x43004300u;  // bf16x2 (128, 128)
static_assert(BC == 32 * WGS, "a consumer warpgroup owns 32 byte columns of C4");
static_assert((BK / 2) * COLS == W_BYTES, "one W stage size for every layout");

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
// A W stage's bytes: INT8's (BK, COLS) box holds one level a byte, twice
// the int4 layouts' W_BYTES.
__host__ __device__ constexpr int w_bytes(int layout) {
  return layout == INT8 ? BK * COLS : W_BYTES;
}
// Stages of the ring: STAGES for the int4 layouts; for INT8 as many as fit
// beside the alignment slack and the mbarriers, at most 8.
__host__ __device__ constexpr int stages(int layout) {
  return layout == INT8 ? cmin(8, (SMEM_CAP - 1024 - 16 * 8) / (X_BYTES + BK * COLS))
                        : STAGES;
}
// The ring during the loop, the partial tile after it.
__host__ __device__ constexpr int region(int layout) {
  return cmax(stages(layout) * (X_BYTES + w_bytes(layout)), BN * PITCH * 4);
}
// Dynamic shared memory: 1024 bytes of alignment slack (the 128-byte
// swizzle's period), the region, the 2 stages mbarriers.
__host__ __device__ constexpr int smem(int layout) {
  return 1024 + region(layout) + 16 * stages(layout);
}
constexpr int SMEM = smem(C4);            // every int4 layout's
static_assert(SMEM == smem(I4) && SMEM == smem(K4), "one int4 ring");
static_assert(smem(INT8) <= SMEM_CAP && stages(INT8) == 5,
              "over the 227 KB a block may take");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A box of the 2-D tensor map at (c0, c1) into this block's shared memory,
// completing its bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The consumer warpgroups' barrier (the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// A wgmma descriptor of the 128-byte-swizzled layout (16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pins the registers a wgmma reads or writes here (see flash_attn.cu): the
// accumulator after a wait, the A fragments before the fence.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x 256, f32) += A (64 x 16, bf16 in registers) . B (16 x 256, bf16
// in shared memory, contraction-major: no transpose).
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// (a & b) | c in one LOP3.
__device__ __forceinline__ unsigned and_or(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The offset nibbles at bits 0-3 and 16-19 of q as the bf16x2 of their
// levels, exact: 128 + (n + 8) - 136.
__device__ __forceinline__ unsigned levels2(unsigned q) {
  const unsigned v = and_or(q, 0x000F000Fu, MAGIC2);
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));   // x 1 - 136
  return d;
}

// The level of the nibble of byte b under `mask` (0x0F: the low nibble, n;
// 0xF0: the high one, as 16 n), exact, in f32: 2^23 + (n + 8) - (2^23 + 8).
__device__ __forceinline__ float level_f(unsigned b, unsigned mask) {
  const unsigned flip = mask & 0x88u;
  const float f = __uint_as_float(((b & mask) ^ flip) | 0x4B000000u);
  return f - (8388608.f + (float)flip);
}

__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A fragment of one k-step of 16 from the four bytes of this thread's
// byte column at rows 2t, 2t + 1, 2t + 8, 2t + 9 of the step: registers 0
// and 2 the low nibbles (A row g), 1 and 3 the high ones (row g + 8); each
// register the levels of two consecutive rows, the lower row in its low
// half. Grouped: the levels times the f32 scales of the byte column's low
// (slo) and high (shi16 = shi / 16) columns, rounded to bf16.
template <bool GROUPED>
__device__ __forceinline__ void unpack(unsigned b0, unsigned b1, unsigned b2,
                                       unsigned b3, float slo, float shi16,
                                       uint32_t (&a)[4]) {
  if constexpr (GROUPED) {
    a[0] = pack_bf2(level_f(b0, 0x0Fu) * slo, level_f(b1, 0x0Fu) * slo);
    a[1] = pack_bf2(level_f(b0, 0xF0u) * shi16, level_f(b1, 0xF0u) * shi16);
    a[2] = pack_bf2(level_f(b2, 0x0Fu) * slo, level_f(b3, 0x0Fu) * slo);
    a[3] = pack_bf2(level_f(b2, 0xF0u) * shi16, level_f(b3, 0xF0u) * shi16);
  } else {
    // bytes (b0, b2, b1, b3): levels2 pairs byte 0 with byte 2
    const unsigned v = __byte_perm(__byte_perm(b0, b2, 0x0040), __byte_perm(b1, b3, 0x0040),
                                   0x5410) ^ OFFSET;
    a[0] = levels2(v);
    a[1] = levels2(v >> 4);
    a[2] = levels2(v >> 8);
    a[3] = levels2(v >> 12);
  }
}

// The A register of one row-packed byte b (I4: input rows 2r low, 2r + 1
// high; K4 on x': the same places): its low nibble's level in the low
// half, its high nibble's in the high half, exact. b * 0x1001 puts the
// high nibble at bits 16-19; the LOP3 (0x6C: ~v where both masks are set,
// v under the second alone, 1 under the first alone) keeps bits 0-3 and
// 16-19 with their sign bits flipped (n + 8) under the bf16 exponent of
// 128, and the bf16x2 FMA subtracts 136.
__device__ __forceinline__ unsigned byte_levels(unsigned b) {
  const unsigned v = b * 0x1001u;
  unsigned q, d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6C;"
      : "=r"(q) : "r"(v), "r"(MAGIC2 | 0x00080008u), "r"(0x000F000Fu));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d) : "r"(q), "r"(0x3F803F80u), "r"(0xC308C308u));   // x 1 - 136
  return d;
}

// INT8: the A register of bytes j and j + 1 of q (q XORed with 0x80808080:
// a byte is level + 128), byte j's level in the low half, exact: each byte
// under the f32 exponent of 2^23, less 2^23 + 128, one cvt to bf16x2.
__device__ __forceinline__ unsigned int8_levels(unsigned q, int j) {
  const float lo = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 | j)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 | (j + 1))) - 8388736.f;
  return pack_bf2(lo, hi);
}

// Grouped: the byte's two levels times their f32 scales (slo the low
// nibble's, shi the high one's), rounded to bf16.
__device__ __forceinline__ unsigned byte_levels_scaled(unsigned b, float slo, float shi) {
  return pack_bf2(level_f(b, 0x0Fu) * slo, level_f(b >> 4, 0x0Fu) * shi);
}

// Fragments (PTX ISA, wgmma m64nNk16): warp u of a warpgroup holds A rows
// 16 u + g and 16 u + g + 8 (lane = 4 g + t); accumulator register 4 n + e
// (e < 2) is A row 16 u + g, B column (activation row) 8 n + 2 t + e, and
// 4 n + 2 + e the A row 8 below.
//
// Grid: (column tiles of COLS output columns, S K-slices of `span` input
// rows, row tiles of BN), launched as clusters of (1, S, 1). x is x' for
// K4 (`rows_kernel`), the scratch copy for a call with a norm.
template <int LAYOUT, bool GROUPED>
__global__ void __launch_bounds__(THREADS, 1)
gemv_tc_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw, const float* __restrict__ scale,
               const __nv_bfloat16* __restrict__ res, void* __restrict__ out, int M,
               int K, int N, int G, int out_f32, int span) {
  static_assert(!(GROUPED && LAYOUT == INT8), "int8 has per-channel scales only");
  constexpr int XB = X_BYTES;
  constexpr int WB = w_bytes(LAYOUT);
  constexpr int STAGES = stages(LAYOUT);
  constexpr int REGION = region(LAYOUT);
  constexpr bool ROWS = LAYOUT != C4;                 // a byte column a column
  constexpr bool PACKED = LAYOUT == I4 || LAYOUT == K4;   // two rows a byte
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int nh = N / 2;
  const int col0 = blockIdx.x * (ROWS ? COLS : BC);   // first byte column
  const int k_begin = blockIdx.y * span;
  const int steps = (min(K, k_begin + span) - k_begin + BK - 1) / BK;
  const int m0 = blockIdx.z * BN;
  // the warp index broadcast from lane 0, so that the compiler sees it (and
  // every descriptor made from it) as uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);     // `base` as a pointer
  const uint32_t x_s = base;                          // stage s at + s XB
  const uint32_t w_s = base + STAGES * XB;            // stage s at + s WB
  float* part = reinterpret_cast<float*>(gbase);      // BN x PITCH, after the loop
  const uint32_t bars = base + REGION;                // full[s], then empty[s]

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                     // the producer's arrival
      mbar_init(bars + 8 * (STAGES + s), CONSUMERS);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WGS) {
    // the producer: stage j holds input rows k_begin + 64 j ... (byte rows
    // half that for I4 / K4)
    if (lane == 0) {
      for (int j = 0; j < steps; ++j) {
        const int s = j % STAGES;
        const uint32_t full = bars + 8 * s;
        if (j >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((j / STAGES) - 1) & 1);
        mbar_expect_tx(full, XB + WB);
        const int k = k_begin + j * BK;
        tma_load(x_s + s * XB, &tx, full, k, m0);
        tma_load(w_s + s * WB, &tw, full, col0, PACKED ? k / 2 : k);
      }
    }
  } else {
    const int wg = warp >> 2, u = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    // C4: byte column cl of the tile, output columns c and nh + c. I4 / K4:
    // output (= byte) columns cl and cl + 8 of the tile, c and c + 8. INT8:
    // output (= byte) columns cl and cl + 1
    const int cl = LAYOUT == INT8 ? 64 * wg + 16 * u + 2 * g
                   : ROWS         ? 64 * wg + 16 * u + g
                                  : 32 * wg + 8 * u + g;
    const int c = col0 + cl;
    // the bytes of a k-step of 16 this thread reads, in a W stage:
    //  C4 (64-byte swizzle: the 16-byte chunk of a row is XORed with bits
    //  7-8 of its offset, t for each of the rows 2t, 2t + 1, 2t + 8,
    //  2t + 9): byte (row 2t, column cl), then + BK, + 8 BK, + 9 BK;
    //  I4 / K4 (128-byte swizzle: the chunk XORed with the row's index mod
    //  8): byte rows t (w_off) and t + 4 (w_off4), columns cl and cl + 8 (+ 8);
    //  INT8 (128-byte swizzle): the 2 bytes of columns cl, cl + 1 of rows
    //  2t (w_off) and 2t + 1 (w_off4), then 8 rows below each (+ 8 COLS)
    const int w_off = LAYOUT == INT8 ? 2 * t * COLS + (((cl >> 4) ^ (2 * t)) << 4) + (cl & 15)
                      : ROWS ? t * COLS + (((cl >> 4) ^ t) << 4) + g
                             : 2 * t * BK + ((((cl >> 4) ^ t) << 4) | (cl & 15));
    const int w_off4 = LAYOUT == INT8
                           ? (2 * t + 1) * COLS + (((cl >> 4) ^ (2 * t + 1)) << 4) + (cl & 15)
                           : t * COLS + 4 * COLS + (((cl >> 4) ^ (t + 4)) << 4) + g;
    const unsigned char* wsm = gbase + STAGES * XB;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int gs = GROUPED ? K / G : 1;               // input rows a group
    for (int j = 0; j < steps; ++j) {
      const int s = j % STAGES;
      const int k0 = k_begin + j * BK;
      // grouped scales of the stage (a k-step of 16 lies in one group: the
      // plan takes K / G % 16 == 0):
      //  C4: sa[kk] column c (low nibbles), sb[kk] column nh + c / 16;
      //  I4: sa[kk] column c, sb[kk] column c + 8, both nibbles;
      //  K4: byte rows k0 / 2 + 16 p (two k-steps each): sa[2p + i] the low
      //  nibbles' (group r / gs) and sb[2p + i] the high nibbles' (G/2 +
      //  r / gs) scale of column c + 8 i
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (GROUPED) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if constexpr (LAYOUT == C4) {
            const int gi = min((k0 + 16 * kk) / gs, G - 1);
            sa[kk] = c < nh ? __ldg(scale + (size_t)gi * N + c) : 0.f;
            sb[kk] = nh + c < N ? __ldg(scale + (size_t)gi * N + nh + c) * 0.0625f : 0.f;
          } else if constexpr (LAYOUT == I4) {
            const int gi = min((k0 + 16 * kk) / gs, G - 1);
            sa[kk] = c < N ? __ldg(scale + (size_t)gi * N + c) : 0.f;
            sb[kk] = c + 8 < N ? __ldg(scale + (size_t)gi * N + c + 8) : 0.f;
          } else {
            const int p = kk >> 1, cc = c + 8 * (kk & 1);
            const int gi = min((k0 / 2 + 16 * p) / gs, G / 2 - 1);
            sa[kk] = cc < N ? __ldg(scale + (size_t)gi * N + cc) : 0.f;
            sb[kk] = cc < N ? __ldg(scale + (size_t)(G / 2 + gi) * N + cc) : 0.f;
          }
        }
      }
      mbar_wait(bars + 8 * s, (j / STAGES) & 1);
      uint32_t a[4][4];
      const unsigned char* wp = wsm + s * WB;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (LAYOUT == INT8) {
          // A registers: (row g, k 2t, 2t + 1) the low bytes of rows 2t and
          // 2t + 1, (row g + 8) their high bytes; then rows 2t + 8, 2t + 9
          const unsigned char* q = wp + kk * 16 * COLS;
          const unsigned r0 = *reinterpret_cast<const unsigned short*>(q + w_off);
          const unsigned r1 = *reinterpret_cast<const unsigned short*>(q + w_off4);
          const unsigned r8 = *reinterpret_cast<const unsigned short*>(q + 8 * COLS + w_off);
          const unsigned r9 = *reinterpret_cast<const unsigned short*>(q + 8 * COLS + w_off4);
          const unsigned lo = __byte_perm(r0, r1, 0x5140) ^ 0x80808080u;
          const unsigned hi = __byte_perm(r8, r9, 0x5140) ^ 0x80808080u;
          a[kk][0] = int8_levels(lo, 0);
          a[kk][1] = int8_levels(lo, 2);
          a[kk][2] = int8_levels(hi, 0);
          a[kk][3] = int8_levels(hi, 2);
        } else if constexpr (ROWS) {
          // A registers: (row g, k 2t, 2t + 1) byte row t column cl, (row
          // g + 8) column cl + 8, then byte row t + 4: k 2t + 8, 2t + 9
          const unsigned char* q = wp + kk * 8 * COLS;
          const unsigned b0 = q[w_off], b1 = q[w_off + 8];
          const unsigned b2 = q[w_off4], b3 = q[w_off4 + 8];
          if constexpr (GROUPED) {
            // the low (l) and high (h) nibbles' scales of columns c (0) and
            // c + 8 (1); I4: both nibbles of a byte take its column's
            float l0 = sa[kk], h0 = sa[kk], l1 = sb[kk], h1 = sb[kk];
            if constexpr (LAYOUT == K4) {
              const int p = 2 * (kk >> 1);
              l0 = sa[p], l1 = sa[p + 1], h0 = sb[p], h1 = sb[p + 1];
            }
            a[kk][0] = byte_levels_scaled(b0, l0, h0);
            a[kk][1] = byte_levels_scaled(b1, l1, h1);
            a[kk][2] = byte_levels_scaled(b2, l0, h0);
            a[kk][3] = byte_levels_scaled(b3, l1, h1);
          } else {
            a[kk][0] = byte_levels(b0);
            a[kk][1] = byte_levels(b1);
            a[kk][2] = byte_levels(b2);
            a[kk][3] = byte_levels(b3);
          }
        } else {
          const unsigned char* q = wp + w_off + kk * 16 * BK;
          unpack<GROUPED>(q[0], q[BK], q[8 * BK], q[9 * BK], sa[kk], sb[kk], a[kk]);
        }
      }
      fence_regs(a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, a[kk], sw128_desc(x_s + s * XB + 32 * kk, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(bars + 8 * (STAGES + s));             // the stage is free
    }

    // the block's partial tile: row = activation row; column: C4 cl the low
    // nibbles' output column, BC + cl the high nibbles'; I4 / K4 cl and
    // cl + 8; INT8 cl and cl + 1
    consumers_sync();                                   // the ring is drained
    constexpr int second = LAYOUT == INT8 ? 1 : ROWS ? 8 : BC;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* dst = part + (8 * n + 2 * t + e) * PITCH + cl;
        dst[0] = acc[4 * n + e];
        dst[second] = acc[4 * n + 2 + e];
      }
  }

  // across the cluster: rank r finishes activation rows r, r + S, ... of the
  // tile, adding the ranks' partials in rank order, then the scale (per
  // column), the residual in f32 and one rounding
  __syncwarp();                       // the producer warp's lanes meet again
  cluster.sync();
  const int rows = (BN - rank + S - 1) / S;
  for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
    const int r = rank + S * (i / COLS), jc = i % COLS;
    const int row = m0 + r;
    int col = col0 + jc;
    if constexpr (!ROWS) {
      const int bcol = col0 + jc % BC;
      const bool hi = jc >= BC;
      if (bcol >= (hi ? N - nh : nh)) continue;
      col = hi ? nh + bcol : bcol;
    }
    if (row >= M || col >= N) continue;
    float pv[MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      pv[q] = q < S ? cluster.map_shared_rank(part, q)[r * PITCH + jc] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q)
      if (q < S) v += pv[q];
    if (!GROUPED) v *= __ldg(scale + col);
    if (res != nullptr) v += __bfloat162float(res[(size_t)row * N + col]);
    if (out_f32)
      reinterpret_cast<float*>(out)[(size_t)row * N + col] = v;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)row * N + col] = __float2bfloat16(v);
  }
  cluster.sync();                     // no block leaves while its tile is read
}

// The activations a row-packed or int8 call's tile kernel reads, one block a row:
// with a norm weight the row RMS-normalised (f32 sum of squares in a fixed
// order, rsqrt(mean + eps)), times the weight and rounded to bf16, as the
// twin rounds it (`ops/norms.py`); for K4 in the k order x'[2r] = x[r],
// x'[2r + 1] = x[K/2 + r] (the byte's low and high rows), with or without
// a norm.
template <int LAYOUT>
__global__ void __launch_bounds__(ua2::THREADS)
rows_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ nw,
            __nv_bfloat16* __restrict__ xn, int K, float eps) {
  __shared__ float red[ua2::WARPS];
  const __nv_bfloat16* src = x + (size_t)blockIdx.x * K;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xn + (size_t)blockIdx.x * K);
  float r = 1.f;
  if (nw != nullptr) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += ua2::THREADS) {
      const float v = __bfloat162float(src[k]);
      ss += v * v;
    }
    r = rsqrtf(ua2::block_sum(ss, red) / (float)K + eps);
  }
  const int half = K / 2;
  for (int i = threadIdx.x; i < half; i += ua2::THREADS) {
    const int ka = LAYOUT == K4 ? i : 2 * i, kb = LAYOUT == K4 ? half + i : 2 * i + 1;
    __nv_bfloat162 o;
    if (nw == nullptr) {
      o.x = src[ka];
      o.y = src[kb];
    } else {
      o.x = __float2bfloat16(__bfloat162float(src[ka]) * r * __bfloat162float(nw[ka]));
      o.y = __float2bfloat16(__bfloat162float(src[kb]) * r * __bfloat162float(nw[kb]));
    }
    dst[i] = o;
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no -lcuda), as flash_attn.cu does.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a row-major (rows, cols) matrix, rows `pitch` bytes
// apart, read in boxes of (box_rows, box_cols);
// entries past either edge read as zeros.
inline bool map2d(CUtensorMap* map, const void* p, CUtensorMapDataType type, int rows,
                  int cols, int pitch, int box_rows, int box_cols,
                  CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// True when (splits, span) is a launch this kernel takes for the shape:
// what `quant.tc_plan` returns for it, and what the C entry points check.
inline bool plan_ok(int layout, int M, int K, int N, int ldw, int G, int splits,
                    int span) {
  if (splits < 1 || splits > MAX_SPLITS || span < BK || span % BK) return false;
  if ((long long)splits * span < K || (long long)(splits - 1) * span >= K) return false;
  if (M < 1 || N < 1 || K % 8 || ldw % 16 || ldw < (layout == C4 ? N - N / 2 : N))
    return false;
  if (G > 0 && (layout == INT8 || K % G || (K / G) % 16 || (layout == K4 && G % 2)))
    return false;
  return true;
}

// The launch: x (M, K) bf16 and w (K, ldw) (C4, INT8) or (K/2, ldw) (I4,
// K4) int8, both 16-byte aligned; residual (M, N) bf16 or NULL; for K4 and
// for a call with a norm weight (I4, K4, INT8), xn, (M, K) bf16 and 16-byte aligned,
// takes the activations `rows_kernel` writes (C4 folds neither). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan or an operand
// the kernel does not take or a tensor map cuTensorMapEncodeTiled refuses.
template <int LAYOUT, bool GROUPED>
int launch(const void* x, const void* w, const void* scale, const void* nw,
           const void* res, void* out, void* xn, int M, int K, int N, int ldw, int G,
           float eps, int out_f32, int splits, int span, cudaStream_t stream) {
  constexpr bool ROWS = LAYOUT != C4;
  const bool staged = ROWS && (nw != nullptr || LAYOUT == K4);
  if (GROUPED != (G > 0) || !plan_ok(LAYOUT, M, K, N, ldw, G, splits, span) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      (!ROWS && (nw != nullptr || res != nullptr)) ||
      (staged && (xn == nullptr || reinterpret_cast<uintptr_t>(xn) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (ROWS) {
    if (staged) {
      rows_kernel<LAYOUT><<<M, ua2::THREADS, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(nw),
          static_cast<__nv_bfloat16*>(xn), K, eps);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
  }
  CUtensorMap tx, tw;
  const bool mapped =
      map2d(&tx, staged ? xn : x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K, K * 2, BN, BK,
            CU_TENSOR_MAP_SWIZZLE_128B) &&
      (LAYOUT == INT8 ? map2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, ldw, ldw, BK, COLS,
                              CU_TENSOR_MAP_SWIZZLE_128B)
       : ROWS ? map2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, K / 2, ldw, ldw, BK / 2, COLS,
                      CU_TENSOR_MAP_SWIZZLE_128B)
              : map2d(&tw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, K, ldw, ldw, BK, BC,
                      CU_TENSOR_MAP_SWIZZLE_64B));
  if (!mapped) return (int)cudaErrorInvalidValue;
  constexpr int SMEM = smem(LAYOUT);
  auto kernel = gemv_tc_kernel<LAYOUT, GROUPED>;
  static bool ready[64] = {};     // the shared-memory cap, raised once a device
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready[dev] = true;
  }
  const int tiles = ROWS ? (N + COLS - 1) / COLS : (N - N / 2 + BC - 1) / BC;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, splits, (M + BN - 1) / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, tx, tw, static_cast<const float*>(scale),
                         static_cast<const __nv_bfloat16*>(res), out, M, K, N, G,
                         out_f32, span);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace ua2
