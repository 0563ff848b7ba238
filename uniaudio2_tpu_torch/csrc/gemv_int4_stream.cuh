// Split-K GEMV whose weight bytes arrive by TMA, for sm_90a: the design
// of the four probes' GEMVs, rows 11-14. Included by gemv_int4_native.cu
// (row 11: the row-interleaved layout, I4, bytes row-major or
// chunk-major), gemv_int8_splitk.cu (row 12: the int8 layout, INT8, in
// one form), gemv_int4_sweep.cu (row 13: the K-split layout, K4, in
// twelve forms) and gemv_int4_stacked.cu (row 14: K4 layer l of a stack,
// l read on the device).
//
//   out (M, N) bf16 = x (M, K) bf16 @ unpack(W) (K, N) * scale (N,) f32
//
// with the sums in f32 and one rounding to bf16 after the scale.
//
// Bound: weight bytes. A call reads the K * N / 2 int4 bytes (K * N int8
// bytes) once and does 2 M (M) operations a byte (M <= 16), where the card
// does ~295 a byte: (3072, 8192) is 12.6 MB in int4, 3.8 us at 3.35 TB/s,
// and 25.2 MB in int8, 7.5 us; (3072, 5120) 7.9 MB, 2.4 us.
//
// Grid, plan and sum order are the split-K kernel's (gemv_int4_splitk.cuh):
//  * the grid is (column tiles of TN, S K-slices of `span` byte rows, tiles
//    of 16 activation rows); the S slices of a tile are one cluster
//    (S <= 8). The host picks (S, span): `quant.gemv_plan` at TN = 64 and
//    the plan's slice rule, `int4_stream.stream_plan` for the forms that
//    change either;
//  * four consumer warps. Warp w takes steps w, w + 4, ... of its slice (a
//    step: 8 byte rows, k = 16) on mma.sync m16n8k16, the up to 16
//    activation rows as A (rows past M are zeros), B the levels of byte
//    rows t and t + 4 (t = lane % 4) of tile column 8 gq + j (gq = lane / 4)
//    for MMA j of a 64-column half. The unpack is the split-K kernel's,
//    with no conversion (MAGIC: XOR 0x88888888, a byte permute, one LOP3,
//    one bf16x2 FMA of -136), or two shifts and two int -> float
//    conversions a byte (SHIFT, as gemv_common.cuh unpacks): the same exact
//    levels either way;
//  * the order of the sums: a warp's steps in slice order, one MMA a step
//    and 8-column group into f32 registers; the four warps' tiles added in
//    warp order (0 + w0 + w1 + w2 + w3); the cluster's partial tiles added
//    in rank order through distributed shared memory, rank r finishing
//    outputs r, r + S, ... of the tile (0 + p0 + ... + p(S-1)); times the
//    scale; one rounding. That is the split-K kernel's order step for step,
//    so with the same (S, span) and TN = 64 the two give the same bits on
//    the same bytes (`quant.int4i_matmul` for I4, `quant.int4_matmul` for
//    K4, at M <= 16). TN, BK, STAGES and the unpack change no sum: the
//    forms that share (S, span) give the same bits;
//  * INT8 (one level a byte row) takes the split-K kernel's INT8 steps: 16
//    byte rows a step, a lane's rows t, t + 4, t + 8 and t + 12, the host's
//    rows "pairs" (row 16 s + j with 16 s + j + 8, j < 8; a slice of `span`
//    pairs is 2 span byte rows, a box of BK pairs 2 BK byte rows), the
//    unpack without conversions (a byte permute puts level + 128 under
//    2^23, one FADD, one cvt a pair of levels): `quant.int8_matmul`'s bits
//    at M <= 16 on `quant.gemv_plan`'s slices, in one launch.
//
// What is new is how the bytes arrive:
//  * one producer warp (one elected thread) keeps a ring of STAGES stages
//    full by TMA. A stage is BK byte rows of the tile's TN bytes, loaded as
//    TN / 32 boxes of (BK rows x 32 bytes), one plane of the stage each,
//    with a `full` mbarrier (the stage's bytes) and an `empty` one (the
//    four consumer warps). The consumers wait on full, load their B bytes
//    from the stage (two 8-byte loads a step and half: rows t and t + 4 of
//    the lane's 8 columns) and arrive on empty. The registers in which the
//    split-K kernel keeps 8 steps of loads in flight a warp are free; the
//    bytes in flight are STAGES x BK x TN a block;
//  * Little's law: 3.35 TB/s x ~1 us of latency is ~3.4 MB in flight over
//    132 SMs, ~25 KB an SM. Form 0 (TN 64, BK 64, 4 stages) has 16 KB in
//    flight a block, and the plan aims at 2.25 blocks an SM: ~36 KB;
//  * the 32-byte planes keep the consumers' shared loads free of bank
//    conflicts: a load's lanes 0-15 (gq < 4) read columns 0-31 of rows
//    t = 0..3 of a step, 4 consecutive rows of one plane (128 contiguous
//    bytes, every bank once), lanes 16-31 the same of the next plane. In a
//    64-byte-wide box rows t and t + 2 lie 128 bytes apart, in the same
//    banks, and neither the 64-byte nor the 128-byte swizzle separates
//    them (both XOR a row's 16-byte chunks by 1 there, which keeps a
//    32-byte run where it was): a two-way conflict. So the stage is not
//    swizzled. The A fragments (x staged as the split-K kernel stages it,
//    rows 4 words past a multiple of 32 apart) are conflict-free too;
//  * row-major (K/2, ldw) bytes are one 2-D map (ldw bytes x K/2 rows;
//    INT8 (K, ldw), K rows); chunk-major (C, K/2, bn) bytes one map (bn
//    bytes x C K/2 rows), the box of column tile col0 at (col0 % bn + 32 p,
//    (col0 / bn) K/2 + r): TN divides bn, so a box never straddles a chunk.
//    A stack of L (K/2, ldw) layers (row 14) is one map over all of it (ldw
//    bytes x L K/2 rows): the producer reads the layer l from the device
//    and adds l K/2 to every box's row, the consumers read l for the scale
//    row while they stage x, so nothing is sliced on the host and a
//    captured launch whose index the device advances walks the stack. An l
//    outside [0, L) issues no box and writes NaN (every block of a cluster
//    reads the same l, so they all skip the ring and meet at the same
//    cluster barriers). The last box of a slice may reach past it (into
//    the next slice's rows, the next layer's, or zeros past the map); the
//    consumers zero the bytes of rows past the slice, as the split-K
//    kernel's loads do, and x is zero there;
//  * the activations, the slice's span of up to 16 rows, are staged once by
//    the consumers while the producer's first boxes are in flight, as the
//    split-K kernel stages them: (x[2r], x[2r + 1]) a word for I4,
//    (x[r], x[K/2 + r]) for K4, (x[16 s + j], x[16 s + j + 8]) for INT8's
//    pair r = 8 s + j, rows past M and past the slice zero;
//  * edges: a partial last column tile (N = 12300) reads the rows' padding
//    (zeros past ldw) and the store masks c >= N; a short slice (K = 256
//    or 512: one slice of one or two boxes) fills less than the ring; any
//    M, in tiles of 16 rows.
// mma.sync, not wgmma: at M <= 16 the kernel does 2 M operations a weight
// byte where the card does ~295, and wgmma's 64-row tiles would leave the
// byte bound where it is; the tensor cores sit idle either way.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "gemv_common.cuh"
#include "gemv_int4_splitk.cuh"

namespace ua2 {
namespace stream {

namespace cg = cooperative_groups;

constexpr int CONSUMERS = 128;              // four MMA warps
constexpr int NWARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;     // + the producer warp
constexpr int STEP = splitk::STEP;          // byte rows of a warp step (k = 16)
constexpr int MROWS = splitk::MROWS;        // activation rows of a block
constexpr int PLANE = 32;                   // bytes of a box row
constexpr int MAX_SPLITS = splitk::MAX_SPLITS;
constexpr int SMEM_CAP = 232448;            // the 227 KB a block may take
constexpr int SHIFT = 0, MAGIC = 1;         // unpacks (part of the C interface)

// Byte rows of one of the host's rows: a byte row of the int4 layouts,
// INT8's pair of rows.
__host__ __device__ constexpr int row_bytes(int layout) { return layout == INT8 ? 2 : 1; }

// The ring of boxes of `bk` byte rows during the loop, the four warps'
// partial tiles after it.
__host__ __device__ inline int region_bytes(int tn, int bk, int stages) {
  const int ring = stages * bk * tn, red = NWARPS * MROWS * (tn + 1) * 4;
  return align16(ring > red ? ring : red);
}

// Dynamic shared memory of a launch of M rows, boxes of `bk` byte rows and
// slices of `span` (pair) rows: 128 bytes of alignment slack, the region,
// the staged activations
// (8 or 16 rows of splitk::staged_rows words), the block's (16, TN) partial
// tile, the tile's TN scales, the 2 STAGES mbarriers.
__host__ __device__ inline int smem_bytes(int tn, int bk, int stages, int M, int span) {
  return 128 + region_bytes(tn, bk, stages) +
         align16(splitk::staged_m(M, 0) * splitk::staged_rows(span) * 4) +
         (MROWS + 1) * tn * 4 + 16 * stages;
}

// The consumer warps' barrier (the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// The levels of byte jc of the raw words ra (row t) and rb (row t + 4) as
// two B registers: b0 the low nibbles', b1 the high nibbles', row t's in
// the low half. Two shifts and two int -> float conversions a byte.
__device__ __forceinline__ void shift_levels(unsigned ra, unsigned rb, int jc, unsigned& b0,
                                             unsigned& b1) {
  const unsigned ua = ra << (24 - 8 * jc), ub = rb << (24 - 8 * jc);
  b0 = splitk::pack_bf2((float)((int)(ua << 4) >> 28), (float)((int)(ub << 4) >> 28));
  b1 = splitk::pack_bf2((float)((int)ua >> 28), (float)((int)ub >> 28));
}

struct Args {
  const __nv_bfloat16* x;
  const float* scale;
  __nv_bfloat16* out;
  int M, K, N, span;
  int bn;             // chunk width of chunk-major bytes, 0 = row-major
};

// Row 14's operands: `scale` is the stack's (L, s_stride) scales and
// `layer` one int32 on the device. A type of its own, so that rows 11, 12
// and 13's kernel parameters stay as they were: seven more fields in the
// split-K kernel's by-value Args cost it up to 1.87x at 16 rows (PERF.md).
struct StackedArgs : Args {
  const int* layer;
  long long s_stride;   // floats between two layers' scales
  int L;
};

template <bool STACKED>
using StreamArgs = std::conditional_t<STACKED, StackedArgs, Args>;

template <int LAYOUT, int TN, int BK, int STAGES, int UNPACK, bool STACKED = false>
__global__ void __launch_bounds__(THREADS)
gemv_stream_kernel(const __grid_constant__ CUtensorMap wmap, const StreamArgs<STACKED> p) {
  static_assert(LAYOUT == I4 || LAYOUT == K4 || LAYOUT == INT8,
                "row-packed int4 or int8 layouts");
  static_assert(!STACKED || LAYOUT == K4, "the stack is row 14's K-split layout");
  static_assert(TN == 64 || TN == 128, "64-column halves");
  constexpr int RB = row_bytes(LAYOUT);          // byte rows of a (pair) row
  static_assert(BK % (STEP * NWARPS) == 0 && RB * BK <= 256, "whole steps of each warp a box");
  static_assert(STAGES >= 2 && STAGES <= 8, "a ring of 2-8 stages");
  constexpr int HALVES = TN / 64;
  constexpr int PLANES = TN / PLANE;
  constexpr int STAGE = RB * BK * TN;            // bytes of a stage
  constexpr int PLANE_BYTES = RB * BK * PLANE;
  constexpr int WARP_STEPS = BK / STEP / NWARPS;   // a warp's steps of a box
  constexpr int RS = TN + 1;                    // row stride of the warp partials
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int M = p.M, K = p.K, N = p.N, rows = K / 2;
  const int r0 = blockIdx.y * p.span;
  const int n_rows = max(min(rows, r0 + p.span) - r0, 0);
  // row 14: the layer; an index outside [0, L) runs no box
  int layer = 0;
  bool bad = false;
  if constexpr (STACKED) {
    layer = __ldg(p.layer);
    bad = layer < 0 || layer >= p.L;
  }
  const int boxes = bad ? 0 : (n_rows + BK - 1) / BK;
  const int xw = splitk::staged_rows(p.span);
  const int col0 = blockIdx.x * TN, m0 = blockIdx.z * MROWS;
  const int mt = min(MROWS, M - m0);              // live activation rows
  const int mr = splitk::staged_m(M, m0);          // staged rows
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int tid = threadIdx.x, lane = tid & 31;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const int region = region_bytes(TN, RB * BK, STAGES);
  unsigned char* ring = smem;                               // stage s at + s STAGE
  float* red = reinterpret_cast<float*>(smem);              // after the loop
  unsigned* xs = reinterpret_cast<unsigned*>(smem + region);  // mr x xw
  float* part = reinterpret_cast<float*>(
      smem + region + align16(splitk::staged_m(M, 0) * xw * 4));   // MROWS x TN
  float* sc = part + MROWS * TN;                            // the tile's scales
  const uint32_t bars = smem_u32(sc + TN);                  // full[s], then empty[s]

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                  // the producer's arrival
      mbar_init(bars + 8 * (STAGES + s), NWARPS);  // one lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NWARPS) {
    // the producer: box b holds slice (pair) rows [BK b, BK b + BK), TN / 32
    // planes
    if (lane == 0) {
      int c0 = col0, row0 = RB * r0;
      if (p.bn > 0) {
        c0 = col0 % p.bn;
        row0 = (col0 / p.bn) * rows + r0;
      }
      if constexpr (STACKED) row0 += layer * rows;
      for (int b = 0; b < boxes; ++b) {
        const int s = b % STAGES;
        const uint32_t full = bars + 8 * s;
        if (b >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((b / STAGES) - 1) & 1);
        mbar_expect_tx(full, STAGE);
        const uint32_t dst = smem_u32(ring + s * STAGE);
#pragma unroll
        for (int q = 0; q < PLANES; ++q)
          tma_load(dst + q * PLANE_BYTES, &wmap, full, c0 + PLANE * q, row0 + b * RB * BK);
      }
    }
  } else {
    // 0. the tile's scales, in flight while x is staged (stored after it;
    // row 14's after it, when the layer has come)
    float scale_c = 0.f;
    if constexpr (!STACKED)
      scale_c = tid < TN && col0 + tid < N ? __ldg(p.scale + col0 + tid) : 0.f;
    // 1. the slice's activations: row m's pair of slice row i at
    // xs[m * xw + i]; rows past the slice and past M are zero. With K a
    // multiple of 16 and x 16-byte aligned, in 16-byte loads (I4: 4 pairs;
    // K4: 8 of each half), four chunks a thread in flight: every column
    // tile reads the slice's x through L2, as many bytes as the weights at
    // M = 16, and 2-byte loads there cost more than the weights' stream.
    // INT8: a chunk of 8 pairs is x[16 s, 16 s + 16), its low and high 8
    if (K % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0) {
      constexpr int V = LAYOUT == I4 ? 4 : 8;         // pairs a chunk
      const int a0 = r0 & ~(V - 1);                   // the first chunk's pair row
      const int chunks = (r0 + xw - a0 + V - 1) / V;  // chunks over [r0, r0 + xw)
#pragma unroll 4
      for (int q = tid; q < mr * chunks; q += CONSUMERS) {
        const int m = q / chunks, rc = a0 + V * (q % chunks);
        uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
        if (m < mt && rc < r0 + n_rows) {
          const __nv_bfloat16* src = p.x + (size_t)(m0 + m) * K;
          lo = *reinterpret_cast<const uint4*>(src + (LAYOUT == K4 ? rc : 2 * rc));
          if (LAYOUT == K4) hi = *reinterpret_cast<const uint4*>(src + rows + rc);
          if (LAYOUT == INT8) hi = *reinterpret_cast<const uint4*>(src + 2 * rc + 8);
        }
        const unsigned lw[4] = {lo.x, lo.y, lo.z, lo.w}, hw[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int i = rc + j - r0;
          if (i < 0 || i >= xw) continue;
          unsigned v;
          if constexpr (LAYOUT == I4)
            v = lw[j % 4];
          else    // x[r] (INT8 x[16 s + j]) in the low half, x[K/2 + r]
                  // (x[16 s + j + 8]) in the high half
            v = __byte_perm(lw[j / 2], hw[j / 2], j % 2 ? 0x7632 : 0x5410);
          xs[m * xw + i] = i < n_rows ? v : 0u;
        }
      }
    } else {
      for (int i = tid; i < xw; i += CONSUMERS) {
        const int r = r0 + i;
        const int ka = LAYOUT == I4 ? 2 * r : LAYOUT == K4 ? r : 16 * (r >> 3) + (r & 7);
        const int kb = LAYOUT == I4 ? 2 * r + 1 : LAYOUT == K4 ? rows + r : ka + 8;
#pragma unroll
        for (int m = 0; m < MROWS; ++m) {
          if (m >= mr) break;
          __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
          if (m < mt && i < n_rows) {
            const __nv_bfloat16* src = p.x + (size_t)(m0 + m) * K;
            v.x = src[ka];
            v.y = src[kb];
          }
          xs[m * xw + i] = *reinterpret_cast<const unsigned*>(&v);
        }
      }
    }
    if constexpr (STACKED)
      scale_c = !bad && tid < TN && col0 + tid < N
                    ? __ldg(p.scale + (size_t)layer * p.s_stride + col0 + tid)
                    : 0.f;
    if (tid < TN) sc[tid] = scale_c;
    consumers_sync();

    // 2. the ring: step j of box b is slice rows i = BK b + 8 j ...; MMA j
    // of half h2 takes tile columns 64 h2 + 8 n + j (n = 0..7, the B
    // fragment's column); its k pairs are (low levels of rows t, t + 4)
    // and (high levels of rows t, t + 4) (INT8: rows t, t + 4 and rows
    // t + 8, t + 12 of the step's 16), and the A fragment pairs x alike
    const int t = lane & 3, gq = lane >> 2;
    // this lane's 8 bytes of a step's row t in a stage: column 8 gq of the
    // first half, in its plane
    const int w_off = (8 * gq / PLANE) * PLANE_BYTES + t * PLANE + 8 * gq % PLANE;
    float acc[HALVES][8][4];
#pragma unroll
    for (int h2 = 0; h2 < HALVES; ++h2)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h2][j][q] = 0.f;
    for (int b = 0; b < boxes; ++b) {
      const int s = b % STAGES;
      mbar_wait(bars + 8 * s, (b / STAGES) & 1);
      const unsigned char* stage = ring + s * STAGE;
#pragma unroll
      for (int u = 0; u < WARP_STEPS; ++u) {
        const int j = warp + NWARPS * u;          // the step in the box
        const int i = b * BK + STEP * j;          // its first slice row
        if (i >= n_rows) break;
        unsigned a[4];
        {
          const unsigned p0 = xs[gq * xw + i + t];
          const unsigned p4 = xs[gq * xw + i + t + 4];
          a[0] = __byte_perm(p0, p4, 0x5410);     // low levels' x, rows t, t + 4
          a[2] = __byte_perm(p0, p4, 0x7632);     // high levels' x
          a[1] = a[3] = 0u;
          if (mr > 8) {
            const unsigned q0 = xs[(gq + 8) * xw + i + t];
            const unsigned q4 = xs[(gq + 8) * xw + i + t + 4];
            a[1] = __byte_perm(q0, q4, 0x5410);
            a[3] = __byte_perm(q0, q4, 0x7632);
          }
        }
        const bool live_a = i + t < n_rows, live_b = i + t + 4 < n_rows;
#pragma unroll
        for (int h2 = 0; h2 < HALVES; ++h2) {
          const unsigned char* src =
              stage + (64 / PLANE) * h2 * PLANE_BYTES + RB * STEP * j * PLANE + w_off;
          if constexpr (LAYOUT == INT8) {
            // rows t, t + 4, t + 8, t + 12: pairs t, t + 4, t, t + 4
            uint2 w8[4];
#pragma unroll
            for (int l = 0; l < 4; ++l)
              w8[l] = (l & 1 ? live_b : live_a)
                          ? *reinterpret_cast<const uint2*>(src + 4 * l * PLANE)
                          : make_uint2(0u, 0u);
#pragma unroll
            for (int h = 0; h < 2; ++h) {         // word h: columns 4h..4h+3
              unsigned q[4];
#pragma unroll
              for (int l = 0; l < 4; ++l) q[l] = (h ? w8[l].y : w8[l].x) ^ 0x80808080u;
#pragma unroll
              for (int jc = 0; jc < 4; ++jc)
                splitk::mma(acc[h2][4 * h + jc], a,
                            splitk::pack_bf2(splitk::level8(q[0], jc), splitk::level8(q[1], jc)),
                            splitk::pack_bf2(splitk::level8(q[2], jc), splitk::level8(q[3], jc)));
            }
          } else {
            const uint2 wa = live_a ? *reinterpret_cast<const uint2*>(src) : make_uint2(0u, 0u);
            const uint2 wb = live_b ? *reinterpret_cast<const uint2*>(src + 4 * PLANE)
                                    : make_uint2(0u, 0u);
#pragma unroll
            for (int h = 0; h < 2; ++h) {         // word h: columns 4h..4h+3
              const unsigned ra = h ? wa.y : wa.x, rb = h ? wb.y : wb.x;
              if constexpr (UNPACK == MAGIC) {
                const unsigned xa = ra ^ splitk::OFFSET, xb = rb ^ splitk::OFFSET;
#pragma unroll
                for (int pr = 0; pr < 2; ++pr) {  // columns 4h + 2pr, + 1
                  // bytes: row t's two columns, then row t + 4's
                  const unsigned q = __byte_perm(xa, xb, pr ? 0x7632 : 0x5410);
#pragma unroll
                  for (int cc = 0; cc < 2; ++cc)
                    splitk::mma(acc[h2][4 * h + 2 * pr + cc], a,
                                splitk::levels2(q >> (8 * cc)),
                                splitk::levels2(q >> (8 * cc + 4)));
                }
              } else {
#pragma unroll
                for (int jc = 0; jc < 4; ++jc) {
                  unsigned b0, b1;
                  shift_levels(ra, rb, jc, b0, b1);
                  splitk::mma(acc[h2][4 * h + jc], a, b0, b1);
                }
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (STAGES + s));   // the stage is free
    }

    // 3. the block's partial tile: the warps' tiles added in warp order.
    // acc[h2][j] holds rows gq, gq + 8 and tile columns 64 h2 + 16 t + j,
    // + 8
    consumers_sync();                             // the ring now holds `red`
#pragma unroll
    for (int h2 = 0; h2 < HALVES; ++h2)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* dst = red + (warp * MROWS + gq) * RS + 64 * h2 + 16 * t + j;
        dst[0] = acc[h2][j][0];
        dst[8] = acc[h2][j][1];
        dst[8 * RS] = acc[h2][j][2];
        dst[8 * RS + 8] = acc[h2][j][3];
      }
    consumers_sync();
    for (int e = tid; e < mt * TN; e += CONSUMERS) {
      const int m = e / TN, c = e % TN;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < NWARPS; ++q) v += red[(q * MROWS + m) * RS + c];
      part[e] = v;
    }
  }

  // 4. across the cluster: rank r finishes outputs r, r + S, ... of the
  // tile, adding the ranks' partials in rank order, then the scale and one
  // rounding
  __syncwarp();                       // the producer warp's lanes meet again
  cluster.sync();
  if (warp < NWARPS) {
    for (int e = rank + S * tid; e < mt * TN; e += S * CONSUMERS) {
      const int row = m0 + e / TN, col = col0 + e % TN;
      if (col >= N) continue;
      float pv[MAX_SPLITS];           // every rank's partial read at once
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q)
        pv[q] = q < S ? cluster.map_shared_rank(part, q)[e] : 0.f;
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q)
        if (q < S) v += pv[q];
      v *= sc[e % TN];
      if constexpr (STACKED)
        if (bad) v = __int_as_float(0x7fc00000);    // no layer l: NaN
      p.out[(size_t)row * N + col] = __float2bfloat16(v);
    }
  }
  cluster.sync();                     // no block leaves while its tile is read
}

// True when `splits` K-slices of `span` (pair) rows cover the K/2 rows,
// none empty (`quant.splitk_slices`; INT8: whole steps of 16 byte rows).
inline bool plan_ok(int layout, int K, int splits, int span) {
  const int rows = K / 2;
  return splits >= 1 && splits <= MAX_SPLITS && span >= 1 &&
         (long long)splits * span >= rows && (long long)(splits - 1) * span < rows &&
         (layout != INT8 || (K % 16 == 0 && span % STEP == 0));
}

// One launch over the tensor map `map` with the operands `a`. Returns
// cudaGetLastError().
template <int LAYOUT, int TN, int BK, int STAGES, int UNPACK, bool STACKED>
inline int launch_map(const CUtensorMap& map, const StreamArgs<STACKED>& a, int splits,
                      cudaStream_t stream) {
  auto kernel = gemv_stream_kernel<LAYOUT, TN, BK, STAGES, UNPACK, STACKED>;
  const int smem = smem_bytes(TN, row_bytes(LAYOUT) * BK, STAGES, a.M, a.span);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + TN - 1) / TN, splits, (a.M + MROWS - 1) / MROWS);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, map, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Host launcher. w: (K/2, ldw) bytes row-major (bn = 0), or (ldw / bn,
// K/2, bn) chunk-major (int4 only); INT8 (K, ldw) row-major; 16-byte
// aligned, ldw (row-major) or bn (chunk-major) a multiple of 16. `splits`
// K-slices of `span` (pair) rows. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an operand or plan the kernel does not take or
// a tensor map cuTensorMapEncodeTiled refuses.
template <int LAYOUT, int TN, int BK, int STAGES, int UNPACK>
inline int launch(const void* x, const void* w, const void* scale, void* out, int M, int K,
                  int N, int ldw, int bn, int splits, int span, cudaStream_t stream) {
  constexpr int RB = row_bytes(LAYOUT);
  const int rows = K / 2;
  const int smem = smem_bytes(TN, RB * BK, STAGES, M, span);
  const bool layout_ok = bn > 0 ? LAYOUT != INT8 && bn % TN == 0 && ldw % bn == 0 &&
                                      bn % 16 == 0
                                : ldw % 16 == 0;
  if (M < 1 || N < 1 || K < 2 || K % 2 || ldw < N || !layout_ok ||
      !plan_ok(LAYOUT, K, splits, span) || smem > SMEM_CAP ||
      reinterpret_cast<uintptr_t>(w) % 16 || x == nullptr || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const bool mapped =
      bn > 0 ? map2d(&map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, (ldw / bn) * rows, bn, bn, BK,
                     PLANE, CU_TENSOR_MAP_SWIZZLE_NONE)
             : map2d(&map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, RB * rows, ldw, ldw, RB * BK,
                     PLANE, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!mapped) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M, a.K = K, a.N = N, a.span = span, a.bn = bn;
  return launch_map<LAYOUT, TN, BK, STAGES, UNPACK, false>(map, a, splits, stream);
}

// Row 14's launcher: layer *layer of a stack of L contiguous (K/2, ldw)
// K4 layers, w the stack's 16-byte aligned base (one map over all of it),
// scale (L, s_stride) f32, `layer` one int32 on the device. Returns as
// `launch` does.
template <int TN, int BK, int STAGES, int UNPACK>
inline int launch_stacked(const void* x, const void* w, const void* scale, const int* layer,
                          void* out, int M, int K, int N, int ldw, long long s_stride, int L,
                          int splits, int span, cudaStream_t stream) {
  const int rows = K / 2;
  const int smem = smem_bytes(TN, BK, STAGES, M, span);
  if (M < 1 || N < 1 || K < 2 || K % 2 || L < 1 || ldw < N || ldw % 16 || s_stride < N ||
      (long long)L * rows > 0x7fffffffLL || !plan_ok(K4, K, splits, span) ||
      smem > SMEM_CAP || reinterpret_cast<uintptr_t>(w) % 16 || x == nullptr ||
      scale == nullptr || layer == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!map2d(&map, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, L * rows, ldw, ldw, BK, PLANE,
             CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  StackedArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M, a.K = K, a.N = N, a.span = span, a.bn = 0;
  a.layer = layer, a.s_stride = s_stride, a.L = L;
  return launch_map<K4, TN, BK, STAGES, UNPACK, true>(map, a, splits, stream);
}

}  // namespace stream
}  // namespace ua2
