// Flash attention for sm_90a on the tensor cores' warpgroup products
// (wgmma) and the Tensor Memory Accelerator (TMA): non-causal for the codec
// DiT, causal with grouped K/V heads for the backbone's prefill probe.
//
// Replaces: `_flash_attention` (uniaudio2_tpu/codec/dit.py:174-193), which
// calls JAX's bundled Pallas TPU `flash_attention` with the sequence padded
// to 128 and segment ids masking the pad; and `bb_flash`
// (scripts/profile_attention.py:102-108), the same bundled kernel with
// `causal=True` over K/V repeated from G groups to H heads.
//
//   o[b, h, i, :] = sum_j softmax_j(q[b, h, i] . k[b, g, j] * scale) v[b, g, j, :]
//   g = h / (H / G); causal: only keys j <= i
//
// q, o: (B, H, T, HD), k, v: (B, G, T, HD) bf16, contiguous, HD in {64,
// 128}, H % G == 0, any T >= 1. The head map reads each group's K/V in
// place (nothing repeated in memory: the same function as JAX's
// `jnp.repeat`). On the codec path B = 2 (the CFG pair), H = G = 24,
// HD = 64 and T = 186, 374 or 750 (the 7.5, 15 and 30 s windows); the
// prefill probe runs B = 1, H = 24, G = 8, HD = 128, T = 2048, causal.
//
// Bound: non-causal, 4 * B * H * T^2 * HD operations (Q.K^T and P.V)
// against the bf16 dense peak of 989 TFLOP/s, and the bytes of q, k, v and
// o against 3.35 TB/s. At B = 2, H = 24, T = 750, HD = 64 that is 6.9 GFLOP
// (7.0 us) against 18.4 MB (5.5 us): the tensor cores bound it, narrowly.
// Causal at the prefill shape: half the products, 25.8 GFLOP (26 us), against
// 33.6 MB (10 us): the tensor cores bound it. The scores never touch device
// memory.
//
// Design (the card's full tensor-core rate is reached only through wgmma,
// and a tile's loads must overlap the products of the tiles before it):
//  * one block per (query tile, b, h): NC consumer warpgroups of 64 query
//    rows each (wgmma's M; the tile is BQ = 64 NC rows) and one producer
//    warp. NC = 1 at HD = 64 (74,792 bytes of shared memory and 160
//    threads a block: the non-causal kernel's 128 registers let three
//    blocks share an SM, the causal one's 168 two, each block's softmax
//    overlapping another's products) and NC = 2 at HD = 128 (the two
//    warpgroups share each staged K/V tile; one block an SM). The host
//    (`flash_attention.flash_plan`) passes the tile, and the kernel's
//    constants are read back through `ua2_flash_layout`;
//  * loads by TMA through 3-D tensor maps (HD, T, B * heads) built on the
//    host per call and passed as __grid_constant__ parameters: Q's tile
//    once, K and V tiles of BK = 128 keys through a ring of STAGES = 2
//    stages in dynamic shared memory, each with a `full` mbarrier (the
//    producer's expected bytes) and an `empty` one (every consumer thread
//    arrives once its P.V of the stage has completed), so the next tile's
//    load runs under this tile's products. Rows past T are zero-filled by
//    the TMA unit and never read from the next head. Every tile lands in
//    64-column panels in the 128-byte-swizzled layout that wgmma reads;
//  * S = Q.K^T: wgmma m64n128k16, A = Q and B = K from shared memory, both
//    contraction-major; O += P.V: wgmma m64n{HD}k16 with A = P from
//    registers (the f32 S accumulator rounded to bf16 in place: its
//    fragment is the register-A fragment) and B = V from shared memory with
//    the transpose bit (V's contraction axis is its row axis). f32 sums;
//  * online softmax in f32 registers: a running max and sum per row, the
//    scale folded with log2(e) into one ex2; P is rounded to bf16 before
//    P.V and the row sum adds the rounded values, so O / l is a convex
//    combination; O / l is rounded to bf16 once. Keys j >= T count as
//    -inf, rows i >= T are not written;
//  * causal: key tiles past the query tile's last row are never loaded,
//    only tiles that reach past a warpgroup's first row are masked, and the
//    longest query tiles start first (the tile index is the grid's slow
//    axis, counted down);
//  * no atomics: every run gives the same bits.
// Not here: issuing one tile's Q.K^T with the previous tile's P.V inside a
// warpgroup (tried at HD = 128 with a producer warpgroup handing its
// registers over by setmaxnreg: ptxas waited for each product (C7513) and
// it ran no faster), persistent blocks, fp8.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 128;       // keys a K/V stage
constexpr int STAGES = 2;     // K/V stages in the ring
constexpr int PANEL = 64;     // bf16 columns a 128-byte swizzled panel holds
constexpr int ROW_BYTES = 128;

__host__ __device__ constexpr int tile_bytes(int hd, int rows) {
  return hd / PANEL * rows * ROW_BYTES;
}

// Dynamic shared memory of one block: Q's tile, the K and V stages, the
// 2 STAGES + 1 mbarriers, and the slack that aligns the tiles to 1024
// bytes (the 128-byte swizzle's period).
__host__ __device__ constexpr int smem_bytes(int hd, int bq) {
  return tile_bytes(hd, bq) + 2 * STAGES * tile_bytes(hd, BK) + 8 * (2 * STAGES + 1) +
         1024;
}

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

// Until the phase of parity `parity` of the barrier has completed.
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

// A box of the 3-D tensor map at (c0, c1, c2) into shared memory, completing
// its bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor of the 128-byte-swizzled layout: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
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

// Until every committed wgmma of this warpgroup has completed.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Pins registers that a wgmma reads or writes at this point of the
// program: after a wait, so that nothing reads an accumulator early; before
// wgmma.fence, so that the instructions that define an operand (P, the
// rescaled O) stay ahead of the products (a definition between two wgmma of
// one fence region makes ptxas wait for each product, note C7513).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// d (64 x 128, f32) {=, +=} A (64 x 16) . B (128 x 16)^T, both bf16 from shared
// memory through descriptors, both contraction-major; the product replaces
// d when scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (16 x 64, bf16 in
// shared memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers) . B (16 x 128, bf16 in
// shared memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S = Q.K^T for one warpgroup's 64 rows and a stage's 128 keys, HD / 16
// k-steps: 32 bytes into a panel's 128-byte rows a step, the next panel
// after four.
template <int HD, int BQ>
__device__ __forceinline__ void mma_qk(float (&sc)[BK / 2], uint32_t q_wg,
                                         uint32_t k_st) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = sw128_desc(q_wg + (kk / 4) * BQ * ROW_BYTES + off, 16, 1024);
    const uint64_t db = sw128_desc(k_st + (kk / 4) * BK * ROW_BYTES + off, 16, 1024);
    wgmma_ss_n128(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// O += P.V over BK / 16 k-steps of 16 keys: two 8-key groups of 1024 bytes
// a step; V's two panels (HD = 128) BK rows apart.
template <int HD>
__device__ __forceinline__ void mma_pv(float (&acc)[HD / 2],
                                         const uint32_t (&pf)[BK / 16][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = sw128_desc(v_st + kk * 2048, BK * ROW_BYTES, 1024);
    if constexpr (HD == 64)
      wgmma_rs_n64(acc, pf[kk], db);
    else
      wgmma_rs_n128(acc, pf[kk], db);
  }
  wgmma_commit();
}

// One key tile's softmax step for rows r0 and r1 = r0 + 8 of this thread
// (keys k0 ...): keys past T, and causal past each row, count as -inf (only
// a tile that reaches past T or past the warpgroup's first row has any);
// the new running maxima m0 / m1 and the factors al0 / al1 that rescale the
// old sums; P = exp2(S * scale_log2 - max) rounded to bf16 into register-A
// fragments (the A registers of P.V's k-step kk are S's registers
// 8 kk .. 8 kk + 7); this thread's share of the row sums of the rounded P.
template <bool CAUSAL>
__device__ __forceinline__ void softmax_tile(const float (&sc)[BK / 2],
                                             uint32_t (&pf)[BK / 16][4], int k0, int T,
                                             int row0, int r0, int r1, int t,
                                             float scale_log2, float& m0, float& m1,
                                             float& al0, float& al1, float& rs0,
                                             float& rs1) {
  const bool masked = k0 + BK > T || (CAUSAL && k0 + BK - 1 > row0);
  // the limits of this thread's keys 2 t + 8 j8 + e: key j of row r is
  // live when j < lim (lim = T, or causal min(T, r + 1))
  const int lim0 = CAUSAL ? min(T, r0 + 1) : T, lim1 = CAUSAL ? min(T, r1 + 1) : T;
  auto s0 = [&](int i) {     // row r0's score of register i (i % 4 < 2)
    return masked && k0 + 8 * (i / 4) + 2 * t + (i % 2) >= lim0 ? -INFINITY : sc[i];
  };
  auto s1 = [&](int i) {     // row r1's (i % 4 >= 2)
    return masked && k0 + 8 * (i / 4) + 2 * t + (i % 2) >= lim1 ? -INFINITY : sc[i];
  };
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j8 = 0; j8 < BK / 8; ++j8) {
    mx0 = fmaxf(mx0, fmaxf(s0(4 * j8), s0(4 * j8 + 1)));
    mx1 = fmaxf(mx1, fmaxf(s1(4 * j8 + 2), s1(4 * j8 + 3)));
  }
  const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
  al0 = ex2((m0 - mn0) * scale_log2);
  al1 = ex2((m1 - mn1) * scale_log2);
  m0 = mn0;
  m1 = mn1;
  const float off0 = mn0 * scale_log2, off1 = mn1 * scale_log2;
  rs0 = rs1 = 0.f;
#pragma unroll
  for (int j8 = 0; j8 < BK / 8; ++j8) {
    const __nv_bfloat162 p0 =
        __floats2bfloat162_rn(ex2(fmaf(s0(4 * j8), scale_log2, -off0)),
                              ex2(fmaf(s0(4 * j8 + 1), scale_log2, -off0)));
    const __nv_bfloat162 p1 =
        __floats2bfloat162_rn(ex2(fmaf(s1(4 * j8 + 2), scale_log2, -off1)),
                              ex2(fmaf(s1(4 * j8 + 3), scale_log2, -off1)));
    rs0 += __low2float(p0) + __high2float(p0);
    rs1 += __low2float(p1) + __high2float(p1);
    pf[j8 / 2][(j8 % 2) * 2] = as_u32(p0);
    pf[j8 / 2][(j8 % 2) * 2 + 1] = as_u32(p1);
  }
}

template <int HD>
__device__ __forceinline__ void rescale(float (&acc)[HD / 2], float al0, float al1) {
#pragma unroll
  for (int j8 = 0; j8 < HD / 8; ++j8) {
    acc[4 * j8] *= al0;
    acc[4 * j8 + 1] *= al0;
    acc[4 * j8 + 2] *= al1;
    acc[4 * j8 + 3] *= al1;
  }
}

// Fragments (PTX ISA, wgmma m64nNk16): warp u of a warpgroup holds rows
// 16 u + gq and 16 u + gq + 8 (lane = 4 gq + t); accumulator register
// 4 n + e (e < 2) is row 16 u + gq, column 8 n + 2 t + e, and 4 n + 2 + e
// the row 8 below. The register-A fragment of a k-step of 16 is the
// accumulator's layout over 16 columns.
template <int HD, bool CAUSAL, int NC>
__global__ void __launch_bounds__(NC * 128 + 32, 1)
flash_attn_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int T, int H, int G,
                  float scale_log2) {
  constexpr int BQ = 64 * NC;
  static_assert(smem_bytes(HD, BQ) <= 232448, "over the 227 KB a block may take");
  constexpr int NP = HD / PANEL;                      // panels a row
  constexpr int Q_BYTES = tile_bytes(HD, BQ);
  constexpr int KV_BYTES = tile_bytes(HD, BK);        // one K or V stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + Q_BYTES;                 // stage s at + s KV_BYTES
  const uint32_t v_s = k_s + STAGES * KV_BYTES;
  const uint32_t bars = v_s + STAGES * KV_BYTES;      // full[s], empty[s], q
  const uint32_t q_bar = bars + 16 * STAGES;

  const int bh = blockIdx.x;                          // b * H + h
  const int bg = bh / H * G + bh % H / (H / G);       // its K/V group
  const int tile = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = tile * BQ;
  const int k_end = CAUSAL ? min(T, q0 + BQ) : T;     // keys any row needs
  const int n_tiles = (k_end + BK - 1) / BK;
  // the warp index broadcast from lane 0, so that the compiler sees it (and
  // every descriptor made from it) as uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                     // the producer's arrival
      mbar_init(bars + 8 * (STAGES + s), NC * 128);   // every consumer thread
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NC) {
    // the producer: Q's tile, then the K/V ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, Q_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(q_s + p * BQ * ROW_BYTES, &tq, q_bar, p * PANEL, q0, bh);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        const uint32_t full = bars + 8 * s;
        if (n >= STAGES) mbar_wait(bars + 8 * (STAGES + s), ((n / STAGES) - 1) & 1);
        mbar_expect_tx(full, 2 * KV_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const uint32_t off = s * KV_BYTES + p * BK * ROW_BYTES;
          tma_load(k_s + off, &tk, full, p * PANEL, n * BK, bg);
          tma_load(v_s + off, &tv, full, p * PANEL, n * BK, bg);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 .. row0 + 63 of the tile. Every key
  // tile of the block holds a key < T and, causal, a key <= row0 (k0 is a
  // multiple of BK = 128 below q0 + BQ and q0 one of BQ = 64 or 128, so
  // k0 <= q0), so a live warpgroup's running maxima are finite from its
  // first tile on.
  const int wg = warp >> 2, u = warp & 3;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * wg;
  const int r0 = row0 + 16 * u + gq, r1 = r0 + 8;
  if (row0 >= T) {                                    // no live row: free the stages
    for (int n = 0; n < n_tiles; ++n) {
      mbar_wait(bars + 8 * (n % STAGES), (n / STAGES) & 1);
      mbar_arrive(bars + 8 * (STAGES + n % STAGES));
    }
    return;
  }
  const uint32_t q_wg = q_s + 64 * wg * ROW_BYTES;
  float acc[HD / 2], sc[BK / 2];
  uint32_t pf[BK / 16][4];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1, rs0, rs1;
  mbar_wait(q_bar, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int s = n % STAGES;
    mbar_wait(bars + 8 * s, (n / STAGES) & 1);
    wgmma_fence();
    mma_qk<HD, BQ>(sc, q_wg, k_s + s * KV_BYTES);
    wgmma_wait_all();
    fence_regs(sc);
    softmax_tile<CAUSAL>(sc, pf, n * BK, T, row0, r0, r1, t, scale_log2, m0, m1, al0, al1,
                         rs0, rs1);
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
    rescale<HD>(acc, al0, al1);
    fence_regs(acc);
    fence_regs(pf);
    wgmma_fence();
    mma_pv<HD>(acc, pf, v_s + s * KV_BYTES);
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(bars + 8 * (STAGES + s));               // the stage is free
  }

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  __nv_bfloat16* out = o + (size_t)bh * T * HD;
#pragma unroll
  for (int j8 = 0; j8 < HD / 8; ++j8) {
    const int c = 8 * j8 + 2 * t;
    if (r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * HD + c) =
          __floats2bfloat162_rn(acc[4 * j8] * inv0, acc[4 * j8 + 1] * inv0);
    if (r1 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r1 * HD + c) =
          __floats2bfloat162_rn(acc[4 * j8 + 2] * inv1, acc[4 * j8 + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no -lcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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

// The tensor map of a (heads, T, hd) bf16 tensor read in boxes of (rows,
// 64 columns) of one head, 128-byte swizzled; rows past T read as zeros.
bool tile_map(CUtensorMap* map, const void* x, int hd, int T, int heads, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)T, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)T * hd * 2};
  const cuuint32_t box[3] = {(cuuint32_t)PANEL, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
                strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, bool CAUSAL, int NC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           __nv_bfloat16* o, int B, int H, int G, int T, float scale_log2,
           cudaStream_t stream) {
  auto kernel = flash_attn_kernel<HD, CAUSAL, NC>;
  constexpr int smem = smem_bytes(HD, 64 * NC);
  static bool ready[64] = {};     // the shared-memory cap, raised once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready[dev] = true;
  }
  const dim3 grid(B * H, (T + 64 * NC - 1) / (64 * NC));
  kernel<<<grid, NC * 128 + 32, smem, stream>>>(tq, tk, tv, o, T, H, G, scale_log2);
  return (int)cudaGetLastError();
}

// The instantiations: 64 query rows a block at hd 64, 128 at hd 128.
bool instantiated(int hd, int bq) { return (hd == 64 || hd == 128) && bq == hd; }

}  // namespace

// The kernel's constants for a block of bq query rows at head dim hd:
// out[0] keys a K/V stage, out[1] stages in the ring, out[2] bytes of
// dynamic shared memory a block. Returns 0, or cudaErrorInvalidValue where
// no kernel is instantiated.
extern "C" int ua2_flash_layout(int hd, int bq, int* out) {
  if (!instantiated(hd, bq)) return (int)cudaErrorInvalidValue;
  out[0] = BK;
  out[1] = STAGES;
  out[2] = smem_bytes(hd, bq);
  return 0;
}

// q, o: (B, H, T, hd), k, v: (B, G, T, hd) bf16, 16-byte aligned; scale
// multiplies q.k before the softmax; causal masks keys past each row; bq is
// the query rows a block (`flash_attention.flash_plan`): 64 at hd 64, 128
// at hd 128. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another hd or bq, H % G != 0, or a tensor map cuTensorMapEncodeTiled
// refuses.
extern "C" int ua2_flash_attn(const void* q, const void* k, const void* v, void* o,
                              int B, int H, int G, int T, int hd, float scale,
                              int causal, int bq, void* stream) {
  if (G <= 0 || H % G != 0 || T < 1 || !instantiated(hd, bq))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!tile_map(&tq, q, hd, T, B * H, bq) || !tile_map(&tk, k, hd, T, B * G, BK) ||
      !tile_map(&tv, v, hd, T, B * G, BK))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  if (hd == 64)
    return causal ? launch<64, true, 1>(tq, tk, tv, out, B, H, G, T, scale_log2, st)
                  : launch<64, false, 1>(tq, tk, tv, out, B, H, G, T, scale_log2, st);
  return causal ? launch<128, true, 2>(tq, tk, tv, out, B, H, G, T, scale_log2, st)
                : launch<128, false, 2>(tq, tk, tv, out, B, H, G, T, scale_log2, st);
}
