// Flash attention for sm_90a: non-causal for the codec DiT, causal with
// grouped K/V heads for the backbone's prefill probe.
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
// 128}, H % G == 0. The head map reads each group's K/V in place (nothing
// repeated in memory: the same function as JAX's `jnp.repeat`). Keys at
// j >= T are masked out and rows i >= T are not written, so T needs no
// padding. On the codec path B = 2 (the CFG pair), H = G = 24, HD = 64 and
// T = 186, 374 or 750 (the 7.5, 15 and 30 s windows); the prefill probe
// runs B = 1, H = 24, G = 8, HD = 128, T = 2048, causal.
//
// Bound: non-causal, 4 * B * H * T^2 * HD operations (Q.K^T and P.V)
// against the bf16 dense peak of 989 TFLOP/s, and the bytes of q, k, v and
// o against 3.35 TB/s. At B = 2, H = 24, T = 750, HD = 64 that is 6.9 GFLOP
// (7.0 us) against 18.4 MB (5.5 us): the tensor cores bound it, narrowly.
// Causal at the prefill shape: half the products, 25.8 GFLOP (26 us), against
// 33.6 MB (10 us): the tensor cores bound it. The scores never touch device
// memory.
//
// Design (the simple first version):
//  * one block per (64-query tile, b, h); 4 warps, each owning 16 query rows
//    whose Q fragments it keeps in registers for the whole key loop;
//  * K and V tiles of 64 keys are staged in shared memory (rows padded by
//    8 bf16, so the fragment loads hit 32 distinct banks), zero past T;
//  * S = Q.K^T and O += P.V on the tensor cores with mma.sync m16n8k16
//    (bf16 in, f32 accumulate); the S accumulator fragment is the A
//    fragment of P.V, so P never leaves registers;
//  * online softmax in f32: running row max and sum, the scale folded with
//    log2(e) into one exp2f; P is rounded to bf16 before P.V and the row sum
//    adds the rounded values, so O / l is a convex combination;
//  * causal: key tiles past the query tile's last row are never loaded, the
//    diagonal tile masks j > i, and the query tiles run last first (the
//    longest blocks start first);
//  * O / l is rounded to bf16 once at the end; no atomics, so every run
//    gives the same bits. The non-causal path with H == G is the codec's
//    kernel unchanged.
// Not yet: wgmma, TMA, cp.async double buffering, warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * 16;   // query rows per block
constexpr int BK = 64;           // keys per staged tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 in one register, the lower index in the low half (the mma
// fragment order).
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment coordinates (PTX ISA, mma.m16n8k16): lane = 4 * g + t4. A holds
// rows g and g + 8, columns 2 * t4 (+1) and 2 * t4 + 8 (+1); B holds rows
// 2 * t4 (+1) and 2 * t4 + 8 (+1) of column g; C holds rows g and g + 8,
// columns 2 * t4 (+1).
template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int T, int H, int G,
                  float scale_log2) {
  constexpr int LD = HD + 8;   // padded shared-memory row, in bf16
  constexpr int KS = HD / 16;  // k-steps of Q.K^T
  constexpr int NT = HD / 8;   // n-tiles of O
  constexpr int ST = BK / 8;   // n-tiles of S
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];

  // blockIdx.y = b * H + h; the K/V group of head h is h / (H / G)
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const size_t base = (size_t)blockIdx.y * T * HD;
  const size_t kv_base = ((size_t)b * G + h / (H / G)) * T * HD;
  const int tile = CAUSAL ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  // causal: keys past the tile's last row (q0 + BQ - 1) are never needed
  const int k_end = CAUSAL ? min(T, q0 + BQ) : T;

  uint32_t qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    const int c = s * 16 + 2 * t4;
    const __nv_bfloat16* qp0 = q + base + (size_t)r0 * HD + c;
    const __nv_bfloat16* qp1 = q + base + (size_t)r1 * HD + c;
    qf[s][0] = r0 < T ? ld32(qp0) : 0u;
    qf[s][1] = r1 < T ? ld32(qp1) : 0u;
    qf[s][2] = r0 < T ? ld32(qp0 + 8) : 0u;
    qf[s][3] = r1 < T ? ld32(qp1 + 8) : 0u;
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < T) {
        kv = *reinterpret_cast<const uint4*>(k + kv_base + (size_t)(k0 + r) * HD + c);
        vv = *reinterpret_cast<const uint4*>(v + kv_base + (size_t)(k0 + r) * HD + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vv;
    }
    __syncthreads();

    // S = Q.K^T for this warp's 16 rows and the tile's 64 keys.
    float s[ST][4];
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * LD + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(s[n], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }

    // Mask keys past T (and, causal, past the row); running max of rows g
    // and g + 8.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < ST; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + n * 8 + 2 * t4 + e;
        if (j >= T) s[n][e] = s[n][2 + e] = -INFINITY;
        if (CAUSAL) {
          if (j > r0) s[n][e] = -INFINITY;
          if (j > r1) s[n][2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
    // Every tile holds a key < T, and causal, a key <= each row (key k0 <=
    // q0 <= r0), so the new maxima are finite.
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f((m0 - mn0) * scale_log2);
    const float al1 = exp2f((m1 - mn1) * scale_log2);
    const float off0 = mn0 * scale_log2, off1 = mn1 * scale_log2;
    m0 = mn0;
    m1 = mn1;

    // P = exp2(S * scale_log2 - max), rounded to bf16 into A fragments.
    uint32_t pf[BK / 16][4];
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < ST; ++n) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(
          exp2f(fmaf(s[n][0], scale_log2, -off0)), exp2f(fmaf(s[n][1], scale_log2, -off0)));
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(
          exp2f(fmaf(s[n][2], scale_log2, -off1)), exp2f(fmaf(s[n][3], scale_log2, -off1)));
      rs0 += __low2float(p0) + __high2float(p0);
      rs1 += __low2float(p1) + __high2float(p1);
      pf[n / 2][(n % 2) * 2 + 0] = pack2(__low2bfloat16(p0), __high2bfloat16(p0));
      pf[n / 2][(n % 2) * 2 + 1] = pack2(__low2bfloat16(p1), __high2bfloat16(p1));
    }
    l0 = l0 * al0 + quad_sum(rs0);
    l1 = l1 * al1 + quad_sum(rs1);

    // O = O * alpha + P.V
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const __nv_bfloat16* vr = vs + (kk * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* p = vr + j * 8;
        mma_bf16(acc[j], pf[kk], pack2(p[0], p[LD]), pack2(p[8 * LD], p[9 * LD]));
      }
    }
  }

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t4;
    if (r0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)r0 * HD + c) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)r1 * HD + c) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

}  // namespace

// q, o: (B, H, T, hd), k, v: (B, G, T, hd) bf16; scale multiplies q.k before
// the softmax; causal masks keys past each row. Returns cudaGetLastError()
// (cudaErrorInvalidValue for an hd other than 64 or 128, or H % G != 0).
extern "C" int ua2_flash_attn(const void* q, const void* k, const void* v, void* o,
                              int B, int H, int G, int T, int hd, float scale,
                              int causal, void* stream) {
  if (G <= 0 || H % G != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T,
        H, G, scale_log2);
    return (int)cudaGetLastError();
  };
  if (hd == 64) return causal ? args(flash_attn_kernel<64, true>)
                              : args(flash_attn_kernel<64, false>);
  if (hd == 128) return causal ? args(flash_attn_kernel<128, true>)
                               : args(flash_attn_kernel<128, false>);
  return (int)cudaErrorInvalidValue;
}
