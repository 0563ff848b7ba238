// Flash attention in float32 for sm_90a, on the CUDA cores: the codec DiT's
// attention when its tree is float32 (`init_decode_params`' default).
//
// Replaces: `_flash_attention` (uniaudio2_tpu/codec/dit.py:174-193) on
// float32 inputs. The JAX DiT's `_flash_ok` sends float32 q, k, v to the
// same Pallas TPU `flash_attention` as bf16 (dtype in (bfloat16, float32));
// flash_attn.cu is the bf16 form, this file the float32 one.
//
//   o[b, h, i, :] = sum_j softmax_j(q[b, h, i] . k[b, g, j] * scale) v[b, g, j, :]
//   g = h / (H / G)
//
// Non-causal only: the DiT is the only caller that sends float32.
// q, o: (B, H, T, HD), k, v: (B, G, T, HD) float32, contiguous, 16-byte
// aligned, HD in {64, 128}, H % G == 0, any T >= 1. On the codec path B = 2
// (the CFG pair), H = G = 24, HD = 64, T = 186, 374 or 750.
//
// Bound: 4 * B * H * T^2 * HD operations against float32's 67 TFLOP/s
// outside the tensor cores, and the bytes of q, k, v and o against
// 3.35 TB/s. At B = 2, H = 24, T = 750, HD = 64: 6.9 GFLOP (0.103 ms)
// against 36.9 MB (11 us): operations bound it.
//
// Design:
//  * the products are float32 FMAs on the CUDA cores, so the output keeps
//    float32 accuracy, as the einsum path computes it (TF32 on the tensor
//    cores keeps 10 bits of mantissa; a split form on the tensor cores is
//    left for later, ROADMAP queue 2);
//  * one block of 256 threads per (64 query rows, b, h), K/V in tiles of 64
//    keys. Both products are register-blocked as a SIMT GEMM: thread (r, c),
//    r = tid / 16, c = tid % 16, owns query rows r + 16 i and keys c + 16 j
//    (i, j < 4) of a score tile, and the same rows and output columns
//    4 c ... (and 64 + 4 c ... at HD 128) of O; each 16-byte shared load
//    feeds 16 FMAs. The sixteen threads of a row group are one half-warp,
//    so a row's max is four shuffles a tile; each thread keeps its own
//    part of the row sum, added across the half-warp once at the end;
//  * Q, K and V land in row-major shared memory by cp.async, rows padded by
//    4 floats so that the sixteen key rows a warp reads fall in distinct
//    banks; P goes through shared memory as [key][row group][i], one
//    16-byte read a key. K of the next tile loads under this tile's
//    softmax and P.V, V of the next tile under the next Q.K^T; keys past T
//    are zero-filled and masked;
//  * online softmax in float32: the running max a row, the scale folded
//    with log2(e) into one exp2 a score; O / l written once; rows past T
//    are not written;
//  * no atomics: every run gives the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                      // query rows a block
constexpr int BK = 64;                      // keys a tile
constexpr int THREADS = 256;                // 16 row groups x 16 key groups
constexpr int PP = 64 + 4;                  // floats a key's row of P

// Floats a row of the Q, K and V tiles (padded), and the dynamic shared
// memory of the kernel at head dim HD.
__host__ __device__ constexpr int pitch(int hd) { return hd + 4; }
__host__ __device__ constexpr int smem_bytes(int hd) {
  return 4 * (3 * BQ * pitch(hd) + BK * PP);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Until every cp.async group but the newest has landed.
__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Rows [row0, row0 + 64) of a (T, HD) matrix into a padded tile; rows past
// T read as zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int T) {
  constexpr int ROW4 = HD / 4;
  for (int i = threadIdx.x; i < 64 * ROW4; i += THREADS) {
    const int r = i / ROW4, c4 = i % ROW4;
    const bool ok = row0 + r < T;
    cp_async16(dst + r * pitch(HD) + 4 * c4, src + (size_t)(ok ? row0 + r : 0) * HD + 4 * c4,
               ok);
  }
}

// a * b + c, elementwise
__device__ __forceinline__ float4 fma4(float a, float4 b, float4 c) {
  return make_float4(fmaf(a, b.x, c.x), fmaf(a, b.y, c.y), fmaf(a, b.z, c.z),
                     fmaf(a, b.w, c.w));
}

__device__ __forceinline__ float4 mul4(float4 b, float a) {
  return make_float4(a * b.x, a * b.y, a * b.z, a * b.w);
}

// Grid: (query tiles, B * H).
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int G, int T,
                 float scale_log2) {
  constexpr int P = pitch(HD);
  constexpr int NV = HD / 64;               // float4s of O a thread holds a row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + BQ * P;
  float* vs = ks + BK * P;
  float* ps = vs + BK * P;                  // [key][row group r][i]
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const float* kg = k + ((size_t)b * G + h / (H / G)) * T * HD;
  const float* vg = v + ((size_t)b * G + h / (H / G)) * T * HD;
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int q0 = blockIdx.x * BQ;
  const int tiles = (T + BK - 1) / BK;

  load_tile<HD>(qs, q + (size_t)bh * T * HD, q0, T);
  load_tile<HD>(ks, kg, 0, T);
  cp_commit();
  load_tile<HD>(vs, vg, 0, T);
  cp_commit();

  float4 acc[4][NV];                        // O rows r + 16 i
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NV; ++n) acc[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0; t < tiles; ++t) {
    const int key0 = t * BK;
    cp_wait_all_but_one();                  // Q and K of tile t
    __syncthreads();
    float s[4][4];                          // rows r + 16 i, keys c + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (r + 16 * i) * P + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (c + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] = fmaf(qv[i].w, kv[j].w,
                         fmaf(qv[i].z, kv[j].z,
                              fmaf(qv[i].y, kv[j].y, fmaf(qv[i].x, kv[j].x, s[i][j]))));
    }
    __syncthreads();                        // every thread is done with K
    if (t + 1 < tiles) load_tile<HD>(ks, kg, key0 + BK, T);
    cp_commit();                            // (empty after the last tile)

    // online softmax: the row's max over its 16 key groups
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + c + 16 * j;
        s[i][j] = key < T ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[i], mx);     // finite: key 0 is in every row
      const float alpha = exp2f(m[i] - mn); // 0 while m is -inf
      m[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - mn);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int n = 0; n < NV; ++n) acc[i][n] = mul4(acc[i][n], alpha);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (c + 16 * j) * PP + 4 * r) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    cp_wait_all_but_one();                  // V of tile t
    __syncthreads();                        // and every thread's P

    const int keys = min(BK, T - key0);
#pragma unroll 4
    for (int j = 0; j < keys; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ps + j * PP + 4 * r);
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const float4 w = *reinterpret_cast<const float4*>(vs + j * P + 64 * n + 4 * c);
        acc[0][n] = fma4(p.x, w, acc[0][n]);
        acc[1][n] = fma4(p.y, w, acc[1][n]);
        acc[2][n] = fma4(p.z, w, acc[2][n]);
        acc[3][n] = fma4(p.w, w, acc[3][n]);
      }
    }
    __syncthreads();                        // every thread is done with V and P
    if (t + 1 < tiles) load_tile<HD>(vs, vg, key0 + BK, T);
    cp_commit();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    const int row = q0 + r + 16 * i;
    if (row < T) {
      const float inv = 1.f / sum;
      float* orow = o + ((size_t)bh * T + row) * HD;
#pragma unroll
      for (int n = 0; n < NV; ++n)
        *reinterpret_cast<float4*>(orow + 64 * n + 4 * c) = mul4(acc[i][n], inv);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H, int G,
           int T, float scale_log2, cudaStream_t stream) {
  auto kernel = flash_f32_kernel<HD>;
  constexpr int smem = smem_bytes(HD);
  static_assert(smem <= 232448, "over the 227 KB a block may take");
  static bool ready[64] = {};     // the shared-memory cap, raised once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !ready[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready[dev] = true;
  }
  kernel<<<dim3((T + BQ - 1) / BQ, B * H), THREADS, smem, stream>>>(q, k, v, o, H, G, T,
                                                                   scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, H, T, hd), k, v: (B, G, T, hd) float32, 16-byte aligned; scale
// multiplies q.k before the softmax. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another hd, H % G != 0, T < 1 or a pointer that
// is not 16-byte aligned.
extern "C" int ua2_flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                                  int B, int H, int G, int T, int hd, float scale,
                                  void* stream) {
  if (G <= 0 || H % G != 0 || T < 1 || B < 1 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  return hd == 64 ? launch<64>(fq, fk, fv, fo, B, H, G, T, scale_log2, st)
                  : launch<128>(fq, fk, fv, fo, B, H, G, T, scale_log2, st);
}
