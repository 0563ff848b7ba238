// Flash attention in float32 for sm_90a: the codec DiT's attention when its
// tree is float32 (`init_decode_params`' default).
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
// Bound: 4 * B * H * T^2 * HD operations, and the bytes of q, k, v and o
// against 3.35 TB/s. At B = 2, H = 24, T = 750, HD = 64: 6.9 GFLOP against
// 36.9 MB (11 us): operations bound it, 0.103 ms at float32's 67 TFLOP/s
// outside the tensor cores; three TF32 products a product (below) at
// 495 TFLOP/s, 165 TFLOP/s of float32 work, 0.042 ms.
//
// Two kernels, one entry point each:
//  * `flash_f32_tc_kernel` (`ua2_flash_attn_f32`, the one the DiT runs):
//    both products on the tensor cores at float32 accuracy (3xTF32). Each
//    operand x is split into hi = tf32(x), rounded to nearest
//    (cvt.rna.tf32.f32), and lo = tf32(x - hi); a product is
//    lo.hi + hi.lo + hi.hi with f32 sums, which keeps ~22 bits of each
//    operand (3xBF16 would keep ~16, a residual near 2^-17 of the output,
//    too close to the 1e-5 gate). The products are mma.sync m16n8k8 TF32
//    with fragments loaded from shared memory by hand, not wgmma: wgmma
//    takes TF32 operands only K-major in shared memory, and for P.V the
//    contraction runs over keys, V's rows, so V would have to be staged
//    transposed (TMA does not transpose 4-byte elements). With fragments
//    loaded by hand no tile is transposed: an A fragment wants keys
//    (t, t + 4) of each 8 where an accumulator holds columns (2t, 2t + 1),
//    so K's rows are read in the order 0, 4, 1, 5, 2, 6, 3, 7 (ldmatrix
//    takes a row address a lane): S's accumulator then holds keys t and
//    t + 4 and is P's A fragment as it stands, and V's B fragment loads
//    rows t and t + 4 of a step.
//    The tensor cores' f32 sums do not round to nearest: carried in one
//    accumulator over a whole row of keys, the products of P.V lost ~1e-5
//    of the output at T = 750 (the 1e-5 gate). So P.V sums each 64-key
//    tile from zero and adds it to O in f32, and S keeps the hi.hi
//    products and the small terms in two accumulators, added at the end of
//    the tile: ~3e-6 of the output at T = 750, as the CUDA-core kernel.
//    A block is 4 warps and 64 query rows (16 a warp), K/V in tiles of 64
//    keys. Q, K and V land in row-major shared memory by cp.async (Q and K
//    rows padded by 4 floats, V rows by 8: every fragment load of a warp
//    hits 32 banks); Q is split once into hi and lo tiles, and K and V
//    stay as they land: each warp splits the fragments it loads (ldmatrix
//    for Q and K, two 4-byte loads a V fragment), which reads half the
//    bytes of staged hi and lo tiles and needs no pass over the tile (on
//    the H100 the two read the same time). K of the next
//    tile loads under this tile's softmax and P.V, V of the next under the
//    next Q.K^T. Online softmax in f32 on the S accumulator (a row's max
//    and sum over the quad of lanes that hold it), the scale folded with
//    log2(e) into one exp2 a score; O / l written once. 69 KB of shared
//    memory at HD 64 (three blocks an SM), 133 KB at HD 128.
//  * `flash_f32_simt_kernel` (`ua2_flash_attn_f32_simt`), the first design
//    and the yardstick: f32 FMAs on the CUDA cores, register-blocked as a
//    SIMT GEMM. One block of 256 threads per (64 query rows, b, h), K/V in
//    tiles of 64 keys; thread (r, c), r = tid / 16, c = tid % 16, owns
//    query rows r + 16 i and keys c + 16 j (i, j < 4) of a score tile, and
//    the same rows and output columns 4 c ... (and 64 + 4 c ... at HD 128)
//    of O; P goes through shared memory as [key][row group][i].
// Keys past T are zero-filled and masked, rows past T are not written; no
// atomics: every run gives the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                      // query rows a block (both kernels)
constexpr int BK = 64;                      // keys a tile (both kernels)
constexpr int THREADS = 256;                // SIMT: 16 row groups x 16 key groups
constexpr int PP = 64 + 4;                  // SIMT: floats a key's row of P
constexpr int TC_THREADS = 128;             // 3xTF32: 4 warps of 16 query rows

// Floats a row of the Q, K and V tiles (padded: 4 mod 32 banks), and the
// dynamic shared memory of each kernel at head dim HD: SIMT Q, K, V and P;
// 3xTF32 the hi and lo tiles of Q, K and V.
__host__ __device__ constexpr int pitch(int hd) { return hd + 4; }
__host__ __device__ constexpr int smem_bytes(int hd) {
  return 4 * (3 * BQ * pitch(hd) + BK * PP);
}
// 3xTF32: Q's hi and lo tiles, K, and V with rows padded by 8 floats (its
// fragment loads read rows t and t + 4 of a step at column g: 32 banks)
__host__ __device__ constexpr int vpitch(int hd) { return hd + 8; }
__host__ __device__ constexpr int tc_smem_bytes(int hd) {
  return 4 * (2 * BQ * pitch(hd) + BK * pitch(hd) + BK * vpitch(hd));
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
template <int HD, int NT, int PITCH = pitch(HD)>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int T) {
  constexpr int ROW4 = HD / 4;
  for (int i = threadIdx.x; i < 64 * ROW4; i += NT) {
    const int r = i / ROW4, c4 = i % ROW4;
    const bool ok = row0 + r < T;
    cp_async16(dst + r * PITCH + 4 * c4, src + (size_t)(ok ? row0 + r : 0) * HD + 4 * c4,
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
flash_f32_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
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

  load_tile<HD, THREADS>(qs, q + (size_t)bh * T * HD, q0, T);
  load_tile<HD, THREADS>(ks, kg, 0, T);
  cp_commit();
  load_tile<HD, THREADS>(vs, vg, 0, T);
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
    if (t + 1 < tiles) load_tile<HD, THREADS>(ks, kg, key0 + BK, T);
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
    if (t + 1 < tiles) load_tile<HD, THREADS>(vs, vg, key0 + BK, T);
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

// x rounded to TF32, to nearest (ties away from zero), as f32 bits.
__device__ __forceinline__ float tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d += A (16 x 8 tf32, row) * B (8 x 8 tf32, col), f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B at float32 accuracy, for a sum of few steps: lo.hi + hi.lo +
// hi.hi, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], unsigned bh0, unsigned bh1,
                                     unsigned bl0, unsigned bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

// Four 8 x 4 f32 matrices from shared memory (ldmatrix of 8 x 8 b16): lane
// L gives the address of row L % 8 of matrix L / 8, and gets element
// (L / 4, L % 4) of matrix j in r[j], the m16n8k8 fragments' (g, t).
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const float* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The 64 rows of the landed (padded) Q tile split in place: hi = tf32(x)
// over x, lo = tf32(x - hi) into `lo`.
template <int HD>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
  constexpr int ROW4 = HD / 4;
  for (int i = threadIdx.x; i < 64 * ROW4; i += TC_THREADS) {
    const int off = (i / ROW4) * pitch(HD) + 4 * (i % ROW4);
    const float4 x = *reinterpret_cast<const float4*>(hi + off);
    const float4 h = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) =
        make_float4(tf32(x.x - h.x), tf32(x.y - h.y), tf32(x.z - h.z), tf32(x.w - h.w));
  }
}

// x as the (hi, lo) TF32 pair of a 3xTF32 product, as b32 operands.
__device__ __forceinline__ void split2(unsigned x, unsigned& hi, unsigned& lo) {
  const float f = __uint_as_float(x), h = tf32(f);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(f - h));
}

// Grid: (query tiles, B * H). Warp w owns query rows 16 w + [0, 16) of the
// block's 64; lane (g, t) = (lane / 4, lane % 4) holds, as the m16n8
// fragments do, rows g and g + 8 of them; in S keys 8 n + t and 8 n + t + 4
// (n < 8: K's rows are read in the order 0, 4, 1, 5, 2, 6, 3, 7 of each 8,
// so that S's accumulator is P's A fragment of the next product as it
// stands), in O columns 8 n + 2 t, + 1 (n < HD / 8). Q is split once into
// hi and lo tiles; K and V stay as they land, and each warp splits the
// fragments it loads (three operations a value, against a pass over the
// tile, two barriers and twice the shared-memory reads).
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, HD == 64 ? 3 : 1)
flash_f32_tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, int H, int G, int T,
                    float scale_log2) {
  constexpr int P = pitch(HD);
  constexpr int PV = vpitch(HD);
  constexpr int ND = HD / 8;                // k-steps of Q.K^T, n-tiles of O
  extern __shared__ float4 smem4[];
  float* qh = reinterpret_cast<float*>(smem4);
  float* ql = qh + BQ * P;
  float* ks = ql + BQ * P;
  float* vs = ks + BK * P;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const float* kg = k + ((size_t)b * G + h / (H / G)) * T * HD;
  const float* vg = v + ((size_t)b * G + h / (H / G)) * T * HD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = 16 * (threadIdx.x >> 5);   // the warp's first row in the block
  const int q0 = blockIdx.x * BQ;
  const int tiles = (T + BK - 1) / BK;
  // ldmatrix rows of this lane: matrix j = lane / 8, row lr = lane % 8
  const int j = lane >> 3, lr = lane & 7;
  const int a_off = (wr + lr + 8 * (j & 1)) * P + 4 * (j >> 1);            // Q
  const int b_off = (8 * (j >> 1) + (lr >> 1) + 4 * (lr & 1)) * P + 4 * (j & 1);  // K
  const int v_off = t * PV + g;             // V: key t of a step, column g

  load_tile<HD, TC_THREADS, P>(qh, q + (size_t)bh * T * HD, q0, T);
  load_tile<HD, TC_THREADS, P>(ks, kg, 0, T);
  cp_commit();
  load_tile<HD, TC_THREADS, PV>(vs, vg, 0, T);
  cp_commit();

  float acc[ND][4];                         // O: rows g, g + 8 x columns 8 n + 2 t, + 1
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int key0 = tile * BK;
    cp_wait_all_but_one();                  // Q and K of this tile
    __syncthreads();
    if (tile == 0) {
      split_tile<HD>(qh, ql);
      __syncthreads();
    }
    // S: the hi.hi products in s, the small terms (lo.hi + hi.lo, 2^-11 of
    // their size) in se, added once at the end of the tile
    float s[8][4], se[8][4];                // rows g, g + 8 x keys 8 n + t, + 4
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = se[n][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < ND; ++kk) {
      unsigned ah[4], al[4];
      ldsm4(ah, qh + a_off + 8 * kk);
      ldsm4(al, ql + a_off + 8 * kk);
#pragma unroll
      for (int n = 0; n < 8; n += 2) {      // n-tiles n and n + 1
        unsigned kr[4], bh4[4], bl4[4];
        ldsm4(kr, ks + b_off + 8 * n * P + 8 * kk);
#pragma unroll
        for (int c = 0; c < 4; ++c) split2(kr[c], bh4[c], bl4[c]);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma_tf32(se[n + u], al, bh4[2 * u], bh4[2 * u + 1]);
          mma_tf32(se[n + u], ah, bl4[2 * u], bl4[2 * u + 1]);
          mma_tf32(s[n + u], ah, bh4[2 * u], bh4[2 * u + 1]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] += se[n][c];
    __syncthreads();                        // every warp is done with K
    if (tile + 1 < tiles) load_tile<HD, TC_THREADS, P>(ks, kg, key0 + BK, T);
    cp_commit();                            // (empty after the last tile)

    // online softmax over the quad of lanes that holds a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = key0 + 8 * n + t + 4 * c;
          float& x = s[n][2 * r + c];
          x = key < T ? x * scale_log2 : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);     // finite: the tile's key 0 is in every row
      const float alpha = exp2f(m[r] - mn); // 0 while m is -inf
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[n][2 * r + c];
          x = exp2f(x - mn);
          sum += x;
        }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    cp_wait_all_but_one();                  // V of this tile
    __syncthreads();

    // O += P V: the tile's 8 steps summed from zero in ot, then added to O
    // in f32 (round to nearest). Step kk over keys 8 kk + [0, 8): k index
    // t is key t, t + 4 key t + 4, for P (the S accumulator as it stands)
    // and V (rows t and t + 4 of the step, column g of each n-tile: 32
    // banks a load)
    float ot[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) ot[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float p4[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      unsigned ph[4], pl[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) split2(__float_as_uint(p4[c]), ph[c], pl[c]);
      const float* vk = vs + 8 * kk * PV + v_off;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        unsigned bh0, bl0, bh1, bl1;
        split2(__float_as_uint(vk[8 * n]), bh0, bl0);
        split2(__float_as_uint(vk[4 * PV + 8 * n]), bh1, bl1);
        mma3(ot[n], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] += ot[n][c];
    __syncthreads();                        // every warp is done with V
    if (tile + 1 < tiles) load_tile<HD, TC_THREADS, PV>(vs, vg, key0 + BK, T);
    cp_commit();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + wr + g + 8 * r;
    if (row < T) {
      const float inv = 1.f / sum;
      float* orow = o + ((size_t)bh * T + row) * HD + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <int HD, bool TC>
int launch(const float* q, const float* k, const float* v, float* o, int B, int H, int G,
           int T, float scale_log2, cudaStream_t stream) {
  auto kernel = TC ? flash_f32_tc_kernel<HD> : flash_f32_simt_kernel<HD>;
  constexpr int smem = TC ? tc_smem_bytes(HD) : smem_bytes(HD);
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
  kernel<<<dim3((T + BQ - 1) / BQ, B * H), TC ? TC_THREADS : THREADS, smem, stream>>>(
      q, k, v, o, H, G, T, scale_log2);
  return (int)cudaGetLastError();
}

template <bool TC>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B, int H, int G,
              int T, int hd, float scale, void* stream) {
  if (G <= 0 || H % G != 0 || T < 1 || B < 1 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  return hd == 64 ? launch<64, TC>(fq, fk, fv, fo, B, H, G, T, scale_log2, st)
                  : launch<128, TC>(fq, fk, fv, fo, B, H, G, T, scale_log2, st);
}

}  // namespace

// q, o: (B, H, T, hd), k, v: (B, G, T, hd) float32, 16-byte aligned; scale
// multiplies q.k before the softmax. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another hd, H % G != 0, T < 1 or a pointer that
// is not 16-byte aligned. The 3xTF32 tensor-core kernel.
extern "C" int ua2_flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                                  int B, int H, int G, int T, int hd, float scale,
                                  void* stream) {
  return launch_hd<true>(q, k, v, o, B, H, G, T, hd, scale, stream);
}

// The same on the CUDA cores (the first design, the yardstick).
extern "C" int ua2_flash_attn_f32_simt(const void* q, const void* k, const void* v,
                                       void* o, int B, int H, int G, int T, int hd,
                                       float scale, void* stream) {
  return launch_hd<false>(q, k, v, o, B, H, G, T, hd, scale, stream);
}
