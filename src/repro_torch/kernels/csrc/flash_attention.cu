// Flash attention (online softmax) and its backward for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _kernel): every attention layer of a prefill.
// Semantics are those of models/attention.py::chunked_attention (the
// plain version): q and k (B, T, H, d) and (B, S, H, d), v (B, S, H, dv),
// float32 or bfloat16, the output (B, T, H, dv); scores, running max,
// denominator and accumulator in float32; masked scores are -1e30 (a
// row with no visible key in a processed tile averages its values, as
// the plain version does); keys at or past S weigh 0; output in q's
// dtype. Key tiles that the causal or sliding-window mask leaves fully
// masked for every row of a block are not visited.
//
// What bounds it on this card: at the serve shapes (T = S = 64..384,
// H = 32, d = 128, bf16) the bytes (q, k, v read once, the output
// written once: 67 MB at (8, 256, 32, 128), ~20 us at 3.35 TB/s) bound
// it before the tensor cores do (4.3 GFLOP causal, ~4.4 us at 989
// TFLOP/s). Two variants; the wrapper picks one from (dtype, d, dv):
//
// * flash_wgmma_kernel<DQK, DV> (namespace wg), bfloat16 with (d, dv)
//   (64, 64), (128, 128) or MLA's (96, 64) (minicpm3-4b's prefill: nope
//   64 + rope 32 for q and k, 64 for v): the tensor-core design. A
//   block is a consumer warpgroup (warps 0-3, 64 query rows: wgmma's
//   M) and a producer warp, and walks one or more
//   64-row query tiles of one (head, batch) pair: as many as it takes to
//   give each SM two blocks (all 4 at (8, 256), 1 for a single request).
//   The producer keeps a two-deep Q ring and a two-stage K/V ring of
//   64-key tiles filled with TMA (cp.async.bulk.tensor over a rank-4
//   (d, head, position, batch) map, so rows past S are zero-filled and
//   never the next sequence's), K and V on mbarriers of their own, so
//   the next tiles' copies overlap this tile's math. Tiles stay bf16 in
//   shared memory with the 128-byte swizzle in whole atom columns of 64
//   (a d = 128 row is two; so is MLA's 96-wide q/k row: its second box
//   starts at column 64 of a 96-wide map, so the copy zero-fills columns
//   96-127, and S = Q K^T takes 6 k-steps, 4 in the first atom and 2 in
//   the second, never multiplying the zeros; the scale stays 96^-1/2),
//   16 KB per 64 x 128 tile, 8 KB per 64 x 64, 97 KB a block at
//   (128, 128), 81 KB at (96, 64): two blocks an SM. S = Q K^T is
//   wgmma m64n64k16 from shared memory (K row-major is the K-major B
//   operand); the softmax runs on the
//   accumulator fragment (thread lane of warp w holds rows
//   16 w + lane / 4 and + 8, columns 8 j + 2 (lane % 4) + {0, 1}; row max
//   and sum over the quad with two shuffles), with the per-element masks
//   only on the tiles a mask or the end of S reaches; P is rounded to
//   bf16 in registers and is wgmma's A fragment as it stands; O += P V
//   is wgmma m64n{dv}k16 with V as the transposed (dv-contiguous) B
//   operand. The output is divided once a row, staged through the
//   tile's Q buffer (swizzled chunks) and written with 16-byte stores.
//   Measured on an H100 (PERF.md): the copies hide behind the
//   math; what held earlier versions back was the epilogue (a division
//   and a scattered 4-byte store an element) and the masks on every
//   tile. The softmax between the two dependent wgmma groups of a tile
//   still serialises the tensor cores with the CUDA cores; issuing the
//   next tile's S before this tile's softmax (two S accumulators, 181
//   registers) was measured slower and is not used.
// * flash_fwd_kernel, float32 at any d and bfloat16 at other head dims
//   (8 <= d, dv <= 128, both multiples of 8; hubert's 80, MLA's float32
//   (96, 64)): the CUDA-core design, bf16 MLA's too before the wgmma
//   one took (96, 64). One block of four warps per (64-row query
//   tile, head, batch); the query tile is
//   staged once in shared memory, pre-scaled by d^-1/2; a loop over key
//   tiles of 64 stages K (row-major, rows padded by 4 floats so the
//   lanes' 16-byte reads of 32 different keys do not collide in a bank)
//   and V in shared memory as float32, computes each warp's 16 x 64
//   score tile with float32 FMAs (a lane owns two key columns), folds it
//   into the running max and denominator with warp shuffles, and
//   accumulates P V (a lane owns up to four of the dv <= 128 output
//   columns). Tiles come in with 16-byte global loads, eight in flight
//   per thread. Its products are full float32: the float32 callers
//   (the float32 logit check of a serve path) need that, and TF32
//   tensor cores would not give it. At d = dv = 128 a block needs
//   115,712 bytes of shared memory; at MLA's (96, 64) 74,752.
//
// Training. Both variants write each row's log-sum-exp of its scaled
// scores when given an `lse` pointer (serving passes null, and nothing
// else changes). The backward has no Pallas counterpart: the reference
// cannot differentiate its TPU kernel and trains through the plain
// chunked attention. Given O, L and dO it launches three kernels: a
// pass for D = rowsum(dO * O), a dK/dV kernel (a block a key tile,
// walking the query tiles that see it) and a dQ kernel (a block a
// query tile, walking its key tiles). Each recomputes the scores it
// needs, so no two blocks write one output: no atomics, and the same
// bits every run (the bit-exact resume of a training run rests on it).
// The price is seven 64 x 64 x d products a visible tile pair (dK/dV:
// S^T, dV, dP^T, dK; dQ: S, dP, dQ) where FlashAttention-2/3 do five
// and add dQ with atomics. Two variants, picked from (dtype, d, dv) as
// the forward's but for MLA, whose backward stays on the CUDA cores (it
// takes the wgmma forward's L as it takes its own):
//
// * flash_bwd_wgmma_dkdv_kernel / flash_bwd_wgmma_dq_kernel (namespace
//   wgb, flash_attention_wgmma_bwd), bfloat16 at d = dv in {64, 128}:
//   every product on wgmma (bf16 operands, float32 sums). A block is a
//   consumer warpgroup (the tile's 64 rows are wgmma's M) and a
//   producer warp: lane 0 brings the block's own tile pair (dK/dV: K,
//   V; dQ: Q, dO) once and the partner tiles through a two-stage
//   mbarrier ring with TMA over the forward's rank-4 maps (rows past T
//   or S zero-filled, never the next sequence's), bf16 in 128-byte
//   swizzled shared memory; the 32 lanes bring the partner tile's rows
//   of L (times log2 e) and D beside it (dK/dV; in dQ the block's own).
//   dK/dV a query tile: S^T = K Q^T (SS, both K-major); P^T = exp2(S^T
//   scale log2 e - L[col]) on the fragment, rounded to bf16 as the A
//   fragment; dV += P^T dO (RS, dO read N-major as the forward reads V)
//   and dP^T = V dO^T (SS) in one group; dS^T = P^T (dP^T - D[col])
//   from the bf16 P^T; dK += dS^T Q (RS). dQ a key tile: S = Q K^T and
//   dP = dO V^T in one group; P and dS = P (dP - D[row]) in float32;
//   dQ += dS K (RS). The masks only on the tile pairs a causal or
//   window edge or the end of T or S reaches; fully masked pairs are
//   not visited; the grid starts with the blocks that walk the most
//   partners (the first key tiles, the last query tiles). dK and dQ are
//   scaled by d^-1/2 once, and the outputs staged through shared memory
//   and written with 16-byte stores, as the forward's epilogue. What
//   bounds it: the dK/dV kernel holds dK and dV (64 + 64 float32 a
//   thread at d = 128), P^T as bf16 (16) and dP^T (32) at once: ptxas
//   gives it 234 registers, so one block an SM (capping it at two
//   blocks makes ptxas spill, and was measured slower); each SM then has
//   one consumer warpgroup whose softmax work stalls the tensor cores,
//   and the dQ kernel (155 registers) two. Two consumer warpgroups
//   sharing each Q/dO tile would need a producer warpgroup giving its
//   registers away (setmaxnreg): the next lever. P^T is kept only in bf16
//   across the group that computes dP^T, for the registers; dS^T takes
//   it as it is (the product rounds dS^T to bf16 anyway).
// * flash_bwd_dkdv_kernel / flash_bwd_dq_kernel (namespace bwd,
//   flash_attention_bwd), float32 at any head dims and bfloat16 at
//   other head dims or dv != d (MLA's (96, 64) too): float32 products and
//   sums on the CUDA cores, the tiles staged as float32; the float32
//   gradient check of a training run needs full float32 products.
// At qwen3-8b's training shape (2, 4096, 32, 128) bf16 causal the work
// is ~0.98 TFLOP of products (0.69 TFLOP the least: ~0.70 ms at 989
// TFLOP/s) over ~0.27 GB, so the products bound it. Measured by
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 2.82 ms
// a call through wgmma (4.1x the bound, 1.87x SDPA's backward), 40.61
// ms on the CUDA cores.

#include <cuda.h>          // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kBK = 64;                 // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;     // query rows per warp
constexpr int kMaxD = 128;
static_assert(kBQ == 64 && kBK == 64, "load_tile moves 64-row tiles");
constexpr int kKPad = 4;                // floats of padding per K row
constexpr int kInFlight = 8;            // 16-byte loads per thread
constexpr float kNegInf = -1e30f;       // NEG_INF of the plain version

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Rows [row0, row0 + 64) of a head's (n_rows, d) slice, positions
// `pitch` elements apart, into shared memory as float32 times `scale`
// (dst[r * ld + c]); rows past n_rows are zeros. 16-byte loads (d is a
// multiple of 16 / sizeof(T)), kInFlight per thread issued before any
// is stored.
// NT threads share the copy.
template <typename T, int NT = kThreads>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int row0, int n_rows,
                                          size_t pitch, int d, float scale,
                                          float* dst, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int n_vec = 64 * d / V;
  for (int base = 0; base < n_vec; base += kInFlight * NT) {
    uint4 buf[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e0 = (base + u * NT + (int)threadIdx.x) * V;
      const int r = e0 / d, c = e0 - r * d;
      const int i = row0 + r;
      buf[u] = (e0 < 64 * d && i < n_rows)
                   ? *reinterpret_cast<const uint4*>(src + i * pitch + c)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e0 = (base + u * NT + (int)threadIdx.x) * V;
      if (e0 < 64 * d) {
        const int r = e0 / d, c = e0 - r * d;
        float f[V];
        unpack(buf[u], f, T());
#pragma unroll
        for (int e = 0; e < V; e += 4)
          *reinterpret_cast<float4*>(&dst[r * ld + c + e]) = make_float4(
              f[e] * scale, f[e + 1] * scale, f[e + 2] * scale,
              f[e + 3] * scale);
      }
    }
  }
}

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * ((size_t)kBQ * d + (size_t)kBK * (d + kKPad) +
                          (size_t)kBK * dv + (size_t)kBQ * kBK);
}

// NC = ceil(dv / 32): output columns per lane. d is the head dim of q
// and k, dv that of v and the output.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_q, int n_k, int n_heads,
                 int d, int dv, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = d + kKPad;
  float* sQ = smem;                      // [kBQ][d], scaled
  float* sK = sQ + kBQ * d;              // [kBK][ldk]
  float* sV = sK + kBK * ldk;            // [kBK][dv]
  float* sP = sV + kBK * dv;             // [kBQ][kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;     // this warp's first row
  const size_t pitch = (size_t)n_heads * d;   // between positions
  const size_t pitch_v = (size_t)n_heads * dv;  // of v and o
  const T* qh = q + ((size_t)b * n_q * n_heads + h) * d;
  const T* kh = k + ((size_t)b * n_k * n_heads + h) * d;
  const T* vh = v + ((size_t)b * n_k * n_heads + h) * dv;
  T* oh = o + ((size_t)b * n_q * n_heads + h) * dv;

  load_tile(qh, q0, n_q, pitch, d, scale, sQ, d);

  // keys j < k_end and j >= k_begin can be visible to some row of the
  // block: causal needs j <= i <= q0 + kBQ - 1, the window needs
  // j > i - window >= q0 - window
  int k_begin = 0, k_end = n_k;
  if (causal) k_end = min(n_k, q0 + kBQ);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / kBK;
  const int t_end = (k_end + kBK - 1) / kBK;

  float m_run[kRows], l_run[kRows], acc[kRows][NC];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m_run[rr] = kNegInf;
    l_run[rr] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[rr][c] = 0.0f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();            // sQ written; last tile's sK/sV read
    load_tile(kh, k0, n_k, pitch, d, 1.0f, sK, ldk);
    load_tile(vh, k0, n_k, pitch_v, dv, 1.0f, sV, dv);
    __syncthreads();

    // scores of rows r0.. r0+15 against keys k0+lane, k0+lane+32
    float s[kRows][2];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr][0] = s[rr][1] = 0.0f;
    for (int c = 0; c < d; c += 4) {
      const float4 ka =
          *reinterpret_cast<const float4*>(&sK[lane * ldk + c]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&sK[(lane + 32) * ldk + c]);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sQ[(r0 + rr) * d + c]);
        s[rr][0] = fmaf(qv.x, ka.x, s[rr][0]);
        s[rr][0] = fmaf(qv.y, ka.y, s[rr][0]);
        s[rr][0] = fmaf(qv.z, ka.z, s[rr][0]);
        s[rr][0] = fmaf(qv.w, ka.w, s[rr][0]);
        s[rr][1] = fmaf(qv.x, kb.x, s[rr][1]);
        s[rr][1] = fmaf(qv.y, kb.y, s[rr][1]);
        s[rr][1] = fmaf(qv.z, kb.z, s[rr][1]);
        s[rr][1] = fmaf(qv.w, kb.w, s[rr][1]);
      }
    }

    // mask, online softmax update, P to shared memory
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int i = q0 + r0 + rr;
      float sv[2];
      bool in[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + lane + 32 * e;
        const bool vis =
            (!causal || i >= j) && (window <= 0 || i - j < window);
        in[e] = j < n_k;
        sv[e] = vis ? s[rr][e] : kNegInf;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[rr], mx);
      const float p0 = in[0] ? expf(sv[0] - m_new) : 0.0f;
      const float p1 = in[1] ? expf(sv[1] - m_new) : 0.0f;
      const float alpha = expf(m_run[rr] - m_new);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[rr] = l_run[rr] * alpha + ps;
      m_run[rr] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[rr][c] *= alpha;
      sP[(r0 + rr) * kBK + lane] = p0;
      sP[(r0 + rr) * kBK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P V over the tile's keys
    for (int j = 0; j < kBK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          vv[u][c] = col < dv ? sV[(j + u) * dv + col] : 0.0f;
        }
      }
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&sP[(r0 + rr) * kBK + j]);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[rr][c] = fmaf(pv.x, vv[0][c], acc[rr][c]);
          acc[rr][c] = fmaf(pv.y, vv[1][c], acc[rr][c]);
          acc[rr][c] = fmaf(pv.z, vv[2][c], acc[rr][c]);
          acc[rr][c] = fmaf(pv.w, vv[3][c], acc[rr][c]);
        }
      }
    }
    __syncwarp();               // sP is rewritten by the next tile
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int i = q0 + r0 + rr;
    if (i >= n_q) continue;
    const float denom = fmaxf(l_run[rr], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) store(&oh[i * pitch_v + col], acc[rr][c] / denom);
    }
    // the row's log-sum-exp of its scaled scores, for the backward
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * n_heads + h) * n_q + i] = m_run[rr] + logf(denom);
  }
}

// Let `kernel` take `bytes` of dynamic shared memory and the largest
// carveout; once a kernel, before any launch (and so outside any
// CUDA-graph capture).
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int n_q, int n_k, int n_heads, int d, int dv,
           int causal, int window, float scale, cudaStream_t stream) {
  // opt in once to the largest tile set (d = dv = kMaxD) and the largest
  // shared-memory carveout, before any launch (and so outside any
  // CUDA-graph capture)
  static cudaError_t opted =
      opt_in(flash_fwd_kernel<T, NC>, smem_bytes(kMaxD, kMaxD));
  if (opted != cudaSuccess) return (int)opted;
  const dim3 grid((n_q + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_kernel<T, NC><<<grid, kThreads, smem_bytes(d, dv), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n_q, n_k, n_heads,
      d, dv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int batch, int n_q, int n_k, int n_heads, int d,
             int dv, int causal, int window, float scale, cudaStream_t s) {
  switch ((dv + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, lse, batch, n_q, n_k, n_heads,
                                d, dv, causal, window, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, lse, batch, n_q, n_k, n_heads,
                                d, dv, causal, window, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, lse, batch, n_q, n_k, n_heads,
                                d, dv, causal, window, scale, s);
    default: return launch<T, 4>(q, k, v, o, lse, batch, n_q, n_k, n_heads,
                                 d, dv, causal, window, scale, s);
  }
}

// ---------------------------------------------------------------------
// The tensor-core variant: bfloat16 with d in {64, 128}.

namespace wg {

constexpr int kBQ = 64;                  // query rows per block (wgmma's M)
constexpr int kBK = 64;                  // keys per tile
constexpr int kConsumers = 128;          // one warpgroup runs the math
constexpr int kThreads = kConsumers + 32;   // and one warp issues the copies
constexpr int kStages = 2;               // depth of the K/V ring
constexpr int kAtom = 64 * 128;          // 64 rows of 128 bytes: one swizzle
                                         // atom column of 64 bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A 64-row tile of D bf16 columns in whole swizzle atom columns: a row
// of 96 (MLA's q/k) takes two atoms, its columns 96-127 zero-filled by
// the copy and never multiplied
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kBQ * ((D + 63) / 64) * 64 * 2;
}

// Q of two query tiles, K of each stage, V of each stage, each tile
// 1024-byte aligned; then the barriers (q_full[2], q_empty[2],
// k_full[kStages], v_full[kStages], empty[kStages]); plus the slack that
// aligns the base
template <int DQK, int DV>
__host__ __device__ constexpr int smem_bytes() {
  return (2 + kStages) * tile_bytes<DQK>() + kStages * tile_bytes<DV>() +
         8 * (4 + 3 * kStages) + 1024;
}

// Query tiles a block walks: enough blocks to give every SM two (the
// most that fit), and no more tiles a block than that needs.
constexpr int kSms = 132;
inline int tiles_per_block(int batch, int n_q, int n_heads) {
  const long n_tiles = (n_q + kBQ - 1) / kBQ;
  const long tiles = (long)batch * n_heads * n_tiles;
  const long per = (tiles + 2 * kSms - 1) / (2 * kSms);
  return (int)(per < 1 ? 1 : (per > n_tiles ? n_tiles : per));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a copy that never lands) traps after some
// seconds, so that a fault ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (n == (1u << 26)) __trap();
  }
}

// One TMA box of a rank-4 (d, head, position, batch) map into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
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

// Keep the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(x) : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 x;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
               : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// Byte offset of 16-byte chunk c of row r in a staged output tile with
// rows of `row_bytes`: chunks XOR-swizzled by the row, so that neither a
// warp's 4-byte writes (8 rows, one chunk) nor its 16-byte reads (one
// row, 8 chunks) collide in a bank.
__device__ __forceinline__ uint32_t out_offset(int r, int c, int row_bytes) {
  return r * row_bytes + ((c ^ (r & 7)) << 4);
}

// D (64 x 64, float32) += A (64 x 16) B (16 x 64), A and B bf16 in
// shared memory (descriptors), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16) B (16 x 64): A bf16 in registers
// (the k16 fragment), B bf16 in shared memory, N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16) B (16 x 128): A bf16 in registers
// (the k16 fragment), B bf16 in shared memory, N-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// One TMA copy of rows [row0, row0 + 64) of head h of sequence b from
// `map` into the tile at `dst` (ceil(D / 64) swizzle atom columns; the
// columns of the last box past D lie outside the map and read as zeros).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int h, int row0, int b,
                                         uint32_t bar) {
#pragma unroll
  for (int a = 0; a < (D + 63) / 64; ++a)
    tma_load(dst + a * kAtom, map, 64 * a, h, row0, b, bar);
}

// D (64 x D) += A B over a 64-deep K, A the four k16 register fragments
// `a`, B a 64-row tile in shared memory read N-major (its rows are K).
template <int D>
__device__ __forceinline__ void wgmma_rs_tile(float (&d)[D / 2],
                                              const uint32_t (&a)[4][4],
                                              uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = desc_sw128(b_tile + kk * 16 * 128, kAtom, 1024);
    if constexpr (D == 128)
      wgmma_rs_n128(d, a[kk], desc);
    else
      wgmma_rs_n64(d, a[kk], desc);
  }
}

// D (64 x 64) = A B^T over K = D, A and B 64-row tiles in shared memory
// (both K-major: their rows are M and N); D a multiple of 16, so that a
// 96-wide tile takes four k-steps in its first atom and two in its
// second.
template <int D>
__device__ __forceinline__ void wgmma_ss_tile(float (&d)[32], uint32_t a_tile,
                                              uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
    wgmma_ss_n64(d, desc_sw128(a_tile + off, 16, 1024),
                 desc_sw128(b_tile + off, 16, 1024), kk > 0);
  }
}

// A block walks query tiles [first, first + count) of one (head,
// batch) pair: warps 0-3 form the consumer warpgroup, warp 4 the
// producer. The producer keeps a two-deep Q ring and a kStages-deep K/V
// ring filled across the block's query tiles, so the next tile's copies
// overlap this tile's math and output. Q and K have DQK columns, V and
// the output DV.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int n_q, int n_k, int n_heads, int causal, int window,
                   float scale_log2, int per_block) {
  static_assert(DQK % 16 == 0 && DQK <= 128 && (DV == 64 || DV == 128),
                "wgmma tiles: q/k a multiple of 16 up to 128, v 64 or 128");
  static_assert(tile_bytes<DV>() <= tile_bytes<DQK>(),
                "the output is staged in the Q tile");
  constexpr int kTile = tile_bytes<DQK>();   // a Q or K tile
  constexpr int kTileV = tile_bytes<DV>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_base = base + (2 + kStages) * kTile;
  const uint32_t bars = v_base + kStages * kTileV;
  auto s_q = [&](int s) { return base + s * kTile; };
  auto s_k = [&](int s) { return base + (2 + s) * kTile; };
  auto s_v = [&](int s) { return v_base + s * kTileV; };
  auto q_full = [&](int s) { return bars + 8 * s; };
  auto q_empty = [&](int s) { return bars + 8 * (2 + s); };
  auto k_full = [&](int s) { return bars + 8 * (4 + s); };
  auto v_full = [&](int s) { return bars + 8 * (4 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (4 + 2 * kStages + s); };

  // the last query tiles see the most keys under a causal mask: the
  // grid starts with them, so that the light ones fill its tail
  const int n_tiles = (n_q + kBQ - 1) / kBQ;
  const int first = (gridDim.x - 1 - blockIdx.x) * per_block;
  const int count = min(per_block, n_tiles - first);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  // key tiles some row of query tile qt can see (as the CUDA-core
  // kernel): causal needs j <= i <= q0 + kBQ - 1, the window
  // j > i - window >= q0 - window
  auto key_tiles = [&](int qt, int& t_begin, int& t_end) {
    const int q0 = qt * kBQ;
    int k_begin = 0, k_end = n_k;
    if (causal) k_end = min(n_k, q0 + kBQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
    t_begin = k_begin / kBK;
    t_end = (k_end + kBK - 1) / kBK;
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full(s), 1);
      mbar_init(q_empty(s), kConsumers);
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer: one thread keeps both rings filled
    if (tid == kConsumers) {
      int n = 0;                         // K/V tiles issued so far
      for (int qi = 0; qi < count; ++qi) {
        const int qt = first + qi;
        const int qs = qi & 1;
        if (qi >= 2) mbar_wait(q_empty(qs), ((qi >> 1) - 1) & 1);
        mbar_expect_tx(q_full(qs), kTile);
        tma_tile<DQK>(s_q(qs), &tq, h, qt * kBQ, b, q_full(qs));
        int t_begin, t_end;
        key_tiles(qt, t_begin, t_end);
        for (int t = t_begin; t < t_end; ++t, ++n) {
          const int s = n % kStages;
          const int u = n / kStages;     // earlier fills of stage s
          if (u > 0) mbar_wait(empty(s), (u - 1) & 1);
          // K and V on barriers of their own: S = Q K^T starts while
          // V is still on its way
          mbar_expect_tx(k_full(s), kTile);
          tma_tile<DQK>(s_k(s), &tk, h, t * kBK, b, k_full(s));
          mbar_expect_tx(v_full(s), kTileV);
          tma_tile<DV>(s_v(s), &tv, h, t * kBK, b, v_full(s));
        }
      }
    }
    return;
  }

  // consumer warpgroup: thread `lane` of warp w holds rows
  // 16 w + lane / 4 (+ 8) at columns 8 j + 2 (lane % 4) + {0, 1}
  const int warp = tid >> 5, lane = tid & 31;
  const int col_in = 2 * (lane & 3);
  int n = 0;                             // K/V tiles consumed so far
  for (int qi = 0; qi < count; ++qi) {
    const int qt = first + qi;
    const int qs = qi & 1;
    const int row_top = qt * kBQ + 16 * warp + (lane >> 2);
    int t_begin, t_end;
    key_tiles(qt, t_begin, t_end);
    float oacc[DV / 2];
#pragma unroll
    for (int e = 0; e < DV / 2; ++e) oacc[e] = 0.0f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.0f, 0.0f};     // this thread's columns only
    mbar_wait(q_full(qs), (qi >> 1) & 1);

    for (int t = t_begin; t < t_end; ++t, ++n) {
      const int s = n % kStages;
      mbar_wait(k_full(s), (n / kStages) & 1);
      __syncwarp();                    // converged for the .aligned wgmma

      // S = Q K^T: 64 x 64, float32, DQK / 16 k-steps
      float sacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sacc[e] = 0.0f;
      fence_regs(sacc);
      wgmma_fence();
      wgmma_ss_tile<DQK>(sacc, s_q(qs), s_k(s));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // masks and online softmax, in the log2 domain; the per-element
      // masks only on tiles some mask reaches
      const int k0 = t * kBK;
      const int q0 = qt * kBQ;
      const bool masked = (causal && k0 + kBK - 1 > q0) ||
                          (window > 0 && q0 + kBQ - 1 - k0 >= window) ||
                          k0 + kBK > n_k;
      float mx[2] = {kNegInf, kNegInf};
      float alpha[2], ps[2] = {0.0f, 0.0f};
      if (masked) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int row = row_top + 8 * hh;
              const int col = k0 + 8 * jj + col_in + e;
              const bool vis = (!causal || row >= col) &&
                               (window <= 0 || row - col < window);
              float& x = sacc[4 * jj + 2 * hh + e];
              x = vis ? x * scale_log2 : kNegInf;
              mx[hh] = fmaxf(mx[hh], x);
            }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float m_new = fmaxf(m_run[hh], mx[hh]);
          alpha[hh] = exp2f(m_run[hh] - m_new);
          m_run[hh] = m_new;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = k0 + 8 * jj + col_in + e;
              float& x = sacc[4 * jj + 2 * hh + e];
              x = col < n_k ? exp2f(x - m_run[hh]) : 0.0f;  // no weight
              ps[hh] += x;                                 // past S
            }
      } else {
        // every key visible to every row: the raw maximum, scaled after
        // (the scale is positive), and one FMA an element
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            mx[hh] = fmaxf(mx[hh], fmaxf(sacc[4 * jj + 2 * hh],
                                         sacc[4 * jj + 2 * hh + 1]));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          const float m_new = fmaxf(m_run[hh], mx[hh] * scale_log2);
          alpha[hh] = exp2f(m_run[hh] - m_new);
          m_run[hh] = m_new;
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sacc[4 * jj + 2 * hh + e];
              x = exp2f(__fmaf_rn(x, scale_log2, -m_run[hh]));
              ps[hh] += x;
            }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l_run[hh] = l_run[hh] * alpha[hh] + ps[hh];
#pragma unroll
      for (int jn = 0; jn < DV / 8; ++jn) {
        oacc[4 * jn + 0] *= alpha[0];
        oacc[4 * jn + 1] *= alpha[0];
        oacc[4 * jn + 2] *= alpha[1];
        oacc[4 * jn + 3] *= alpha[1];
      }

      // O += P V: P in bf16 as the register A fragment (two adjacent n8
      // chunks of the accumulator are one k16 fragment), V (keys x DV,
      // DV contiguous) as the transposed B from shared memory
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      mbar_wait(v_full(s), (n / kStages) & 1);
      __syncwarp();
      fence_regs(oacc);
      wgmma_fence();
      wgmma_rs_tile<DV>(oacc, pa, s_v(s));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
      mbar_arrive(empty(s));           // this thread is done with stage s
    }
    // O / l, rounded to bf16 and staged in this tile's Q buffer (its
    // last reader, S = Q K^T, is done), then written out as 16-byte
    // stores, a row's 16 chunks by 16 neighbouring threads
    const uint32_t stage_out = s_q(qs);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_run[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.0f / fmaxf(l, 1e-30f);
      const int r = 16 * warp + (lane >> 2) + 8 * hh;
      // the row's log-sum-exp of its scaled scores (m_run is in log2
      // units), for the backward
      if (lse != nullptr && (lane & 3) == 0 && qt * kBQ + r < n_q)
        lse[((size_t)b * n_heads + h) * n_q + qt * kBQ + r] =
            (m_run[hh] + log2f(fmaxf(l, 1e-30f))) * kLn2;
#pragma unroll
      for (int jn = 0; jn < DV / 8; ++jn)
        st_shared(stage_out + out_offset(r, jn, 2 * DV) + 2 * col_in,
                  pack_bf16(oacc[4 * jn + 2 * hh] * inv,
                            oacc[4 * jn + 2 * hh + 1] * inv));
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    constexpr int kChunks = DV / 8;        // 16-byte chunks of a row
#pragma unroll
    for (int e = tid; e < kBQ * kChunks; e += kConsumers) {
      const int r = e / kChunks, c = e % kChunks;
      const int row = qt * kBQ + r;
      const uint4 x = ld_shared16(stage_out + out_offset(r, c, 2 * DV));
      if (row < n_q)
        *reinterpret_cast<uint4*>(
            o + ((size_t)(b * n_q + row) * n_heads + h) * DV + 8 * c) = x;
    }
    // the buffer goes back to the producer's copies (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(q_empty(qs));          // this query tile is done
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// that the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A rank-4 map over a contiguous (batch, n, heads, d) bf16 tensor,
// innermost first: (d, head, position, batch), boxes of 64 d-columns
// x 1 head x 64 positions x 1 sequence, 128-byte swizzle. Positions
// past n, and columns past d (the second box of a 96-wide row), read as
// zeros, never the next sequence's rows or the next head's columns.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int n,
                     int heads, int d) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t rows = n > 0 ? n : 1;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 rows * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DQK, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int n_q, int n_k, int n_heads, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<DQK, DV>();
  static cudaError_t opted = opt_in(flash_wgmma_kernel<DQK, DV>, kSmem);
  if (opted != cudaSuccess) return (int)opted;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, batch, n_q, n_heads, DQK);
  if (err == cudaSuccess) err = make_map(&tk, k, batch, n_k, n_heads, DQK);
  if (err == cudaSuccess) err = make_map(&tv, v, batch, n_k, n_heads, DV);
  if (err != cudaSuccess) return (int)err;
  const int per = tiles_per_block(batch, n_q, n_heads);
  const int n_tiles = (n_q + kBQ - 1) / kBQ;
  const dim3 grid((n_tiles + per - 1) / per, n_heads, batch);
  flash_wgmma_kernel<DQK, DV><<<grid, kThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, n_q, n_k, n_heads,
      causal, window, scale * kLog2e, per);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------
// The backward (training): float32 products and sums on the CUDA cores,
// every dtype and head dims the CUDA-core forward takes. Given the
// forward's output O and the log-sum-exp L of each row's scaled scores,
// with P_ij = exp(scale q_i . k_j - L_i) on visible pairs (0 elsewhere):
//     D_i   = dO_i . O_i                      (flash_bwd_delta_kernel)
//     dS_ij = P_ij (dO_i . v_j - D_i)
//     dV_j  = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i
//                                               (flash_bwd_dkdv_kernel)
//     dQ_i  = scale sum_j dS_ij k_j            (flash_bwd_dq_kernel)
// A dK/dV block owns a 64-key tile and walks the query tiles that can
// see it; a dQ block owns a 64-query tile and walks its key tiles (the
// forward's); each recomputes the scores it needs, so no block adds
// into another's output and the sums run in one fixed order: no
// atomics, the same bits every run. The tiles are staged as float32
// in shared memory (rows padded by 4 floats: the 16-byte reads of 8
// neighbouring rows hit distinct banks); a thread computes a 4 x 4
// block of S and dP, then 8 rows x NC columns of its outputs.
namespace bwd {

constexpr int kB = 64;                  // rows of a query or key tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 4;
constexpr int kLdP = kB + 4;            // P and dS rows
// output columns a lane owns: every head dim up to 128 (one
// instantiation a dtype keeps the build short; narrower heads leave
// columns idle)
constexpr int NC = 4;

// K [kB][d + kPad], V [kB][dv + kPad], Q [kB][d + kPad], dO
// [kB][dv + kPad], P and dS [kB][kLdP], L and D [kB]
inline size_t smem_bytes(int d, int dv) {
  return sizeof(float) * (2 * (size_t)kB * (d + kPad) +
                          2 * (size_t)kB * (dv + kPad) +
                          2 * (size_t)kB * kLdP + 2 * kB);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ bool visible(int i, int j, int n_q, int n_k,
                                        int causal, int window) {
  return i < n_q && j < n_k && (!causal || i >= j) &&
         (window <= 0 || i - j < window);
}

// D_i = dO_i . O_i for every (batch, position, head) row, one warp a
// row, written as (batch, head, position).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int n_rows, int n_q,
                       int n_heads, int dv) {
  const int row = (int)((blockIdx.x * (size_t)kThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const T* orow = o + (size_t)row * dv;
  const T* drow = dout + (size_t)row * dv;
  float s = 0.0f;
  for (int c = lane; c < dv; c += 32)
    s = fmaf(to_f32(orow[c]), to_f32(drow[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = row % n_heads;
    const int t = (row / n_heads) % n_q;
    const int b = row / (n_heads * n_q);
    delta[((size_t)b * n_heads + h) * n_q + t] = s;
  }
}

// S (scores) and dP = dO V^T of rows ty + 16 a against keys tx + 16 b of
// the staged tiles.
__device__ __forceinline__ void scores(const float* sQ, const float* sK,
                                       const float* sO, const float* sV,
                                       int d, int dv, int ty, int tx,
                                       float (&s)[4][4], float (&dp)[4][4]) {
  const int ldq = d + kPad, ldv = dv + kPad;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.0f;
  for (int c = 0; c < d; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(&sQ[(ty + 16 * a) * ldq + c]);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      y[b] = *reinterpret_cast<const float4*>(&sK[(tx + 16 * b) * ldq + c]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(x[a].x, y[b].x, s[a][b]);
        s[a][b] = fmaf(x[a].y, y[b].y, s[a][b]);
        s[a][b] = fmaf(x[a].z, y[b].z, s[a][b]);
        s[a][b] = fmaf(x[a].w, y[b].w, s[a][b]);
      }
  }
  for (int c = 0; c < dv; c += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      x[a] = *reinterpret_cast<const float4*>(&sO[(ty + 16 * a) * ldv + c]);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      y[b] = *reinterpret_cast<const float4*>(&sV[(tx + 16 * b) * ldv + c]);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        dp[a][b] = fmaf(x[a].x, y[b].x, dp[a][b]);
        dp[a][b] = fmaf(x[a].y, y[b].y, dp[a][b]);
        dp[a][b] = fmaf(x[a].z, y[b].z, dp[a][b]);
        dp[a][b] = fmaf(x[a].w, y[b].w, dp[a][b]);
      }
  }
}

// P and dS of the tile pair (query rows q0.., keys k0..) into sP / sS
// (either may be null), [query row][key].
__device__ __forceinline__ void probs(const float (&s)[4][4],
                                      const float (&dp)[4][4],
                                      const float* sL, const float* sD,
                                      int q0, int k0, int n_q, int n_k,
                                      int causal, int window, float scale,
                                      int ty, int tx, float* sP, float* sS) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int il = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int jl = tx + 16 * b;
      const float p =
          visible(q0 + il, k0 + jl, n_q, n_k, causal, window)
              ? expf(__fmul_rn(s[a][b], scale) - sL[il])
              : 0.0f;
      if (sP != nullptr) sP[il * kLdP + jl] = p;
      sS[il * kLdP + jl] = p * (dp[a][b] - sD[il]);
    }
  }
}

// Rows i0.. i0 + kB - 1 of a (n,) float32 vector, zeros past n.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int i0, int n, float* dst) {
  if (threadIdx.x < kB) {
    const int i = i0 + (int)threadIdx.x;
    dst[threadIdx.x] = i < n ? src[i] : 0.0f;
  }
}

// One block per (64-key tile, head, batch): dK and dV of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv_out, int n_q, int n_k, int n_heads,
                      int d, int dv, int causal, int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = d + kPad, ldv = dv + kPad;
  float* sK = smem;
  float* sV = sK + kB * ldq;
  float* sQ = sV + kB * ldv;
  float* sO = sQ + kB * ldq;
  float* sP = sO + kB * ldv;
  float* sS = sP + kB * kLdP;
  float* sL = sS + kB * kLdP;
  float* sD = sL + kB;

  const int k0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t pitch = (size_t)n_heads * d, pitch_v = (size_t)n_heads * dv;
  const T* qh = q + ((size_t)b * n_q * n_heads + h) * d;
  const T* kh = k + ((size_t)b * n_k * n_heads + h) * d;
  const T* vh = v + ((size_t)b * n_k * n_heads + h) * dv;
  const T* oh = dout + ((size_t)b * n_q * n_heads + h) * dv;
  const float* lh = lse + ((size_t)b * n_heads + h) * n_q;
  const float* dh = delta + ((size_t)b * n_heads + h) * n_q;

  load_tile<T, kThreads>(kh, k0, n_k, pitch, d, 1.0f, sK, ldq);
  load_tile<T, kThreads>(vh, k0, n_k, pitch_v, dv, 1.0f, sV, ldv);

  // query rows that can see a key of the tile: causal needs
  // i >= j >= k0, the window i < j + window <= k0 + kB - 1 + window
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(n_q, k0 + kB - 1 + window) : n_q;
  const int t_begin = i_begin / kB;
  const int t_end = (i_end + kB - 1) / kB;

  const int ty = tid >> 4, tx = tid & 15;      // S / dP: 4 x 4 a thread
  const int wy = tid >> 5, lane = tid & 31;    // dK / dV: 8 rows x NC
  float acc_k[8][NC], acc_v[8][NC];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = t * kB;
    __syncthreads();            // the last tile's Q, dO, P, dS are read
    load_tile<T, kThreads>(qh, q0, n_q, pitch, d, 1.0f, sQ, ldq);
    load_tile<T, kThreads>(oh, q0, n_q, pitch_v, dv, 1.0f, sO, ldv);
    load_rows(lh, q0, n_q, sL);
    load_rows(dh, q0, n_q, sD);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores(sQ, sK, sO, sV, d, dv, ty, tx, s, dp);
    probs(s, dp, sL, sD, q0, k0, n_q, n_k, causal, window, scale, ty, tx,
          sP, sS);
    __syncthreads();
    for (int i = 0; i < kB; ++i) {
      float p[8], ds[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        p[a] = sP[i * kLdP + wy + 8 * a];
        ds[a] = sS[i * kLdP + wy + 8 * a];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        const float go = col < dv ? sO[i * ldv + col] : 0.0f;
        const float qq = col < d ? sQ[i * ldq + col] : 0.0f;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          acc_v[a][c] = fmaf(p[a], go, acc_v[a][c]);
          acc_k[a][c] = fmaf(ds[a], qq, acc_k[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int j = k0 + wy + 8 * a;
    if (j >= n_k) continue;
    const size_t row = ((size_t)b * n_k + j) * n_heads + h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(&dk[row * d + col], __fmul_rn(acc_k[a][c], scale));
      if (col < dv) store(&dv_out[row * dv + col], acc_v[a][c]);
    }
  }
}

// One block per (64-query tile, head, batch): dQ of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_q, int n_k, int n_heads, int d, int dv, int causal,
                    int window, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldq = d + kPad, ldv = dv + kPad;
  float* sK = smem;
  float* sV = sK + kB * ldq;
  float* sQ = sV + kB * ldv;
  float* sO = sQ + kB * ldq;
  float* sS = sO + kB * ldv + kB * kLdP;       // (the P buffer is unused)
  float* sL = sS + kB * kLdP;
  float* sD = sL + kB;

  const int q0 = blockIdx.x * kB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t pitch = (size_t)n_heads * d, pitch_v = (size_t)n_heads * dv;
  const T* qh = q + ((size_t)b * n_q * n_heads + h) * d;
  const T* kh = k + ((size_t)b * n_k * n_heads + h) * d;
  const T* vh = v + ((size_t)b * n_k * n_heads + h) * dv;
  const T* oh = dout + ((size_t)b * n_q * n_heads + h) * dv;
  const float* lh = lse + ((size_t)b * n_heads + h) * n_q;
  const float* dh = delta + ((size_t)b * n_heads + h) * n_q;

  load_tile<T, kThreads>(qh, q0, n_q, pitch, d, 1.0f, sQ, ldq);
  load_tile<T, kThreads>(oh, q0, n_q, pitch_v, dv, 1.0f, sO, ldv);
  load_rows(lh, q0, n_q, sL);
  load_rows(dh, q0, n_q, sD);

  // the forward's key tiles of this query tile
  int k_begin = 0, k_end = n_k;
  if (causal) k_end = min(n_k, q0 + kB);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / kB;
  const int t_end = (k_end + kB - 1) / kB;

  const int ty = tid >> 4, tx = tid & 15;
  const int wy = tid >> 5, lane = tid & 31;
  float acc[8][NC];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();            // Q, dO staged; the last K, V, dS read
    load_tile<T, kThreads>(kh, k0, n_k, pitch, d, 1.0f, sK, ldq);
    load_tile<T, kThreads>(vh, k0, n_k, pitch_v, dv, 1.0f, sV, ldv);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores(sQ, sK, sO, sV, d, dv, ty, tx, s, dp);
    probs(s, dp, sL, sD, q0, k0, n_q, n_k, causal, window, scale, ty, tx,
          nullptr, sS);
    __syncthreads();
    for (int j = 0; j < kB; ++j) {
      float ds[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) ds[a] = sS[(wy + 8 * a) * kLdP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        const float kk = col < d ? sK[j * ldq + col] : 0.0f;
#pragma unroll
        for (int a = 0; a < 8; ++a) acc[a][c] = fmaf(ds[a], kk, acc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = q0 + wy + 8 * a;
    if (i >= n_q) continue;
    const size_t row = ((size_t)b * n_q + i) * n_heads + h;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(&dq[row * d + col], __fmul_rn(acc[a][c], scale));
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv_out, int batch, int n_q, int n_k, int n_heads,
           int d, int dv, int causal, int window, float scale,
           cudaStream_t stream) {
  static cudaError_t opted_kv =
      opt_in(flash_bwd_dkdv_kernel<T>, smem_bytes(kMaxD, kMaxD));
  static cudaError_t opted_q =
      opt_in(flash_bwd_dq_kernel<T>, smem_bytes(kMaxD, kMaxD));
  if (opted_kv != cudaSuccess) return (int)opted_kv;
  if (opted_q != cudaSuccess) return (int)opted_q;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const int n_rows = batch * n_q * n_heads;
  flash_bwd_delta_kernel<T><<<(n_rows + kWarps - 1) / kWarps, kThreads, 0,
                              stream>>>(static_cast<const T*>(o), tdo, delta,
                                        n_rows, n_q, n_heads, dv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(d, dv);
  if (n_k > 0) {
    const dim3 grid_kv((n_k + kB - 1) / kB, n_heads, batch);
    flash_bwd_dkdv_kernel<T><<<grid_kv, kThreads, smem, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv_out), n_q, n_k, n_heads, d, dv, causal, window,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid_q((n_q + kB - 1) / kB, n_heads, batch);
  flash_bwd_dq_kernel<T><<<grid_q, kThreads, smem, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), n_q, n_k, n_heads, d,
      dv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------
// The tensor-core backward: bfloat16 with d = dv in {64, 128}, the
// inputs the wgmma forward takes. The same three launches and the same
// split as namespace bwd (D pass, then a dK/dV kernel a key tile and a
// dQ kernel a query tile, one writer an output), with every product on
// wgmma (bf16 operands, float32 sums) and the tiles brought in by TMA.
namespace wgb {

using wg::kLog2e;
constexpr int kB = 64;                    // rows of a query or key tile
constexpr int kConsumers = 128;           // one warpgroup runs the math
constexpr int kThreads = kConsumers + 32; // and one warp feeds it
constexpr int kRowBytes = 2 * kB * 4;     // a tile's L and D rows (float32)

// The fixed pair of tiles (dK/dV: K, V; dQ: Q, dO), the two-stage ring
// of pairs (dK/dV: Q, dO; dQ: K, V), each tile 1024-byte aligned; the L
// and D rows of the ring's stages (dK/dV) or of the fixed tile (dQ);
// the barriers fixed_full, full[2], empty[2]; the slack that aligns the
// base.
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 6 * wg::tile_bytes<D>() + 2 * kRowBytes + 8 * 5 + 1024;
}

// Rows [row0, row0 + kB) of a (batch, head)'s L (times log2 e) and D
// into shared memory, zeros past n; the producer warp's 32 lanes, two
// rows each.
__device__ __forceinline__ void load_rows(const float* __restrict__ lh,
                                          const float* __restrict__ dh,
                                          int row0, int n, float* dst,
                                          int lane) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int r = lane + 32 * u, i = row0 + r;
    dst[r] = i < n ? lh[i] * kLog2e : 0.0f;
    dst[kB + r] = i < n ? dh[i] : 0.0f;
  }
}

// A tile pair that the causal or window mask, or the end of T or S,
// reaches: only these take the per-element masks.
__device__ __forceinline__ bool edge(int q0, int k0, int n_q, int n_k,
                                     int causal, int window) {
  return (causal && k0 + kB - 1 > q0) ||
         (window > 0 && q0 + kB - 1 - k0 >= window) || k0 + kB > n_k ||
         q0 + kB > n_q;
}

// The block's (tile, head, batch) from a 1-D grid whose slowest index
// is the tile: `reverse` starts with the last tile.
__device__ __forceinline__ void block_coords(int n_heads, int batch,
                                             int n_tiles, bool reverse,
                                             int& tile, int& h, int& b) {
  const int bh = (int)(blockIdx.x % (unsigned)(n_heads * batch));
  const int t = (int)(blockIdx.x / (unsigned)(n_heads * batch));
  tile = reverse ? n_tiles - 1 - t : t;
  h = bh % n_heads;
  b = bh / n_heads;
}

// The output tile of 64 rows x D (float32 accumulator fragments `acc`
// times `scale`) rounded to bf16 and staged at `stage` (swizzled
// chunks, as the forward's epilogue), for store_rows.
template <int D>
__device__ __forceinline__ void stage_rows(const float (&acc)[D / 2],
                                           float scale, uint32_t stage,
                                           int warp, int lane) {
  const int col_in = 2 * (lane & 3);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + (lane >> 2) + 8 * hh;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      wg::st_shared(stage + wg::out_offset(r, jn, 2 * D) + 2 * col_in,
                    wg::pack_bf16(acc[4 * jn + 2 * hh] * scale,
                                  acc[4 * jn + 2 * hh + 1] * scale));
  }
}

// The staged tile's rows row0.. (those below n) to a (batch, n, heads,
// D) tensor with 16-byte stores, a row's chunks by neighbouring threads.
template <int D>
__device__ __forceinline__ void store_rows(uint32_t stage,
                                           __nv_bfloat16* __restrict__ out,
                                           int row0, int n, int n_heads,
                                           int h, int b, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int e = tid; e < kB * kChunks; e += kConsumers) {
    const int r = e / kChunks, c = e % kChunks;
    const int row = row0 + r;
    const uint4 x = wg::ld_shared16(stage + wg::out_offset(r, c, 2 * D));
    if (row < n)
      *reinterpret_cast<uint4*>(
          out + ((size_t)(b * n + row) * n_heads + h) * D + 8 * c) = x;
  }
}

// Accumulator element x (x = 4 jj + 2 hh + e) of a 64 x 64 fragment:
// row 16 warp + lane / 4 + 8 hh, column 8 jj + 2 (lane % 4) + e. Its
// k16 A fragment: register r of chunk kk holds elements 8 kk + 2 r
// and + 1.
__device__ __forceinline__ int frag_row(int x, int warp, int lane) {
  return 16 * warp + (lane >> 2) + 8 * ((x >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int x, int lane) {
  return 8 * (x >> 2) + 2 * (lane & 3) + (x & 1);
}

// One block per (64-key tile, head, batch): dK and dV of the tile.
// Warps 0-3 are the consumer warpgroup (the tile's 64 keys are wgmma's
// M), warp 4 the producer: K and V once, then Q, dO and the rows' L
// and D of each query tile that sees the key tile through a two-stage
// ring. A query tile: S^T = K Q^T, P^T = exp2(S^T scale log2 e -
// L[col]) in bf16, dV += P^T dO and dP^T = V dO^T in one wgmma group,
// dS^T = P^T (dP^T - D[col]), dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_wgmma_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int batch,
                            int n_q, int n_k, int n_heads, int causal,
                            int window, float scale, float scale_log2) {
  constexpr int kTile = wg::tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * kTile);
  const uint32_t bars = base + 6 * kTile + 2 * kRowBytes;
  const uint32_t s_k = base, s_v = base + kTile;
  auto s_q = [&](int s) { return base + (2 + 2 * s) * kTile; };
  auto s_do = [&](int s) { return base + (3 + 2 * s) * kTile; };
  const uint32_t fixed_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (3 + s); };

  // key tile 0 sees the most query tiles under a causal mask: the grid
  // starts with the first key tiles
  int kt, h, b;
  block_coords(n_heads, batch, (n_k + kB - 1) / kB, false, kt, h, b);
  const int k0 = kt * kB;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // query rows that can see a key of the tile: causal needs
  // i >= j >= k0, the window i < j + window <= k0 + kB - 1 + window
  const int i_begin = causal ? k0 : 0;
  const int i_end = window > 0 ? min(n_q, k0 + kB - 1 + window) : n_q;
  const int t_begin = i_begin / kB;
  const int t_end = (i_end + kB - 1) / kB;

  if (tid == 0) {
    wg::mbar_init(fixed_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      wg::mbar_init(full(s), 1 + 32);   // the copies' arrival + 32 lanes
      wg::mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: lane 0 issues the copies, every lane brings two rows of
    // L and D and arrives
    const size_t bh = (size_t)b * n_heads + h;
    if (lane == 0) {
      wg::mbar_expect_tx(fixed_full, 2 * kTile);
      wg::tma_tile<D>(s_k, &tk, h, k0, b, fixed_full);
      wg::tma_tile<D>(s_v, &tv, h, k0, b, fixed_full);
    }
    for (int t = t_begin, n = 0; t < t_end; ++t, ++n) {
      const int s = n & 1;
      if (n >= 2) wg::mbar_wait(empty(s), ((n >> 1) - 1) & 1);
      if (lane == 0) {
        wg::mbar_expect_tx(full(s), 2 * kTile);
        wg::tma_tile<D>(s_q(s), &tq, h, t * kB, b, full(s));
        wg::tma_tile<D>(s_do(s), &tdo, h, t * kB, b, full(s));
      }
      load_rows(lse + bh * n_q, delta + bh * n_q, t * kB, n_q,
                rows + s * 2 * kB, lane);
      wg::mbar_arrive(full(s));
    }
    return;
  }

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.0f;
  wg::mbar_wait(fixed_full, 0);
  for (int t = t_begin, n = 0; t < t_end; ++t, ++n) {
    const int s = n & 1;
    const int q0 = t * kB;
    wg::mbar_wait(full(s), (n >> 1) & 1);
    __syncwarp();                       // converged for the .aligned wgmma

    // S^T = K Q^T (keys x queries)
    float sacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = 0.0f;
    wg::fence_regs(sacc);
    wg::wgmma_fence();
    wg::wgmma_ss_tile<D>(sacc, s_k, s_q(s));
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(sacc);

    // P^T, rounded to bf16 as the A fragment of dV += P^T dO; the masks
    // only on the tiles an edge reaches
    const float* L = rows + s * 2 * kB;
    const float* Dl = L + kB;
    const bool masked = edge(q0, k0, n_q, n_k, causal, window);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      float p = exp2f(__fmaf_rn(sacc[x], scale_log2, -L[frag_col(x, lane)]));
      if (masked) {
        const int j = k0 + frag_row(x, warp, lane);
        const int i = q0 + frag_col(x, lane);
        const bool vis = i < n_q && j < n_k && (!causal || i >= j) &&
                         (window <= 0 || i - j < window);
        p = vis ? p : 0.0f;
      }
      sacc[x] = p;
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = wg::pack_bf16(sacc[8 * kk + 2 * r],
                                  sacc[8 * kk + 2 * r + 1]);

    // dV += P^T dO (dO read N-major) and dP^T = V dO^T: one group
    float dpacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dpacc[e] = 0.0f;
    wg::fence_regs(dpacc);
    wg::fence_regs(dv_acc);
    wg::wgmma_fence();
    wg::wgmma_rs_tile<D>(dv_acc, pa, s_do(s));
    wg::wgmma_ss_tile<D>(dpacc, s_v, s_do(s));
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(dv_acc);
    wg::fence_regs(dpacc);

    // dS^T = P^T (dP^T - D[col]) from the bf16 P^T (its float32 copy is
    // not kept across the group: registers), rounded to bf16
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int x = 8 * kk + 2 * r;
        const float2 p = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&pa[kk][r]));
        const float2 dd =
            *reinterpret_cast<const float2*>(&Dl[frag_col(x, lane)]);
        da[kk][r] = wg::pack_bf16(p.x * (dpacc[x] - dd.x),
                                  p.y * (dpacc[x + 1] - dd.y));
      }

    // dK += dS^T Q (Q read N-major)
    wg::fence_regs(dk_acc);
    wg::wgmma_fence();
    wg::wgmma_rs_tile<D>(dk_acc, da, s_q(s));
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(dk_acc);
    wg::mbar_arrive(empty(s));          // this thread is done with stage s
  }

  // dK scale and dV in bf16, staged in the K and V tiles (their last
  // readers, the wgmmas, are done), then 16-byte stores
  stage_rows<D>(dk_acc, scale, s_k, warp, lane);
  stage_rows<D>(dv_acc, 1.0f, s_v, warp, lane);
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  store_rows<D>(s_k, dk, k0, n_k, n_heads, h, b, tid);
  store_rows<D>(s_v, dv, k0, n_k, n_heads, h, b, tid);
}

// One block per (64-query tile, head, batch): dQ of the tile. The
// producer brings Q, dO and the rows' L and D once, then K and V of
// each key tile the query tile sees through a two-stage ring. A key
// tile: S = Q K^T and dP = dO V^T in one wgmma group, P = exp2(S scale
// log2 e - L[row]) and dS = P (dP - D[row]) in float32, dS rounded to
// bf16, dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int batch,
                          int n_q, int n_k, int n_heads, int causal,
                          int window, float scale, float scale_log2) {
  constexpr int kTile = wg::tile_bytes<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = wg::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + 6 * kTile);
  const uint32_t bars = base + 6 * kTile + 2 * kRowBytes;
  const uint32_t s_q = base, s_do = base + kTile;
  auto s_k = [&](int s) { return base + (2 + 2 * s) * kTile; };
  auto s_v = [&](int s) { return base + (3 + 2 * s) * kTile; };
  const uint32_t fixed_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (3 + s); };

  // the last query tiles see the most key tiles under a causal mask:
  // the grid starts with them
  int qt, h, b;
  block_coords(n_heads, batch, (n_q + kB - 1) / kB, true, qt, h, b);
  const int q0 = qt * kB;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // the forward's key tiles of this query tile
  int k_begin = 0, k_end = n_k;
  if (causal) k_end = min(n_k, q0 + kB);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int t_begin = k_begin / kB;
  const int t_end = (k_end + kB - 1) / kB;

  if (tid == 0) {
    wg::mbar_init(fixed_full, 1 + 32);  // the copies' arrival + 32 lanes
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    const size_t bh = (size_t)b * n_heads + h;
    if (lane == 0) {
      wg::mbar_expect_tx(fixed_full, 2 * kTile);
      wg::tma_tile<D>(s_q, &tq, h, q0, b, fixed_full);
      wg::tma_tile<D>(s_do, &tdo, h, q0, b, fixed_full);
    }
    load_rows(lse + bh * n_q, delta + bh * n_q, q0, n_q, rows, lane);
    wg::mbar_arrive(fixed_full);
    if (lane == 0) {
      for (int t = t_begin, n = 0; t < t_end; ++t, ++n) {
        const int s = n & 1;
        if (n >= 2) wg::mbar_wait(empty(s), ((n >> 1) - 1) & 1);
        wg::mbar_expect_tx(full(s), 2 * kTile);
        wg::tma_tile<D>(s_k(s), &tk, h, t * kB, b, full(s));
        wg::tma_tile<D>(s_v(s), &tv, h, t * kB, b, full(s));
      }
    }
    return;
  }

  float dq_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq_acc[e] = 0.0f;
  wg::mbar_wait(fixed_full, 0);
  // this thread's two rows' L (times log2 e) and D
  float l2[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = 16 * warp + (lane >> 2) + 8 * hh;
    l2[hh] = rows[r];
    dd[hh] = rows[kB + r];
  }
  for (int t = t_begin, n = 0; t < t_end; ++t, ++n) {
    const int s = n & 1;
    const int k0 = t * kB;
    wg::mbar_wait(full(s), (n >> 1) & 1);
    __syncwarp();

    // S = Q K^T and dP = dO V^T (queries x keys)
    float sacc[32], dpacc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sacc[e] = dpacc[e] = 0.0f;
    wg::fence_regs(sacc);
    wg::fence_regs(dpacc);
    wg::wgmma_fence();
    wg::wgmma_ss_tile<D>(sacc, s_q, s_k(s));
    wg::wgmma_ss_tile<D>(dpacc, s_do, s_v(s));
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(sacc);
    wg::fence_regs(dpacc);

    // P and dS = P (dP - D[row]) in float32, dS rounded to bf16 as the
    // A fragment of dQ += dS K
    const bool masked = edge(q0, k0, n_q, n_k, causal, window);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int hh = (x >> 1) & 1;
      float p = exp2f(__fmaf_rn(sacc[x], scale_log2, -l2[hh]));
      if (masked) {
        const int i = q0 + frag_row(x, warp, lane);
        const int j = k0 + frag_col(x, lane);
        const bool vis = i < n_q && j < n_k && (!causal || i >= j) &&
                         (window <= 0 || i - j < window);
        p = vis ? p : 0.0f;
      }
      sacc[x] = p * (dpacc[x] - dd[hh]);
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = wg::pack_bf16(sacc[8 * kk + 2 * r],
                                  sacc[8 * kk + 2 * r + 1]);

    // dQ += dS K (K read N-major)
    wg::fence_regs(dq_acc);
    wg::wgmma_fence();
    wg::wgmma_rs_tile<D>(dq_acc, da, s_k(s));
    wg::wgmma_commit();
    wg::wgmma_wait_all();
    wg::fence_regs(dq_acc);
    wg::mbar_arrive(empty(s));
  }

  // dQ scale in bf16, staged in the Q tile, then 16-byte stores
  stage_rows<D>(dq_acc, scale, s_q, warp, lane);
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
  store_rows<D>(s_q, dq, q0, n_q, n_heads, h, b, tid);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv_out, int batch, int n_q, int n_k, int n_heads,
           int causal, int window, float scale, cudaStream_t stream) {
  static cudaError_t opted_kv =
      opt_in(flash_bwd_wgmma_dkdv_kernel<D>, smem_bytes<D>());
  static cudaError_t opted_q =
      opt_in(flash_bwd_wgmma_dq_kernel<D>, smem_bytes<D>());
  if (opted_kv != cudaSuccess) return (int)opted_kv;
  if (opted_q != cudaSuccess) return (int)opted_q;
  using T = __nv_bfloat16;
  const int n_rows = batch * n_q * n_heads;
  bwd::flash_bwd_delta_kernel<T>
      <<<(n_rows + bwd::kWarps - 1) / bwd::kWarps, bwd::kThreads, 0,
         stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                   delta, n_rows, n_q, n_heads, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, tdo;
  err = wg::make_map(&tq, q, batch, n_q, n_heads, D);
  if (err == cudaSuccess) err = wg::make_map(&tk, k, batch, n_k, n_heads, D);
  if (err == cudaSuccess) err = wg::make_map(&tv, v, batch, n_k, n_heads, D);
  if (err == cudaSuccess)
    err = wg::make_map(&tdo, dout, batch, n_q, n_heads, D);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = scale * kLog2e;
  if (n_k > 0) {
    const unsigned grid = (unsigned)((n_k + kB - 1) / kB) * n_heads * batch;
    flash_bwd_wgmma_dkdv_kernel<D><<<grid, kThreads, smem_bytes<D>(),
                                     stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv_out), batch, n_q, n_k, n_heads, causal, window,
        scale, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((n_q + kB - 1) / kB) * n_heads * batch;
  flash_bwd_wgmma_dq_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), batch, n_q, n_k,
      n_heads, causal, window, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace wgb

}  // namespace

// C entries for ctypes. Both launch on `stream` and return the launch's
// cudaError_t.
//
// The CUDA-core variant. q (batch, n_q, n_heads, d), k (batch, n_k,
// n_heads, d), v (batch, n_k, n_heads, dv) and o (batch, n_q, n_heads,
// dv) are contiguous device tensors of one dtype: float32 (dtype 0) or
// bfloat16 (dtype 1), 16-byte aligned; 8 <= d, dv <= 128, both
// multiples of 8. lse, null or float32 (batch, n_heads, n_q), gets each
// row's log-sum-exp of its scaled scores (training passes it, serving
// does not).
// causal: mask key j > query i; window > 0: mask i - j >= window.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int dtype,
                                   int batch, int n_q, int n_k, int n_heads,
                                   int d, int dv, int causal, int window,
                                   float scale, void* stream) {
  if (d < 8 || d > kMaxD || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dv < 8 || dv > kMaxD || dv % 8 != 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_q == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, batch, n_q, n_k, n_heads, d,
                           dv, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, n_q, n_k,
                                   n_heads, d, dv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core variant. q, k, v, o and lse as above, bfloat16 only,
// (d, dv) one of (64, 64), (128, 128) and MLA's (96, 64); the rows of
// q, k and v are addressed through TMA maps, so the tensors must be
// 16-byte aligned.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o, float* lse,
                                         int batch,
                                         int n_q, int n_k, int n_heads,
                                         int d, int dv, int causal,
                                         int window, float scale,
                                         void* stream) {
  if (batch == 0 || n_q == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && dv == 64)
    return wg::launch<64, 64>(q, k, v, o, lse, batch, n_q, n_k, n_heads,
                              causal, window, scale, s);
  if (d == 128 && dv == 128)
    return wg::launch<128, 128>(q, k, v, o, lse, batch, n_q, n_k, n_heads,
                                causal, window, scale, s);
  if (d == 96 && dv == 64)
    return wg::launch<96, 64>(q, k, v, o, lse, batch, n_q, n_k, n_heads,
                              causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The CUDA-core backward (of either forward). q, k, v, o as above, dout
// (the gradient of o) like o, lse the forward's (batch, n_heads, n_q)
// float32, delta a float32 scratch of the same shape; dq, dk, dv (like
// q, k, v) are written whole. The CUDA-core forward's dtypes and head
// dims. Three launches on `stream`; returns the first failing one's
// cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk,
                                   void* dv_out, int dtype, int batch,
                                   int n_q, int n_k, int n_heads, int d,
                                   int dv, int causal, int window,
                                   float scale, void* stream) {
  if (d < 8 || d > kMaxD || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dv < 8 || dv > kMaxD || dv % 8 != 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_q == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd::launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv_out,
                              batch, n_q, n_k, n_heads, d, dv, causal, window,
                              scale, s);
  if (dtype == 1)
    return bwd::launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv_out, batch, n_q, n_k, n_heads, d, dv,
                                      causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core backward: q, k, v, o, dout, lse, delta, dq, dk, dv as
// for flash_attention_bwd, bfloat16 only, with one head dim d (64 or
// 128) for q, k and v; q, k, v and dout are read through TMA maps, so
// they must be 16-byte aligned. Three launches on `stream`; returns the
// first failing one's cudaError_t.
extern "C" int flash_attention_wgmma_bwd(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const float* lse,
                                         float* delta, void* dq, void* dk,
                                         void* dv_out, int batch, int n_q,
                                         int n_k, int n_heads, int d,
                                         int causal, int window, float scale,
                                         void* stream) {
  if (batch == 0 || n_q == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return wgb::launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv_out,
                           batch, n_q, n_k, n_heads, causal, window, scale, s);
  if (d == 128)
    return wgb::launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv_out,
                            batch, n_q, n_k, n_heads, causal, window, scale,
                            s);
  return (int)cudaErrorInvalidValue;
}
