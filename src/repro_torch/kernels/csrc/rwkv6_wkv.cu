// RWKV-6 wkv recurrence for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv.py
// (wkv_chunked -> _kernel): every RWKV layer of a prefill and of every
// decode step (T = 1). Semantics are those of
// models/rwkv6.py::wkv_scan (the plain version): r, k, v, w (B, T, H, dh)
// float32 or bfloat16, u (H, dh) of the same dtype, state (B, H, dh, dh)
// float32 [k-dim x v-dim]; per token
//     y_j  = sum_i r_i (S_ij + u_i k_i v_j)
//     S_ij = w_i S_ij + k_i v_j
// y in r's dtype, the final state float32.
//
// Design: the recurrence is computed directly, token by token, not in
// the TPU kernel's chunked form: that form scales keys by exp(-L) with
// L the in-chunk cumulative log-decay, which overflows float32 once -L
// passes ~88, and data-dependent decays reach that.
//
// Each state column j is split over G threads (G in {1, 2, 4, 8}):
// thread (j, g) keeps rows [g dh/G, (g+1) dh/G) of S[:, j] in registers
// for the whole sequence. The dh columns of a (head, batch) pair are
// split over C blocks (grid (C, H, B), dh/C columns and dh G / C threads
// a block), so that a small batch still spreads over the SMs. A block's
// threads run over its columns first, so the lanes of a warp share g
// (when a block has 32 columns or more) and every shared-memory read of
// r, k, w is a broadcast. As
//     y_j = sum_i r_i S_ij + v_j a,   a = sum_i r_i u_i k_i,
// a thread forms the partial sum_{own i} r_i S_ij of each token; the G
// partials of a column are summed through shared memory once per chunk
// of 16 tokens, where v_j a is added (a does not depend on j: the
// staging pass forms it once per token and block). Each thread updates
// its rows as kv = k_i v_j, S = w_i S, S = S + kv, every operation
// rounded on its own (__fmul_rn/__fadd_rn), which is the plain version's
// sequence: the final state equals it bit for bit; y differs only in
// the order of its sum. A row costs 4 float32 operations and 3
// shared-memory reads (r, k, w; four rows per 16-byte read). Tokens are
// staged 16 at a time: cp.async copies of the next chunk of r, k, w, v
// (16-byte pieces, double-buffered) fly while this chunk runs; a staging
// pass turns the chunk into float32 rows. G = 1, C = 1 is one thread per
// column, the first version's layout. The wrapper picks G and C from
// (B, T, H). Measured on an H100 (PERF.md): summing a column's
// partials with shuffles across G adjacent lanes, every token, was
// slower at one sequence (62.4 against 46.8 us at (1, 256, 64, 64)), and
// two or four columns a thread gained ~5% at B = 8 only.
//
// What bounds it on this card: at (1, 256, 64, 64) bf16 it moves ~12.6
// MB (r, k, v, w, y once, the state in and out: ~3.8 us at 3.35 TB/s)
// and does 4 dh^2 float32 operations per token and head (268 MFLOP:
// ~4.0 us at 67 TFLOP/s), so the float32 operations bound it, about as
// tightly as the bytes. The state update cannot fuse (that would change
// the state's rounding), so a row costs a multiply, a multiply, an add
// and one FMA for y, a quarter above the bound's count. The token loop
// is sequential: a single sequence is latency-bound (64 head pairs),
// and splitting a column over G threads shortens each token's chain by
// G; a batch of 8 has the threads to fill the card and is bound by
// issuing the float32 work and its shared-memory reads. A decode step
// (T = 1) reads and writes the state once and is launch-bound.
//
// Training: given a `ckpt` pointer the forward also writes the state
// before every chunk of 16 tokens, which the backward (namespace bwd,
// rwkv6_wkv_bwd, described there) recomputes its states from.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // tokens staged per round

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Staged float32 rows of one token: the G groups of R rows lie kPad
// floats apart, so that lanes of one warp that belong to different
// groups (a block of fewer than 32 column threads) hit different banks.
template <int DH, int G>
struct Rows {
  static constexpr int R = DH / G;
  static constexpr int kPad = G > 1 ? 4 : 0;
  static constexpr int kLd = DH + G * kPad;        // floats per token
  __device__ static int at(int i) { return i + (i / R) * kPad; }
};

// raw [2][4][kChunk][DH] T (r, k, w, v; two chunks), then float32
// sr, sk, sw [kChunk][kLd], sv [kChunk][DH], su [DH], sa [kChunk],
// py [kChunk][G][DH] (the row groups' partial y)
template <typename T, int DH, int G>
constexpr size_t smem_bytes() {
  return 2 * 4 * kChunk * DH * sizeof(T) +
         sizeof(float) * (3 * kChunk * Rows<DH, G>::kLd + kChunk * DH + DH +
                          kChunk + kChunk * G * DH);
}

// One state-row update of thread (j, g) for row i, and its y term.
__device__ __forceinline__ void row_step(float ri, float ki, float wi,
                                         float vj, float& s, float& y) {
  const float kv = __fmul_rn(ki, vj);
  y = __fmaf_rn(ri, s, y);               // with the state before the token
  s = __fadd_rn(__fmul_rn(wi, s), kv);   // the plain version's two steps
}

template <typename T, int DH, int G>
__global__ void __launch_bounds__(DH * G)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const T* __restrict__ u, const float* __restrict__ s_in,
           T* __restrict__ y, float* __restrict__ s_out,
           float* __restrict__ ckpt, int n_t, int n_heads, int n_cols) {
  using L = Rows<DH, G>;
  constexpr int R = L::R;
  constexpr int kVec = 16 / sizeof(T);           // elements per copy
  constexpr int kCpr = DH / kVec;                // copies per token row
  extern __shared__ __align__(16) uint8_t smem[];
  T* raw = reinterpret_cast<T*>(smem);
  float* sr =
      reinterpret_cast<float*>(smem + 2 * 4 * kChunk * DH * sizeof(T));
  float* sk = sr + kChunk * L::kLd;
  float* sw = sk + kChunk * L::kLd;
  float* sv = sw + kChunk * L::kLd;
  float* su = sv + kChunk * DH;
  float* sa = su + DH;
  float* py = sa + kChunk;

  const int nt = n_cols * G;                     // threads of the block
  const int tid = threadIdx.x;
  const int g = tid / n_cols;                    // a warp's lanes share g
  const int jl = tid % n_cols;                   // when n_cols >= 32
  const int c0 = blockIdx.x * n_cols;            // the block's first column
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int width = nt < 32 ? nt : 32;           // lanes of a warp
  const unsigned mask = nt >= 32 ? 0xffffffffu : (1u << nt) - 1u;
  const size_t pitch = (size_t)n_heads * DH;               // between tokens
  const size_t row0 = ((size_t)b * n_t * n_heads + h) * DH; // token 0
  const size_t st = ((size_t)b * n_heads + h) * DH * DH + c0 + jl;

  float S[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) S[rr] = s_in[st + (size_t)(g * R + rr) * DH];
  for (int i = tid; i < DH; i += nt) su[i] = to_f32(u[h * DH + i]);

  const int n_chunks = (n_t + kChunk - 1) / kChunk;
  // copy chunk c of r, k, w, v into raw buffer c % 2 (one commit group
  // per call, empty past the end, so that the wait count stays simple)
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const int t0 = c * kChunk, n = min(kChunk, n_t - t0);
      T* dst = raw + (c & 1) * 4 * kChunk * DH;
      const T* const src[4] = {r, k, w, v};
#pragma unroll
      for (int a = 0; a < 4; ++a)
        for (int e = tid; e < n * kCpr; e += nt) {
          const int tt = e / kCpr, cc = e - tt * kCpr;
          cp_async16(dst + (a * kChunk + tt) * DH + cc * kVec,
                     src[a] + row0 + (size_t)(t0 + tt) * pitch + cc * kVec);
        }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, n_t - t0);
    if (ckpt != nullptr) {         // training: the state before chunk c
      float* cp = ckpt + (((size_t)b * n_heads + h) * n_chunks + c) * DH * DH
                  + c0 + jl;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) cp[(size_t)(g * R + rr) * DH] = S[rr];
    }
    cp_async_wait_all_but_one();   // this thread's copies of chunk c
    __syncthreads();               // everyone's; chunk c - 1 is written
    const T* in = raw + (c & 1) * 4 * kChunk * DH;
    // a warp stages whole tokens and sums their r_i u_i k_i
    for (int tt = tid / 32; tt < n; tt += (nt + 31) / 32) {
      float a = 0.0f;
      for (int i = tid % 32; i < DH; i += width) {
        const float rf = to_f32(in[(0 * kChunk + tt) * DH + i]);
        const float kf = to_f32(in[(1 * kChunk + tt) * DH + i]);
        const int at = tt * L::kLd + L::at(i);
        sr[at] = rf;
        sk[at] = kf;
        sw[at] = to_f32(in[(2 * kChunk + tt) * DH + i]);
        sv[tt * DH + i] = to_f32(in[(3 * kChunk + tt) * DH + i]);
        a += rf * su[i] * kf;
      }
      for (int o = width / 2; o > 0; o >>= 1)
        a += __shfl_xor_sync(mask, a, o);
      if (tid % 32 == 0) sa[tt] = a;
    }
    __syncthreads();               // staged; raw buffer c % 2 is free
    issue(c + 2);

#pragma unroll 4
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt * DH + c0 + jl];
      const int off = tt * L::kLd + g * (R + L::kPad);
      const float* pr = sr + off;
      const float* pk = sk + off;
      const float* pw = sw + off;
      float ya = 0.0f, yb = 0.0f;
      if constexpr (R % 4 == 0) {
#pragma unroll
        for (int q4 = 0; q4 < R / 4; ++q4) {
          const float4 r4 = reinterpret_cast<const float4*>(pr)[q4];
          const float4 k4 = reinterpret_cast<const float4*>(pk)[q4];
          const float4 w4 = reinterpret_cast<const float4*>(pw)[q4];
          row_step(r4.x, k4.x, w4.x, vj, S[4 * q4 + 0], ya);
          row_step(r4.y, k4.y, w4.y, vj, S[4 * q4 + 1], yb);
          row_step(r4.z, k4.z, w4.z, vj, S[4 * q4 + 2], ya);
          row_step(r4.w, k4.w, w4.w, vj, S[4 * q4 + 3], yb);
        }
      } else {
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          row_step(pr[rr], pk[rr], pw[rr], vj, S[rr], rr % 2 ? yb : ya);
      }
      py[(tt * G + g) * n_cols + jl] = ya + yb;
    }
    __syncthreads();               // every partial of the chunk is in
    for (int e = tid; e < n * n_cols; e += nt) {
      const int tt = e / n_cols, cl = e - tt * n_cols;
      float yj = 0.0f;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) yj += py[(tt * G + gg) * n_cols + cl];
      const int j = c0 + cl;
      store(&y[row0 + (size_t)(t0 + tt) * pitch + j],
            yj + sa[tt] * sv[tt * DH + j]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
    s_out[st + (size_t)(g * R + rr) * DH] = S[rr];
}

template <typename T, int DH, int G>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* s_in, void* y, float* s_out,
           float* ckpt, int batch, int n_t, int n_heads, int splits,
           cudaStream_t stream) {
  // opt in once, before any launch (and so outside any CUDA-graph
  // capture), to the instantiation's shared memory
  static cudaError_t opt_in = cudaFuncSetAttribute(
      wkv_kernel<T, DH, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<T, DH, G>());
  if (opt_in != cudaSuccess) return (int)opt_in;
  const int n_cols = DH / splits;
  const dim3 grid(splits, n_heads, batch);
  wkv_kernel<T, DH, G><<<grid, n_cols * G, smem_bytes<T, DH, G>(), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s_in, static_cast<T*>(y), s_out, ckpt, n_t,
      n_heads, n_cols);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int by_groups(const void* r, const void* k, const void* v, const void* w,
              const void* u, const float* s_in, void* y, float* s_out,
              float* ckpt, int batch, int n_t, int n_heads, int groups,
              int splits, cudaStream_t s) {
  switch (groups) {
    case 1: return launch<T, DH, 1>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                    batch, n_t, n_heads, splits, s);
    case 2: return launch<T, DH, 2>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                    batch, n_t, n_heads, splits, s);
    case 4: return launch<T, DH, 4>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                    batch, n_t, n_heads, splits, s);
    case 8: return launch<T, DH, 8>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                    batch, n_t, n_heads, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const float* s_in, void* y, float* s_out,
             float* ckpt, int batch, int n_t, int n_heads, int dh,
             int groups, int splits, cudaStream_t s) {
  switch (dh) {
    case 8: return by_groups<T, 8>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                   batch, n_t, n_heads, groups, splits, s);
    case 16: return by_groups<T, 16>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                     batch, n_t, n_heads, groups, splits, s);
    case 32: return by_groups<T, 32>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                     batch, n_t, n_heads, groups, splits, s);
    case 64: return by_groups<T, 64>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                     batch, n_t, n_heads, groups, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// The backward (training; no Pallas counterpart: the reference cannot
// differentiate its TPU kernel and trains through the plain wkv_scan).
// With G_t = dL/dS_t (G_T = dsT, zeros when the final state is unused)
// and S_{t-1} the state before token t, per token, latest first:
//     dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u_i k_t[i] b_t
//     dk_t[i] = sum_j G_t[i,j] v_t[j]      + r_t[i] u_i b_t
//     dv_t[j] = sum_i G_t[i,j] k_t[i]      + a_t dy_t[j]
//     dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//     du[i]  += r_t[i] k_t[i] b_t
//     G_{t-1}[i,j] = w_t[i] G_t[i,j] + r_t[i] dy_t[j]
// with a_t = sum_i r_t[i] u_i k_t[i], b_t = v_t . dy_t, and ds0 = G_0.
// S_{t-1} is never recovered by dividing by w (w = exp(-exp(x)) reaches
// 0): the forward writes the state before every chunk of 16 tokens into
// a scratch the caller owns (B, H, ceil(T/16), 64, 64) float32, and
// the backward recomputes a chunk's states from it, the plain version's
// roundings, eight at a time into shared memory (each thread its own),
// 24 update steps for 16 tokens.
//
// A block is one (head, sequence) pair, 128 threads: thread (i, half)
// owns row i of S and G over 32 columns, so the row sums of dr, dk and
// dw are its own plus the other half's (through shared memory once a
// chunk), and the column sum of dv is a 31-shuffle reduce-scatter over
// the warp's 32 rows plus the other warp's. No atomics: the same bits
// every run. What bounds it: ~10 float32 operations an element a token
// (4 dh^2 of recompute x 1.5, 6 dh^2 of backward), so at (2, 4096, 64,
// 64) ~22 GFLOP (0.3 ms at 67 TFLOP/s); the token loop is sequential
// and a pair is one block of four warps, so it is latency-bound.
namespace bwd {

constexpr int kDH = 64;                 // the head dim it takes
constexpr int kThreads = 2 * kDH;
constexpr int kHalf = kDH / 2;          // columns a thread owns
constexpr int kSub = 8;                 // states kept at once

// staged r, k, v, w, dy [kChunk][kDH], a and b [kChunk], u [kDH], the
// states [kSub][2][kHalf][kDH], the partial row sums of dr, dk, dw
// [kChunk][2][kDH] and of dv's column sums [kChunk][2][kDH]
constexpr size_t smem_bytes() {
  return sizeof(float) * (5 * kChunk * kDH + 2 * kChunk + kDH +
                          (size_t)kSub * kDH * kDH + 4 * kChunk * 2 * kDH);
}

// One step of a reduce-scatter over a warp: lanes l and l ^ S swap the
// halves [0, S) / [S, 2S) of x[0, 2S) and keep the sum of the half
// their bit S picks. After S = 16, 8, 4, 2, 1, lane l holds in x[0] the
// warp's sum of x[l].
template <int S>
__device__ __forceinline__ void rs_step(float (&x)[kHalf], int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int c = 0; c < S; ++c) {
    const float send = upper ? x[c] : x[c + S];
    const float keep = upper ? x[c + S] : x[c];
    x[c] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const T* __restrict__ u, const float* __restrict__ ckpt,
               const T* __restrict__ dy, const float* __restrict__ ds_out,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               T* __restrict__ dw, float* __restrict__ du,
               float* __restrict__ ds_in, int n_t, int n_heads) {
  extern __shared__ __align__(16) float sm[];
  float* s_r = sm;
  float* s_k = s_r + kChunk * kDH;
  float* s_v = s_k + kChunk * kDH;
  float* s_w = s_v + kChunk * kDH;
  float* s_dy = s_w + kChunk * kDH;
  float* s_a = s_dy + kChunk * kDH;
  float* s_b = s_a + kChunk;
  float* s_u = s_b + kChunk;
  float* s_st = s_u + kDH;
  float* p_r = s_st + kSub * kDH * kDH;
  float* p_k = p_r + kChunk * 2 * kDH;
  float* p_w = p_k + kChunk * 2 * kDH;
  float* p_v = p_w + kChunk * 2 * kDH;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid & (kDH - 1);          // the row this thread owns
  const int hf = tid / kDH;               // and its half of the columns
  const int rw = warp & 1;                // its warp's 32 rows
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t pitch = (size_t)n_heads * kDH;
  const size_t row0 = ((size_t)b * n_t * n_heads + h) * kDH;
  const size_t st = ((size_t)b * n_heads + h) * kDH * kDH + (size_t)i * kDH
                    + hf * kHalf;
  const int n_chunks = (n_t + kChunk - 1) / kChunk;
  const float* cp0 = ckpt + ((size_t)b * n_heads + h) * n_chunks * kDH * kDH
                     + (size_t)i * kDH + hf * kHalf;

  float G[kHalf];
#pragma unroll
  for (int c = 0; c < kHalf; ++c)
    G[c] = ds_out != nullptr ? ds_out[st + c] : 0.0f;
  if (tid < kDH) s_u[tid] = to_f32(u[h * kDH + tid]);
  float du_acc = 0.0f;

  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, n = min(kChunk, n_t - t0);
    __syncthreads();            // the last chunk's rows and partials read
    for (int e = tid; e < n * kDH; e += kThreads) {
      const int tt = e / kDH, x = e - tt * kDH;
      const size_t at = row0 + (size_t)(t0 + tt) * pitch + x;
      s_r[e] = to_f32(r[at]);
      s_k[e] = to_f32(k[at]);
      s_v[e] = to_f32(v[at]);
      s_w[e] = to_f32(w[at]);
      s_dy[e] = to_f32(dy[at]);
    }
    __syncthreads();
    for (int tt = warp; tt < n; tt += kThreads / 32) {   // a, b a token
      float a = 0.0f, bb = 0.0f;
      for (int x = lane; x < kDH; x += 32) {
        a += s_r[tt * kDH + x] * s_u[x] * s_k[tt * kDH + x];
        bb += s_v[tt * kDH + x] * s_dy[tt * kDH + x];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        bb += __shfl_xor_sync(0xffffffffu, bb, o);
      }
      if (lane == 0) {
        s_a[tt] = a;
        s_b[tt] = bb;
      }
    }
    const float* cp = cp0 + (size_t)ch * kDH * kDH;
    for (int part = (n - 1) / kSub; part >= 0; --part) {
      const int lo = part * kSub, hi = min(n, lo + kSub);
      // recompute S_{t-1} for the tokens [lo, hi) of the chunk from the
      // state before it; each thread keeps its own entries
      float S[kHalf];
#pragma unroll
      for (int c = 0; c < kHalf; c += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(cp + c);
        S[c] = x4.x;
        S[c + 1] = x4.y;
        S[c + 2] = x4.z;
        S[c + 3] = x4.w;
      }
      for (int tt = 0; tt < hi - 1; ++tt) {
        if (tt >= lo) {
          float* sp = s_st + ((tt - lo) * 2 + hf) * kHalf * kDH + i;
#pragma unroll
          for (int c = 0; c < kHalf; ++c) sp[c * kDH] = S[c];
        }
        const float ki = s_k[tt * kDH + i], wi = s_w[tt * kDH + i];
        const float* vv = s_v + tt * kDH + hf * kHalf;
#pragma unroll
        for (int c = 0; c < kHalf; ++c)
          S[c] = __fadd_rn(__fmul_rn(wi, S[c]), __fmul_rn(ki, vv[c]));
      }
      {
        float* sp = s_st + ((hi - 1 - lo) * 2 + hf) * kHalf * kDH + i;
#pragma unroll
        for (int c = 0; c < kHalf; ++c) sp[c * kDH] = S[c];
      }
      for (int tt = hi - 1; tt >= lo; --tt) {
        const float ri = s_r[tt * kDH + i], ki = s_k[tt * kDH + i];
        const float wi = s_w[tt * kDH + i];
        const float* sp = s_st + ((tt - lo) * 2 + hf) * kHalf * kDH + i;
        const float* vv = s_v + tt * kDH + hf * kHalf;
        const float* gy = s_dy + tt * kDH + hf * kHalf;
        float pr = 0.0f, pk = 0.0f, pw = 0.0f, pv[kHalf];
#pragma unroll
        for (int c = 0; c < kHalf; ++c) {
          const float sv = sp[c * kDH];
          pw = fmaf(G[c], sv, pw);
          pk = fmaf(G[c], vv[c], pk);
          pr = fmaf(gy[c], sv, pr);
          pv[c] = __fmul_rn(G[c], ki);
          G[c] = __fadd_rn(__fmul_rn(wi, G[c]), __fmul_rn(ri, gy[c]));
        }
        p_r[(tt * 2 + hf) * kDH + i] = pr;
        p_k[(tt * 2 + hf) * kDH + i] = pk;
        p_w[(tt * 2 + hf) * kDH + i] = pw;
        rs_step<16>(pv, lane);
        rs_step<8>(pv, lane);
        rs_step<4>(pv, lane);
        rs_step<2>(pv, lane);
        rs_step<1>(pv, lane);
        p_v[(tt * 2 + rw) * kDH + hf * kHalf + lane] = pv[0];
      }
    }
    __syncthreads();            // every partial of the chunk is in
    for (int e = tid; e < n * kDH; e += kThreads) {
      const int tt = e / kDH, x = e - tt * kDH;
      const size_t at = row0 + (size_t)(t0 + tt) * pitch + x;
      const float bb = s_b[tt];
      const int p0 = tt * 2 * kDH + x, p1 = p0 + kDH;
      store(&dr[at], p_r[p0] + p_r[p1] + s_u[x] * s_k[e] * bb);
      store(&dk[at], p_k[p0] + p_k[p1] + s_r[e] * s_u[x] * bb);
      store(&dw[at], p_w[p0] + p_w[p1]);
      store(&dv[at], p_v[p0] + p_v[p1] + s_a[tt] * s_dy[e]);
    }
    if (tid < kDH)
      for (int tt = n - 1; tt >= 0; --tt)
        du_acc += s_r[tt * kDH + tid] * s_k[tt * kDH + tid] * s_b[tt];
  }
#pragma unroll
  for (int c = 0; c < kHalf; ++c) ds_in[st + c] = G[c];
  if (tid < kDH) du[((size_t)b * n_heads + h) * kDH + tid] = du_acc;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* ckpt, const void* dy,
           const float* ds_out, void* dr, void* dk, void* dv, void* dw,
           float* du, float* ds_in, int batch, int n_t, int n_heads,
           cudaStream_t stream) {
  static cudaError_t opt_in = cudaFuncSetAttribute(
      wkv_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes());
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(n_heads, batch);
  wkv_bwd_kernel<T><<<grid, kThreads, smem_bytes(), stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), ckpt, static_cast<const T*>(dy), ds_out,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), du, ds_in, n_t, n_heads);
  return (int)cudaGetLastError();
}

}  // namespace bwd

}  // namespace

// C entry for ctypes. r, k, v, w, y (batch, n_t, n_heads, dh) and u
// (n_heads, dh) are contiguous, 16-byte aligned device tensors of one
// dtype, float32 (dtype 0) or bfloat16 (dtype 1); s_in and s_out (batch,
// n_heads, dh, dh) are float32. dh is 8, 16, 32 or 64; groups (threads
// per state column) 1, 2, 4 or 8; splits (blocks per head and sequence)
// 1, 2 or 4. ckpt, null or float32 (batch, n_heads, ceil(n_t / 16),
// dh, dh), gets the state before every chunk of 16 tokens (training
// passes it for the backward; serving does not). Launches on `stream`
// and returns the launch's cudaError_t.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u,
                             const float* s_in, void* y, float* s_out,
                             float* ckpt, int dtype, int batch, int n_t,
                             int n_heads, int dh, int groups, int splits,
                             void* stream) {
  if (splits != 1 && splits != 2 && splits != 4)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s_in, y, s_out, ckpt, batch, n_t,
                           n_heads, dh, groups, splits, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s_in, y, s_out, ckpt,
                                   batch, n_t, n_heads, dh, groups, splits,
                                   s);
  return (int)cudaErrorInvalidValue;
}

// The backward. r, k, v, w, dy, dr, dk, dv, dw (batch, n_t, n_heads, 64)
// and u (n_heads, 64) of one dtype as above; ckpt the forward's
// (batch, n_heads, ceil(n_t / 16), 64, 64) float32; ds_out, null (the
// final state unused) or float32 (batch, n_heads, 64, 64), the
// gradient of the final state; du (batch, n_heads, 64) float32 (the
// caller sums the batch) and ds_in like ds_out, the gradient of the
// initial state. Every output is written whole. Launches on `stream`
// and returns the launch's cudaError_t.
extern "C" int rwkv6_wkv_bwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u,
                             const float* ckpt, const void* dy,
                             const float* ds_out, void* dr, void* dk,
                             void* dv, void* dw, float* du, float* ds_in,
                             int dtype, int batch, int n_t, int n_heads,
                             int dh, void* stream) {
  if (dh != bwd::kDH) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd::launch<float>(r, k, v, w, u, ckpt, dy, ds_out, dr, dk, dv,
                              dw, du, ds_in, batch, n_t, n_heads, s);
  if (dtype == 1)
    return bwd::launch<__nv_bfloat16>(r, k, v, w, u, ckpt, dy, ds_out, dr,
                                      dk, dv, dw, du, ds_in, batch, n_t,
                                      n_heads, s);
  return (int)cudaErrorInvalidValue;
}
