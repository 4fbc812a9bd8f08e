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
           T* __restrict__ y, float* __restrict__ s_out, int n_t,
           int n_heads, int n_cols) {
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
           int batch, int n_t, int n_heads, int splits, cudaStream_t stream) {
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
      static_cast<const T*>(u), s_in, static_cast<T*>(y), s_out, n_t,
      n_heads, n_cols);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int by_groups(const void* r, const void* k, const void* v, const void* w,
              const void* u, const float* s_in, void* y, float* s_out,
              int batch, int n_t, int n_heads, int groups, int splits,
              cudaStream_t s) {
  switch (groups) {
    case 1: return launch<T, DH, 1>(r, k, v, w, u, s_in, y, s_out, batch,
                                    n_t, n_heads, splits, s);
    case 2: return launch<T, DH, 2>(r, k, v, w, u, s_in, y, s_out, batch,
                                    n_t, n_heads, splits, s);
    case 4: return launch<T, DH, 4>(r, k, v, w, u, s_in, y, s_out, batch,
                                    n_t, n_heads, splits, s);
    case 8: return launch<T, DH, 8>(r, k, v, w, u, s_in, y, s_out, batch,
                                    n_t, n_heads, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const float* s_in, void* y, float* s_out,
             int batch, int n_t, int n_heads, int dh, int groups,
             int splits, cudaStream_t s) {
  switch (dh) {
    case 8: return by_groups<T, 8>(r, k, v, w, u, s_in, y, s_out, batch,
                                   n_t, n_heads, groups, splits, s);
    case 16: return by_groups<T, 16>(r, k, v, w, u, s_in, y, s_out, batch,
                                     n_t, n_heads, groups, splits, s);
    case 32: return by_groups<T, 32>(r, k, v, w, u, s_in, y, s_out, batch,
                                     n_t, n_heads, groups, splits, s);
    case 64: return by_groups<T, 64>(r, k, v, w, u, s_in, y, s_out, batch,
                                     n_t, n_heads, groups, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry for ctypes. r, k, v, w, y (batch, n_t, n_heads, dh) and u
// (n_heads, dh) are contiguous, 16-byte aligned device tensors of one
// dtype, float32 (dtype 0) or bfloat16 (dtype 1); s_in and s_out (batch,
// n_heads, dh, dh) are float32. dh is 8, 16, 32 or 64; groups (threads
// per state column) 1, 2, 4 or 8; splits (blocks per head and sequence)
// 1, 2 or 4. Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u,
                             const float* s_in, void* y, float* s_out,
                             int dtype, int batch, int n_t, int n_heads,
                             int dh, int groups, int splits, void* stream) {
  if (splits != 1 && splits != 2 && splits != 4)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s_in, y, s_out, batch, n_t,
                           n_heads, dh, groups, splits, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s_in, y, s_out, batch,
                                   n_t, n_heads, dh, groups, splits, s);
  return (int)cudaErrorInvalidValue;
}
