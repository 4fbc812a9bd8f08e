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
// the backward recomputes a chunk's states from it with the plain
// version's roundings (__fmul_rn / __fadd_rn). G's update is one fused
// multiply-add, fmaf(w, G, r dy), where the plain version also rounds
// w G on its own: ds0 agrees with it to float32 rounding, not bit for
// bit.
//
// A block is one (head, sequence) pair, 256 threads. Thread (p, g) owns
// two rows (2 p, 2 p + 1) of S and G at 8 columns, {4 g .. 4 g + 3} and
// {32 + 4 g .. 35 + 4 g} (so that the 8 column groups' 16-byte reads of
// a staged row are one contiguous 128 bytes), with the 8 threads of a
// row group in neighbouring lanes: 8 rows a warp, 16 entries a thread.
// The recomputed states stay in registers: a first pass over the chunk keeps the states
// before tokens 4, 8 and 12 in shared memory (each thread its own), and
// each quarter of the chunk, latest first, recomputes its four states
// from its start in registers (24 update steps for 16 tokens). A token
// costs a thread 2 x 8 x 6 float32 operations and two reductions, each
// a reduce-scatter by xor shuffles:
//   - dr, dk, dw are row sums: the two rows' 6 partial sums (padded to
//     8) over the group's 8 lanes (three steps), each lane ending with
//     one whole;
//   - dv is a column sum: the thread's two rows, then the warp's four row
//     groups (two steps, 6 shuffles), each lane ending with two columns,
//     written a warp a token into shared memory; the warps' partials of
//     a column are summed in warp order at the end of the chunk.
// Every sum has one fixed order and there are no atomics: two runs give
// the same bits. The next chunk's r, k, w, v, dy and its checkpointed
// state are loaded into registers while this chunk runs, and staged as
// float32 rows at its start.
// Tokens past the end of the sequence are staged as zeros with w = 1,
// which leave the states and G as they are: every chunk runs all 16
// tokens with no branch on its length, so the shuffles need no
// convergence checks.
// What bounds it: ~10 float32 operations an element a token (4 dh^2 of
// recompute x 1.5, 6 dh^2 of backward), so at (2, 4096, 64, 64) ~22
// GFLOP (0.3 ms at 67 TFLOP/s) against 537 MB of saved states (the
// bytes bound, 0.36 ms). As compiled, with the row and column sums'
// shuffles and selects and the staged rows' shared-memory reads, a
// token costs a warp ~320 instructions (the kernel's SASS over the 16
// tokens of a chunk, which chip_smoke.py's build phase prints),
// 60% of them the float32 operations above; the token
// loop is sequential, one pair a block and one block an SM (128 pairs
// at the training shape), so the instructions each SM dispatches a
// cycle bound it.
// Measured on an H100 at (2, 4096, 64, 64) bf16 (PERF.md): 1.79 ms;
// a row a thread over 512 threads, 8 entries each, 2.22 ms (more
// shuffles and staged reads per entry); the first design (128 threads
// a pair, a thread a row at 32 columns, its states in shared memory: 4
// warps an SM) 3.80 ms.
namespace bwd {

constexpr int kDH = 64;                 // the head dim it takes
constexpr int kCols = 8;                // columns a thread owns
constexpr int kGroups = kDH / kCols;    // threads of a row group
constexpr int kQuarter = kChunk / 4;    // states kept in registers
constexpr int kRowLd = kDH + 8;         // padded row of the row sums
constexpr int kRows = 2;                // rows a thread owns
constexpr int kThreads = kDH / kRows * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int E = kRows * kCols;        // a thread's entries

// staged r, k, w, v, dy [kChunk][kDH]; a, b [kChunk]; u [kDH]; the
// states before tokens 0, 4, 8, 12 [4][E / 4][kThreads][4]; the row sums
// dr, dk, dw [kChunk][3][kRowLd]; dv's warp partials
// [kChunk][kWarps][kDH]
constexpr size_t kSmemBytes =
    sizeof(float) * (5 * kChunk * kDH + 2 * kChunk + kDH + 4 * kThreads * E +
                     3 * kChunk * kRowLd + kChunk * kWarps * kDH);

// The next chunk's r, k, w, v, dy as 16-byte pieces, kPer a thread.
template <typename T, int NT>
struct Pieces {
  static constexpr int kVec = 16 / sizeof(T);        // elements a piece
  static constexpr int kCpr = kDH / kVec;            // pieces a token row
  static constexpr int kAll = 5 * kChunk * kCpr;
  static constexpr int kPer = (kAll + NT - 1) / NT;
};

__device__ __forceinline__ void unpack(const uint4& x, float* f, float) {
  *reinterpret_cast<float4*>(f) = *reinterpret_cast<const float4*>(&x);
}
__device__ __forceinline__ void unpack(const uint4& x, float* f,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
  const float2 p0 = __bfloat1622float2(h[0]), p1 = __bfloat1622float2(h[1]);
  const float2 p2 = __bfloat1622float2(h[2]), p3 = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(f)[0] = make_float4(p0.x, p0.y, p1.x, p1.y);
  reinterpret_cast<float4*>(f)[1] = make_float4(p2.x, p2.y, p3.x, p3.y);
}

// A thread's N entries (N / 8 rows, 8 columns each) of a 64 x 64
// float32 matrix whose row `i` starts at p + i * kDH: x[8 e + c] is row
// i + e at column (c < 4 ? c : 28 + c), relative to p.
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = *reinterpret_cast<const float4*>(
        p + (q >> 1) * kDH + (q & 1) * 32);
    x[4 * q] = f.x; x[4 * q + 1] = f.y; x[4 * q + 2] = f.z;
    x[4 * q + 3] = f.w;
  }
}
template <int N>
__device__ __forceinline__ void store_rows(float* p, const float (&x)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    *reinterpret_cast<float4*>(p + (q >> 1) * kDH + (q & 1) * 32) =
        make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// the two staged floats at p (a thread's rows of r, k or w)
__device__ __forceinline__ void own_rows(const float* p, float (&x)[kRows]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  x[0] = f.x;
  x[1] = f.y;
}

// A 16-byte piece of ones (the decay of a token past the sequence's end:
// it leaves the state and its gradient as they are)
template <typename T>
__device__ __forceinline__ uint4 ones() {
  const uint32_t one = sizeof(T) == 4 ? 0x3F800000u : 0x3F803F80u;
  return make_uint4(one, one, one, one);
}

// One xor-shuffle step of a reduce-scatter: lanes l and l ^ S swap the
// halves [0, N/2) / [N/2, N) of x[0, N) and keep, summed, the half that
// bit S of the lane picks, in x[0, N/2).
template <int N, int S>
__device__ __forceinline__ void rs_step(float* x, int lane) {
  const bool upper = (lane & S) != 0;
#pragma unroll
  for (int c = 0; c < N / 2; ++c) {
    const float send = upper ? x[c] : x[c + N / 2];
    const float keep = upper ? x[c + N / 2] : x[c];
    x[c] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ w,
               const T* __restrict__ u, const float* __restrict__ ckpt,
               const T* __restrict__ dy, const float* __restrict__ ds_out,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
               T* __restrict__ dw, float* __restrict__ du,
               float* __restrict__ ds_in, int n_t, int n_heads) {
  using P = Pieces<T, kThreads>;
  constexpr int NT = kThreads;
  constexpr int NX = 4 * kRows;           // 3 kRows row sums, padded
  extern __shared__ __align__(16) float sm[];
  float* s_in = sm;                       // r, k, w, v, dy
  float* s_r = s_in;
  float* s_k = s_r + kChunk * kDH;
  float* s_w = s_k + kChunk * kDH;
  float* s_v = s_w + kChunk * kDH;
  float* s_dy = s_v + kChunk * kDH;
  float* s_a = s_dy + kChunk * kDH;
  float* s_b = s_a + kChunk;
  float* s_u = s_b + kChunk;
  float* s_ck = s_u + kDH;
  float* s_rows = s_ck + 4 * NT * E;
  float* p_v = s_rows + 3 * kChunk * kRowLd;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & (kGroups - 1);     // the column group
  const int i = 4 * kRows * warp + kRows * (lane >> 3);  // the first row
  const int c0 = 4 * g;                   // columns c0.. and 32 + c0..
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t pitch = (size_t)n_heads * kDH;
  const size_t row0 = ((size_t)b * n_t * n_heads + h) * kDH;
  const size_t st = (((size_t)b * n_heads + h) * kDH + i) * kDH + c0;
  const int n_chunks = (n_t + kChunk - 1) / kChunk;
  const float* cp0 = ckpt + ((size_t)b * n_heads + h) * n_chunks * kDH * kDH
                     + (size_t)i * kDH + c0;
  // a thread's checkpoint slot q: E / 4 float4, NT apart
  auto ck_store = [&](int q, const float (&x)[E]) {
    float4* s = reinterpret_cast<float4*>(s_ck) + (size_t)q * E / 4 * NT + tid;
#pragma unroll
    for (int e = 0; e < E / 4; ++e)
      s[e * NT] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2],
                              x[4 * e + 3]);
  };
  auto ck_load = [&](int q, float (&x)[E]) {
    const float4* s =
        reinterpret_cast<const float4*>(s_ck) + (size_t)q * E / 4 * NT + tid;
#pragma unroll
    for (int e = 0; e < E / 4; ++e) {
      const float4 f = s[e * NT];
      x[4 * e] = f.x; x[4 * e + 1] = f.y; x[4 * e + 2] = f.z;
      x[4 * e + 3] = f.w;
    }
  };
  // one step of the state: S = w S + k v, the plain version's roundings
  auto advance = [&](float (&S)[E], int tt) {
    float kk[kRows], ww[kRows], vv[kCols];
    own_rows(s_k + tt * kDH + i, kk);
    own_rows(s_w + tt * kDH + i, ww);
    load_rows<kCols>(s_v + tt * kDH + c0, vv);
#pragma unroll
    for (int e = 0; e < kRows; ++e)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        S[kCols * e + c] = __fadd_rn(__fmul_rn(ww[e], S[kCols * e + c]),
                                     __fmul_rn(kk[e], vv[c]));
  };
  // chunk ch's r, k, w, v, dy into registers; tokens past n_t read as
  // zeros with w = 1, which leave the states and G as they are, so that
  // every chunk runs all its 16 tokens (the outputs past n_t are not
  // written)
  auto fetch = [&](int ch, uint4 (&buf)[P::kPer]) {
    const int t0 = ch * kChunk;
#pragma unroll
    for (int q = 0; q < P::kPer; ++q) {
      const int p = tid + q * NT;
      const int a = p / (kChunk * P::kCpr);
      const int rem = p - a * (kChunk * P::kCpr);
      const int tt = rem / P::kCpr, cc = rem - tt * P::kCpr;
      const T* src = a == 0 ? r : a == 1 ? k : a == 2 ? w : a == 3 ? v : dy;
      buf[q] = a == 2 ? ones<T>() : make_uint4(0u, 0u, 0u, 0u);
      if (p < P::kAll && t0 + tt < n_t)
        buf[q] = *reinterpret_cast<const uint4*>(
            src + row0 + (size_t)(t0 + tt) * pitch + cc * P::kVec);
    }
  };

  float G[E];
  if (ds_out != nullptr) {
    load_rows<E>(ds_out + st, G);
  } else {
#pragma unroll
    for (int c = 0; c < E; ++c) G[c] = 0.0f;
  }
  if (tid < kDH) s_u[tid] = to_f32(u[h * kDH + tid]);
  float du_acc = 0.0f;

  uint4 buf[P::kPer];
  float s_next[E];
  if (n_chunks > 0) {
    fetch(n_chunks - 1, buf);
    load_rows<E>(cp0 + (size_t)(n_chunks - 1) * kDH * kDH, s_next);
  }

  for (int ch = n_chunks - 1; ch >= 0; --ch) {
    const int t0 = ch * kChunk, n = min(kChunk, n_t - t0);
    __syncthreads();            // the last chunk's rows and sums are read
#pragma unroll
    for (int q = 0; q < P::kPer; ++q) {
      const int p = tid + q * NT;
      if (p < P::kAll) {
        const int a = p / (kChunk * P::kCpr);
        const int rem = p - a * (kChunk * P::kCpr);
        const int tt = rem / P::kCpr, cc = rem - tt * P::kCpr;
        unpack(buf[q], s_in + (a * kChunk + tt) * kDH + cc * P::kVec, T());
      }
    }
    float st4[kQuarter][E];     // the states of a quarter of the chunk
#pragma unroll
    for (int c = 0; c < E; ++c) st4[0][c] = s_next[c];
    ck_store(0, st4[0]);
    __syncthreads();
    if (ch > 0) {               // the next chunk's loads fly meanwhile
      fetch(ch - 1, buf);
      load_rows<E>(cp0 + (size_t)(ch - 1) * kDH * kDH, s_next);
    }
#pragma unroll
    for (int tt = warp; tt < kChunk; tt += kWarps) {  // a, b a token
      float a = 0.0f, bb = 0.0f;
#pragma unroll
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
    // the first pass: the states before tokens 4 and 8 to shared
    // memory, the one before 12 stays in st4[0] for the last quarter
#pragma unroll
    for (int tt = 0; tt < 3 * kQuarter; ++tt) {
      if (tt > 0 && tt % kQuarter == 0) ck_store(tt / kQuarter, st4[0]);
      advance(st4[0], tt);
    }
#pragma unroll
    for (int qr = 3; qr >= 0; --qr) {
      const int lo = qr * kQuarter;
      if (qr < 3) ck_load(qr, st4[0]);
#pragma unroll
      for (int q = 1; q < kQuarter; ++q) {
#pragma unroll
        for (int c = 0; c < E; ++c) st4[q][c] = st4[q - 1][c];
        advance(st4[q], lo + q - 1);
      }
#pragma unroll
      for (int q = kQuarter - 1; q >= 0; --q) {
        const int tt = lo + q;
        float rr[kRows], kk[kRows], ww[kRows], vv[kCols], gy[kCols];
        own_rows(s_r + tt * kDH + i, rr);
        own_rows(s_k + tt * kDH + i, kk);
        own_rows(s_w + tt * kDH + i, ww);
        load_rows<kCols>(s_v + tt * kDH + c0, vv);
        load_rows<kCols>(s_dy + tt * kDH + c0, gy);
        // x: dr, dk, dw of each row (and zeros); pv: the rows' share of
        // dv at the 8 columns
        float x[NX], pv[kCols];
#pragma unroll
        for (int e = 0; e < NX; ++e) x[e] = 0.0f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float* S = st4[q];
#pragma unroll
          for (int e = 0; e < kRows; ++e) {
            const float ge = G[kCols * e + c], se = S[kCols * e + c];
            x[3 * e] = fmaf(gy[c], se, x[3 * e]);
            x[3 * e + 1] = fmaf(ge, vv[c], x[3 * e + 1]);
            x[3 * e + 2] = fmaf(ge, se, x[3 * e + 2]);
            pv[c] = e == 0 ? __fmul_rn(ge, kk[0]) : fmaf(ge, kk[e], pv[c]);
            G[kCols * e + c] = fmaf(ww[e], ge, __fmul_rn(rr[e], gy[c]));
          }
        }
        // row sums over the group's 8 lanes: three steps leave lane g
        // with x[g] whole
        rs_step<NX, 4>(x, lane);
        rs_step<NX / 2, 2>(x, lane);
        rs_step<2, 1>(x, lane);
        if (g < 6) s_rows[(tt * 3 + g % 3) * kRowLd + i + g / 3] = x[0];
        // column sums over the warp's four row groups
        rs_step<8, 16>(pv, lane);
        rs_step<4, 8>(pv, lane);
        *reinterpret_cast<float2*>(
            p_v + (tt * kWarps + warp) * kDH + ((lane & 16) ? 32 : 0) +
            c0 + ((lane & 8) ? 2 : 0)) = make_float2(pv[0], pv[1]);
      }
    }
    __syncthreads();            // every row sum and partial is in
    for (int e = tid; e < n * kDH; e += NT) {
      const int tt = e / kDH, x = e - tt * kDH;
      const size_t at = row0 + (size_t)(t0 + tt) * pitch + x;
      const float bb = s_b[tt];
      const float* rows = s_rows + tt * 3 * kRowLd + x;
      float sv = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q)
        sv += p_v[(tt * kWarps + q) * kDH + x];
      store(&dr[at], rows[0] + s_u[x] * s_k[e] * bb);
      store(&dk[at], rows[kRowLd] + s_r[e] * s_u[x] * bb);
      store(&dw[at], rows[2 * kRowLd]);
      store(&dv[at], sv + s_a[tt] * s_dy[e]);
    }
    if (tid < kDH)
      for (int tt = n - 1; tt >= 0; --tt)
        du_acc += s_r[tt * kDH + tid] * s_k[tt * kDH + tid] * s_b[tt];
  }
  store_rows<E>(ds_in + st, G);
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
      (int)kSmemBytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(n_heads, batch);
  wkv_bwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), ckpt, static_cast<const T*>(dy), ds_out,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), du, ds_in, n_t, n_heads);
  return (int)cudaGetLastError();
}

int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const float* ckpt, const void* dy,
             const float* ds_out, void* dr, void* dk, void* dv, void* dw,
             float* du, float* ds_in, int dtype, int batch, int n_t,
             int n_heads, int dh, cudaStream_t s) {
  if (dh != kDH) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_heads == 0) return (int)cudaSuccess;
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, ckpt, dy, ds_out, dr, dk, dv, dw,
                         du, ds_in, batch, n_t, n_heads, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, ckpt, dy, ds_out, dr, dk,
                                 dv, dw, du, ds_in, batch, n_t, n_heads, s);
  return (int)cudaErrorInvalidValue;
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
  return bwd::dispatch(r, k, v, w, u, ckpt, dy, ds_out, dr, dk, dv, dw, du,
                       ds_in, dtype, batch, n_t, n_heads, dh,
                       static_cast<cudaStream_t>(stream));
}
