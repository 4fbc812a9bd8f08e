// Flash attention forward (online softmax) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention -> _kernel): every attention layer of a prefill.
// Semantics are those of models/attention.py::chunked_attention (the
// plain version): q (B, T, H, d), k and v (B, S, H, d), float32 or
// bfloat16, one head dim d for q, k and v; scores, running max,
// denominator and accumulator in float32; masked scores are -1e30 (a
// row with no visible key in a processed tile averages its values, as
// the plain version does); output in q's dtype.
//
// Design: one block per (query tile of 64 rows, head, batch), four
// warps of 16 query rows each. The query tile is staged once in shared
// memory, pre-scaled by d^-1/2; a loop over key tiles of 64 stages K
// (row-major, rows padded by 4 floats so the lanes' 16-byte reads of
// 32 different keys do not collide in a bank) and V in shared memory as
// float32, computes the 16 x 64 score tile of each warp (a lane owns
// two key columns), folds it into the running max and denominator with
// warp shuffles, and accumulates P V (a lane owns up to four of the
// d <= 128 output columns). Tiles come in with 16-byte global loads,
// eight in flight per thread before the first is used, so a tile costs
// about one memory latency. Key tiles that the causal or sliding-window
// mask leaves fully masked for every row of the block are not visited.
// The ragged edges of T and S are masked (zero-filled, zero weight), so
// any T and S work. At d = 128 a block needs 115,712 bytes of dynamic
// shared memory (opted in with cudaFuncSetAttribute, with the largest
// shared-memory carveout so that two blocks fit on an SM).
//
// What bounds it on this card: at the serve shapes (T = S = 64..384,
// H = 32, d = 128) the bytes (q, k, v read once, the output written
// once: 67 MB at (8, 256, 32, 128) bf16, ~20 us at 3.35 TB/s) bound it
// before the tensor cores do (4.3 GFLOP causal, ~4.4 us at 989 TFLOP/s).
// This first kernel runs its products on the float32 CUDA cores, not
// the tensor cores, and reads each K/V tile once per query tile, so it
// sits well above that bound; wgmma, TMA-fed tile rings and folding the
// GQA head repeat into the loads are the later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          int row0, int n_rows,
                                          size_t pitch, int d, float scale,
                                          float* dst, int ld) {
  constexpr int V = 16 / sizeof(T);
  const int n_vec = 64 * d / V;
  for (int base = 0; base < n_vec; base += kInFlight * kThreads) {
    uint4 buf[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e0 = (base + u * kThreads + (int)threadIdx.x) * V;
      const int r = e0 / d, c = e0 - r * d;
      const int i = row0 + r;
      buf[u] = (e0 < 64 * d && i < n_rows)
                   ? *reinterpret_cast<const uint4*>(src + i * pitch + c)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e0 = (base + u * kThreads + (int)threadIdx.x) * V;
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

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)kBQ * d + (size_t)kBK * (d + kKPad) +
                          (size_t)kBK * d + (size_t)kBQ * kBK);
}

// NC = ceil(d / 32): output columns per lane.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n_q,
                 int n_k, int n_heads, int d, int causal, int window,
                 float scale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = d + kKPad;
  float* sQ = smem;                      // [kBQ][d], scaled
  float* sK = sQ + kBQ * d;              // [kBK][ldk]
  float* sV = sK + kBK * ldk;            // [kBK][d]
  float* sP = sV + kBK * d;              // [kBQ][kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;     // this warp's first row
  const size_t pitch = (size_t)n_heads * d;   // between positions
  const T* qh = q + ((size_t)b * n_q * n_heads + h) * d;
  const T* kh = k + ((size_t)b * n_k * n_heads + h) * d;
  const T* vh = v + ((size_t)b * n_k * n_heads + h) * d;
  T* oh = o + ((size_t)b * n_q * n_heads + h) * d;

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
    load_tile(vh, k0, n_k, pitch, d, 1.0f, sV, d);
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
          vv[u][c] = col < d ? sV[(j + u) * d + col] : 0.0f;
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
      if (col < d) store(&oh[i * pitch + col], acc[rr][c] / denom);
    }
  }
}

template <typename K>
cudaError_t opt_in_smem(K kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_q, int n_k, int n_heads, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  // opt in once to the largest tile set (d = kMaxD) and the largest
  // shared-memory carveout, before any launch (and so outside any
  // CUDA-graph capture)
  static cudaError_t opt_in = opt_in_smem(flash_fwd_kernel<T, NC>);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((n_q + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_kernel<T, NC><<<grid, kThreads, smem_bytes(d), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_q, n_k, n_heads, d,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int batch, int n_q, int n_k, int n_heads, int d, int causal,
             int window, float scale, cudaStream_t s) {
  switch ((d + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                causal, window, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                causal, window, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                causal, window, scale, s);
    default: return launch<T, 4>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                 causal, window, scale, s);
  }
}

}  // namespace

// C entry for ctypes. q (batch, n_q, n_heads, d), k and v (batch, n_k,
// n_heads, d) and o (as q) are contiguous device tensors of one dtype:
// float32 (dtype 0) or bfloat16 (dtype 1), 16-byte aligned;
// 8 <= d <= 128, d % 8 == 0.
// causal: mask key j > query i; window > 0: mask i - j >= window.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype,
                                   int batch, int n_q, int n_k, int n_heads,
                                   int d, int causal, int window,
                                   float scale, void* stream) {
  if (d < 8 || d > kMaxD || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_q == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, batch, n_q, n_k, n_heads, d, causal,
                           window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                   causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
