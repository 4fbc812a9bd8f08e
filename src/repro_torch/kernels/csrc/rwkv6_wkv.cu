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
// passes ~88, and data-dependent decays reach that. One block per
// (head, batch) with dh threads; thread j keeps column S[:, j] (dh
// floats) in registers for the whole sequence. Tokens are staged 16 at
// a time: each thread loads element j of r, k, w, v of the 16 tokens
// into shared memory (every thread reads all dh of r, k, w), then the
// block runs them without further barriers. Products and sums are
// rounded one at a time (the build uses -fmad=false), in the plain
// version's order, so the state matches it exactly and y up to the
// order of the sum over i.
//
// What bounds it on this card: at (1, 256, 64, 64) bf16 it moves ~12.6
// MB (r, k, v, w, y once, the state in and out: ~3.8 us at 3.35 TB/s)
// and does 4 dh^2 float32 operations per token and head (the y
// contraction and the decayed state update, 268 MFLOP: ~4.0 us at 67
// TFLOP/s), so the float32 operations bound it, about as tightly as
// the bytes. The sequential loop over tokens and the B * H blocks of dh
// threads leave it latency-bound well above that; a decode step
// (T = 1) is launch-bound. Splitting the i-sum over more threads per
// column, and a chunked form with safe rescaling, are later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;   // tokens staged per barrier

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(DH)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const T* __restrict__ u, const float* __restrict__ s_in,
           T* __restrict__ y, float* __restrict__ s_out, int n_t,
           int n_heads) {
  __shared__ float sr[kChunk][DH], sk[kChunk][DH], sw[kChunk][DH];
  __shared__ float sv[kChunk][DH], su[DH];
  const int j = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const size_t pitch = (size_t)n_heads * DH;             // between tokens
  const size_t col = ((size_t)b * n_t * n_heads + h) * DH + j;
  const size_t st = ((size_t)b * n_heads + h) * DH * DH + j;

  float S[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) S[i] = s_in[st + (size_t)i * DH];
  su[j] = to_f32(u[h * DH + j]);

  for (int t0 = 0; t0 < n_t; t0 += kChunk) {
    const int n = min(kChunk, n_t - t0);
    __syncthreads();            // su written; last chunk fully read
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      if (tt < n) {
        const size_t off = col + (size_t)(t0 + tt) * pitch;
        sr[tt][j] = to_f32(r[off]);
        sk[tt][j] = to_f32(k[off]);
        sw[tt][j] = to_f32(w[off]);
        sv[tt][j] = to_f32(v[off]);
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float yj = 0.0f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const float kv = sk[tt][i] * vj;
        yj += sr[tt][i] * (S[i] + su[i] * kv);
        S[i] = sw[tt][i] * S[i] + kv;
      }
      store(&y[col + (size_t)(t0 + tt) * pitch], yj);
    }
  }
#pragma unroll
  for (int i = 0; i < DH; ++i) s_out[st + (size_t)i * DH] = S[i];
}

template <typename T, int DH>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* s_in, void* y, float* s_out,
           int batch, int n_t, int n_heads, cudaStream_t stream) {
  const dim3 grid(n_heads, batch);
  wkv_kernel<T, DH><<<grid, DH, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s_in, static_cast<T*>(y), s_out, n_t,
      n_heads);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const float* s_in, void* y, float* s_out,
             int batch, int n_t, int n_heads, int dh, cudaStream_t s) {
  switch (dh) {
    case 8: return launch<T, 8>(r, k, v, w, u, s_in, y, s_out, batch, n_t,
                                n_heads, s);
    case 16: return launch<T, 16>(r, k, v, w, u, s_in, y, s_out, batch, n_t,
                                  n_heads, s);
    case 32: return launch<T, 32>(r, k, v, w, u, s_in, y, s_out, batch, n_t,
                                  n_heads, s);
    case 64: return launch<T, 64>(r, k, v, w, u, s_in, y, s_out, batch, n_t,
                                  n_heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry for ctypes. r, k, v, w, y (batch, n_t, n_heads, dh) and u
// (n_heads, dh) are contiguous device tensors of one dtype, float32
// (dtype 0) or bfloat16 (dtype 1); s_in and s_out (batch, n_heads, dh,
// dh) are float32. dh is 8, 16, 32 or 64. Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* w, const void* u,
                             const float* s_in, void* y, float* s_out,
                             int dtype, int batch, int n_t, int n_heads,
                             int dh, void* stream) {
  if (batch == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s_in, y, s_out, batch, n_t,
                           n_heads, dh, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, s_in, y, s_out, batch,
                                   n_t, n_heads, dh, s);
  return (int)cudaErrorInvalidValue;
}
