// Flash attention forward (online softmax) for NVIDIA Hopper (sm_90a).
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
// * flash_wgmma_kernel (namespace wg), bfloat16 with d = dv in
//   {64, 128}: the tensor-core design. A block is a consumer warpgroup (warps 0-3,
//   64 query rows: wgmma's M) and a producer warp, and walks one or more
//   64-row query tiles of one (head, batch) pair: as many as it takes to
//   give each SM two blocks (all 4 at (8, 256), 1 for a single request).
//   The producer keeps a two-deep Q ring and a two-stage K/V ring of
//   64-key tiles filled with TMA (cp.async.bulk.tensor over a rank-4
//   (d, head, position, batch) map, so rows past S are zero-filled and
//   never the next sequence's), K and V on mbarriers of their own, so
//   the next tiles' copies overlap this tile's math. Tiles stay bf16 in
//   shared memory with the 128-byte swizzle (a d = 128 row is two
//   swizzle atom columns), 16 KB per 64 x 128 tile, 97 KB a block, two
//   blocks an SM. S = Q K^T is wgmma m64n64k16 from shared memory (K
//   row-major is the K-major B operand); the softmax runs on the
//   accumulator fragment (thread lane of warp w holds rows
//   16 w + lane / 4 and + 8, columns 8 j + 2 (lane % 4) + {0, 1}; row max
//   and sum over the quad with two shuffles), with the per-element masks
//   only on the tiles a mask or the end of S reaches; P is rounded to
//   bf16 in registers and is wgmma's A fragment as it stands; O += P V
//   is wgmma m64n{d}k16 with V as the transposed (d-contiguous) B
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
//   or with dv != d (8 <= d, dv <= 128, both multiples of 8; MLA's
//   prefill gives d = 96 (nope 64 + rope 32), dv = 64): the CUDA-core
//   design. One block of
//   four warps per (64-row query tile, head, batch); the query tile is
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

size_t smem_bytes(int d, int dv) {
  return sizeof(float) * ((size_t)kBQ * d + (size_t)kBK * (d + kKPad) +
                          (size_t)kBK * dv + (size_t)kBQ * kBK);
}

// NC = ceil(dv / 32): output columns per lane. d is the head dim of q
// and k, dv that of v and the output.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int n_q,
                 int n_k, int n_heads, int d, int dv, int causal,
                 int window, float scale) {
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
  }
}

template <typename K>
cudaError_t opt_in_smem(K kernel) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes(kMaxD, kMaxD));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_q, int n_k, int n_heads, int d, int dv, int causal,
           int window, float scale, cudaStream_t stream) {
  // opt in once to the largest tile set (d = dv = kMaxD) and the largest
  // shared-memory carveout, before any launch (and so outside any
  // CUDA-graph capture)
  static cudaError_t opt_in = opt_in_smem(flash_fwd_kernel<T, NC>);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((n_q + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_kernel<T, NC><<<grid, kThreads, smem_bytes(d, dv), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_q, n_k, n_heads, d,
      dv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             int batch, int n_q, int n_k, int n_heads, int d, int dv,
             int causal, int window, float scale, cudaStream_t s) {
  switch ((dv + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                dv, causal, window, scale, s);
    case 2: return launch<T, 2>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                dv, causal, window, scale, s);
    case 3: return launch<T, 3>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                dv, causal, window, scale, s);
    default: return launch<T, 4>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                 dv, causal, window, scale, s);
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

template <int D>
__host__ __device__ constexpr int tile_bytes() { return kBQ * D * 2; }

// Q of two query tiles, then K and V of each stage, each tile 1024-byte
// aligned; then the barriers (q_full[2], q_empty[2], k_full[kStages],
// v_full[kStages], empty[kStages]); plus the slack that aligns the base
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (2 + 2 * kStages) * tile_bytes<D>() + 8 * (4 + 3 * kStages) + 1024;
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

// A block walks query tiles [first, first + count) of one (head,
// batch) pair: warps 0-3 form the consumer warpgroup, warp 4 the
// producer. The producer keeps a two-deep Q ring and a kStages-deep K/V
// ring filled across the block's query tiles, so the next tile's copies
// overlap this tile's math and output.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int n_q, int n_k,
                   int n_heads, int causal, int window, float scale_log2,
                   int per_block) {
  constexpr int kTile = tile_bytes<D>();
  constexpr int kAtoms = D / 64;         // swizzle atom columns of a row
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + (2 + 2 * kStages) * kTile;
  auto s_q = [&](int s) { return base + s * kTile; };
  auto s_k = [&](int s) { return base + (2 + 2 * s) * kTile; };
  auto s_v = [&](int s) { return base + (3 + 2 * s) * kTile; };
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
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load(s_q(qs) + a * kAtom, &tq, 64 * a, h, qt * kBQ, b,
                   q_full(qs));
        int t_begin, t_end;
        key_tiles(qt, t_begin, t_end);
        for (int t = t_begin; t < t_end; ++t, ++n) {
          const int s = n % kStages;
          const int u = n / kStages;     // earlier fills of stage s
          if (u > 0) mbar_wait(empty(s), (u - 1) & 1);
          // K and V on barriers of their own: S = Q K^T starts while
          // V is still on its way
          mbar_expect_tx(k_full(s), kTile);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            tma_load(s_k(s) + a * kAtom, &tk, 64 * a, h, t * kBK, b,
                     k_full(s));
          mbar_expect_tx(v_full(s), kTile);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            tma_load(s_v(s) + a * kAtom, &tv, 64 * a, h, t * kBK, b,
                     v_full(s));
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
    float oacc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) oacc[e] = 0.0f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.0f, 0.0f};     // this thread's columns only
    mbar_wait(q_full(qs), (qi >> 1) & 1);

    for (int t = t_begin; t < t_end; ++t, ++n) {
      const int s = n % kStages;
      mbar_wait(k_full(s), (n / kStages) & 1);
      __syncwarp();                    // converged for the .aligned wgmma

      // S = Q K^T: 64 x 64, float32, D / 16 k-steps
      float sacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sacc[e] = 0.0f;
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kAtom + (kk % 4) * 32;
        wgmma_ss_n64(sacc, desc_sw128(s_q(qs) + off, 16, 1024),
                     desc_sw128(s_k(s) + off, 16, 1024), kk > 0);
      }
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
      for (int jn = 0; jn < D / 8; ++jn) {
        oacc[4 * jn + 0] *= alpha[0];
        oacc[4 * jn + 1] *= alpha[0];
        oacc[4 * jn + 2] *= alpha[1];
        oacc[4 * jn + 3] *= alpha[1];
      }

      // O += P V: P in bf16 as the register A fragment (two adjacent n8
      // chunks of the accumulator are one k16 fragment), V (keys x d,
      // d contiguous) as the transposed B from shared memory
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
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = desc_sw128(s_v(s) + kk * 16 * 128, kAtom, 1024);
        if constexpr (D == 128)
          wgmma_rs_n128(oacc, pa[kk], dv);
        else
          wgmma_rs_n64(oacc, pa[kk], dv);
      }
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
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        st_shared(stage_out + out_offset(r, jn, 2 * D) + 2 * col_in,
                  pack_bf16(oacc[4 * jn + 2 * hh] * inv,
                            oacc[4 * jn + 2 * hh + 1] * inv));
    }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    constexpr int kChunks = D / 8;         // 16-byte chunks of a row
#pragma unroll
    for (int e = tid; e < kBQ * kChunks; e += kConsumers) {
      const int r = e / kChunks, c = e % kChunks;
      const int row = qt * kBQ + r;
      const uint4 x = ld_shared16(stage_out + out_offset(r, c, 2 * D));
      if (row < n_q)
        *reinterpret_cast<uint4*>(
            o + ((size_t)(b * n_q + row) * n_heads + h) * D + 8 * c) = x;
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
// past n read as zeros, never the next sequence's rows.
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

template <int D>
cudaError_t opt_in() {
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_q, int n_k, int n_heads, int causal, int window,
           float scale, cudaStream_t stream) {
  static cudaError_t opted = opt_in<D>();   // once, before any capture
  if (opted != cudaSuccess) return (int)opted;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, batch, n_q, n_heads, D);
  if (err == cudaSuccess) err = make_map(&tk, k, batch, n_k, n_heads, D);
  if (err == cudaSuccess) err = make_map(&tv, v, batch, n_k, n_heads, D);
  if (err != cudaSuccess) return (int)err;
  const int per = tiles_per_block(batch, n_q, n_heads);
  const int n_tiles = (n_q + kBQ - 1) / kBQ;
  const dim3 grid((n_tiles + per - 1) / per, n_heads, batch);
  flash_wgmma_kernel<D><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), n_q, n_k, n_heads, causal,
      window, scale * kLog2e, per);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

// C entries for ctypes. Both launch on `stream` and return the launch's
// cudaError_t.
//
// The CUDA-core variant. q (batch, n_q, n_heads, d), k (batch, n_k,
// n_heads, d), v (batch, n_k, n_heads, dv) and o (batch, n_q, n_heads,
// dv) are contiguous device tensors of one dtype: float32 (dtype 0) or
// bfloat16 (dtype 1), 16-byte aligned; 8 <= d, dv <= 128, both
// multiples of 8.
// causal: mask key j > query i; window > 0: mask i - j >= window.
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype,
                                   int batch, int n_q, int n_k, int n_heads,
                                   int d, int dv, int causal, int window,
                                   float scale, void* stream) {
  if (d < 8 || d > kMaxD || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (dv < 8 || dv > kMaxD || dv % 8 != 0) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_q == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, batch, n_q, n_k, n_heads, d, dv,
                           causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, batch, n_q, n_k, n_heads, d,
                                   dv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core variant. q, k, v and o as above with dv = d, bfloat16
// only, d 64 or 128; the rows of q, k and v are addressed through TMA maps, so the
// tensors must be 16-byte aligned.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k,
                                         const void* v, void* o, int batch,
                                         int n_q, int n_k, int n_heads,
                                         int d, int causal, int window,
                                         float scale, void* stream) {
  if (batch == 0 || n_q == 0 || n_heads == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return wg::launch<64>(q, k, v, o, batch, n_q, n_k, n_heads, causal,
                          window, scale, s);
  if (d == 128)
    return wg::launch<128>(q, k, v, o, batch, n_q, n_k, n_heads, causal,
                           window, scale, s);
  return (int)cudaErrorInvalidValue;
}
