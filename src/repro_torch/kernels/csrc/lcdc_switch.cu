// The LC/DC switch datapath for NVIDIA Hopper (sm_90a): one switch tick
// per switch row, and the simulator's two switch tiers in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lcdc_switch.py
// (switch_step -> _kernel). Semantics are those of
// kernels/ref.py::switch_step_ref, per switch row:
//   (1) pick the usable port (stage-enabled, valid, not a draining top
//       port) with the least total backlog, ties to the lowest index;
//   (2) enqueue the K-component arrival there, scaled so the port total
//       stays <= cap; the excess is dropped (everything drops at a
//       switch with no usable port);
//   (3) serve up to serve_rate per active port, split proportionally
//       over the K components;
//   (4) hi/lo watermark triggers on the post-serve backlogs;
//   (5) taps: enq_wait (pick's backlog / serve_rate), occ_m1, occ_m2.
//
// Two entries share that row body (tier_row, templated on the port
// count L and the component count K):
//   * lcdc_switch_step: one thread a row, all 8 outputs, any row count;
//     the public switch_step contract.
//   * lcdc_switch_tiers: what one simulator tick does with both tiers
//     (kernels/ref.py::switch_tiers_ref), one block per scenario: the
//     RSW rows ((R, P, 2) queues, serve rate 1), the served traffic
//     summed over each cluster's racks per plane into the cluster-CSWs'
//     arrivals, the CSW-uplink rows ((NC, CUP) queues, serve rate 4),
//     the CSW-served traffic summed per FC, and the scenario's tier sums
//     added into its accumulators. The phases are separated by
//     __syncthreads(); nothing crosses blocks.
//
// What bounds it on this card: latency, not bytes. A tick moves about
// 0.2 MB at the sim's shapes (10 scenarios x 128 racks x 4 ports x 2
// components), some 60 ns of HBM time, and does a few dozen flops per
// row. So the design spends nothing on coalescing and everything on
// not waiting: one launch a tick instead of two plus ~15 small glue
// kernels; each row's whole state loaded up front (16-byte loads where
// the row allows) so its loads overlap; L known at compile time, so the
// row lives in registers and the pick is a predicated select, never a
// runtime index into a local array (no stack frame); no IEEE division
// where its result is known exactly (the rate's reciprocal comes from
// the host; see tier_row), since each division is a branchy sequence
// the compiler cannot overlap with the next. The two cross-row sums
// that feed state (to_csw, fc_in) run in a fixed serial order, racks
// (CSWs) in index order, as a serial reduction does.
//
// Numerics: the build uses -fmad=false and no fast math, so nothing is
// fused on its own; the two updates the reference's compiled code does
// fuse (the post-serve queue q - q*frac and the sum of squares) are
// explicit __fmaf_rn calls, as the plain version's ref.fma, and every
// division is IEEE. The per-scenario accumulator sums (which feed no
// state) are summed per thread, then over the block in a fixed tree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLinks = 16;       // MAX_FAULT_LINKS: widest link axis
constexpr float kBig = 1e30f;       // masked-out port sentinel (ref.BIG)
constexpr int kStepThreads = 128;
constexpr int kTiersThreads = 256;  // largest switch_tiers block
constexpr int kTierAcc = 9;         // accumulators switch_tiers adds to
constexpr int kTierParts = 10;      // per-thread partial sums

// Every link width the wrappers accept, for the compile-time switches.
#define LCDC_FOR_EACH_LINKS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

__device__ __forceinline__ void from_word(uint32_t w, float& x) {
  x = __uint_as_float(w);
}
__device__ __forceinline__ void from_word(uint32_t w, int32_t& x) {
  x = static_cast<int32_t>(w);
}
__device__ __forceinline__ uint32_t to_word(float x) {
  return __float_as_uint(x);
}

// v[0..N) = p[0..N): 16-byte loads when N is a multiple of 4 and p is
// 16-byte aligned (vec), 4-byte loads otherwise. All loads are issued
// before any value is used.
template <int N, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         T (&v)[N], bool vec) {
  static_assert(sizeof(T) == 4, "32-bit words only");
  if constexpr (N % 4 == 0) {
    if (vec) {
      const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const uint4 w = __ldg(p4 + i);
        from_word(w.x, v[4 * i]);
        from_word(w.y, v[4 * i + 1]);
        from_word(w.z, v[4 * i + 2]);
        from_word(w.w, v[4 * i + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __ldg(p + i);
}

// p[0..N) = v[0..N), with 16-byte stores where load_row would use
// 16-byte loads.
template <int N>
__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[N], bool vec) {
  if constexpr (N % 4 == 0) {
    if (vec) {
      uint4* p4 = reinterpret_cast<uint4*>(p);
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        p4[i] = make_uint4(to_word(v[4 * i]), to_word(v[4 * i + 1]),
                           to_word(v[4 * i + 2]), to_word(v[4 * i + 3]));
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = v[i];
}

// Taps of one switch row besides its queues.
struct RowTaps {
  float drop, wait, m1, m2;
  bool hi_t, lo_t;
};

// The tick of one switch row with L ports and K components, on
// registers. q (port-major, q[l*K + k]) holds the row's queues on entry
// and its post-serve queues on return; served gets the served split.
// inv_rate is the float32 1 / serve_rate. The sums and the tie-break
// follow switch_step_ref's order. The two divisions of the plain
// version are taken only where their value is not known exactly: for
// d > 0, x / d is 0 for x == 0 and 1 for x == d, and a correctly
// rounded x / d is >= 1 for x >= d, so min(1, room / d) is 1 there.
template <int L, int K>
__device__ __forceinline__ RowTaps tier_row(
    float (&q)[L * K], const float (&arr)[K], const bool (&valid)[L],
    int stage, bool drain, float cap, float hi, float lo, float serve_rate,
    float inv_rate, float (&served)[L * K]) {
  bool act[L];
  bool vswitch = false, has_usable = false;
  // (1) min-backlog usable port: a strict '<' scan keeps the lowest
  // index among ties, as cumsum(pick) == 1 does in the plain version
  float mn = kBig;
  int pick = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float tot = q[l * K];
#pragma unroll
    for (int k = 1; k < K; ++k) tot = tot + q[l * K + k];
    vswitch |= valid[l];
    act[l] = (l < stage) && valid[l];
    const bool top = (l == stage - 1) && (stage > 1);
    const bool usable = act[l] && !(drain && top);
    has_usable |= usable;
    const float masked = usable ? tot : kBig;
    if (l == 0 || masked < mn) {
      mn = masked;
      pick = l;
    }
  }
  const float mn0 = has_usable ? mn : 0.0f;

  RowTaps t;
  // (5a) backlog-age of the pick, times the float32 reciprocal of the
  // rate (the reference compiles its division by the static rate so)
  t.wait = (vswitch ? mn0 : 0.0f) * inv_rate;

  // (2) enqueue with capacity clamp, proportional over components; the
  // pick is a predicated select over the unrolled ports
  float add_tot = arr[0];
#pragma unroll
  for (int k = 1; k < K; ++k) add_tot = add_tot + arr[k];
  const float room = has_usable ? fmaxf(cap - mn0, 0.0f) : 0.0f;
  const float add_d = fmaxf(add_tot, 1e-9f);
  float scale = 1.0f;                  // min(1, room / add_d)
  if (room < add_d) scale = room / add_d;
  t.drop = vswitch ? add_tot * (1.0f - scale) : add_tot;
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float enq = q[l * K + k] + arr[k] * scale;
      q[l * K + k] = (l == pick) ? enq : q[l * K + k];
    }
  }

  // (3) serve up to serve_rate per active port; (5b) moments; (4)
  // watermark triggers on the post-serve backlogs
  const float hi_lvl = hi * cap;
  const float lo_lvl = lo * cap;
  float m1 = 0.0f, m2 = 0.0f;  // m2 starts at +0: fma(x, x, 0) == x*x
  bool hi_t = false, lo_t = true;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float tot = q[l * K];
#pragma unroll
    for (int k = 1; k < K; ++k) tot = tot + q[l * K + k];
    const float serve_tot = act[l] ? fminf(tot, serve_rate) : 0.0f;
    const float tot_d = fmaxf(tot, 1e-9f);
    float frac = 0.0f;                 // serve_tot / tot_d
    if (serve_tot == tot_d) {
      frac = 1.0f;
    } else if (serve_tot != 0.0f) {
      frac = serve_tot / tot_d;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float x = q[l * K + k];
      served[l * K + k] = x * frac;
      q[l * K + k] = __fmaf_rn(-x, frac, x);
    }
    const float qpost = tot - serve_tot;
    m1 = (l == 0) ? qpost : m1 + qpost;
    m2 = __fmaf_rn(qpost, qpost, m2);
    if (act[l]) {
      hi_t |= qpost > hi_lvl;
      lo_t &= qpost < lo_lvl;
    }
  }
  t.m1 = vswitch ? m1 : 0.0f;
  t.m2 = vswitch ? m2 : 0.0f;
  t.hi_t = hi_t && vswitch;
  t.lo_t = lo_t && vswitch;
  return t;
}

// ---------------------------------------------------------------------
// switch_step: one thread a row.

struct StepArgs {
  const float* q;          // (n, L, K)
  const int32_t* stage;    // (n,)
  const float* arr;        // (n, K)
  const uint8_t* drain;    // (n,)
  const uint8_t* valid;    // (n, L)
  const float* cap;        // (n,)
  const float* hi;         // (n,)
  const float* lo;         // (n,)
  float serve_rate, inv_rate;
  int n_rows;
  bool vec;                // q, q_out, served_out 16-byte aligned
  float* q_out;            // (n, L, K)
  float* served_out;       // (n, L, K)
  int32_t* hi_out;         // (n,)
  int32_t* lo_out;         // (n,)
  float* drop_out;         // (n,)
  float* wait_out;         // (n,)
  float* m1_out;           // (n,)
  float* m2_out;           // (n,)
};

template <int L, int K>
__global__ void __launch_bounds__(kStepThreads)
switch_step_kernel(const StepArgs a) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.n_rows) return;
  const size_t r = static_cast<size_t>(row);
  float q[L * K];
  load_row<L * K>(a.q + r * (L * K), q, a.vec);
  float arr[K];
#pragma unroll
  for (int k = 0; k < K; ++k) arr[k] = __ldg(a.arr + r * K + k);
  bool valid[L];
#pragma unroll
  for (int l = 0; l < L; ++l) valid[l] = __ldg(a.valid + r * L + l) != 0;
  const int stage = __ldg(a.stage + r);
  const bool drain = __ldg(a.drain + r) != 0;
  const float cap = __ldg(a.cap + r);
  const float hi = __ldg(a.hi + r);
  const float lo = __ldg(a.lo + r);

  float served[L * K];
  const RowTaps t = tier_row<L, K>(q, arr, valid, stage, drain, cap, hi,
                                   lo, a.serve_rate, a.inv_rate, served);
  store_row<L * K>(a.q_out + r * (L * K), q, a.vec);
  store_row<L * K>(a.served_out + r * (L * K), served, a.vec);
  a.hi_out[r] = t.hi_t ? 1 : 0;
  a.lo_out[r] = t.lo_t ? 1 : 0;
  a.drop_out[r] = t.drop;
  a.wait_out[r] = t.wait;
  a.m1_out[r] = t.m1;
  a.m2_out[r] = t.m2;
}

template <int K>
cudaError_t launch_step(const StepArgs& a, int n_links, cudaStream_t s) {
  const int blocks = (a.n_rows + kStepThreads - 1) / kStepThreads;
  switch (n_links) {
#define LCDC_STEP_CASE(N) \
    case N: switch_step_kernel<N, K><<<blocks, kStepThreads, 0, s>>>(a); break;
    LCDC_FOR_EACH_LINKS(LCDC_STEP_CASE)
#undef LCDC_STEP_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// switch_tiers: one block per scenario.

struct TiersArgs {
  // RSW tier: (B, R, P, 2) queues; arrivals (B*R, 2) rows arr_stride
  // floats apart; a link is valid iff its rack is and its fault timer
  // is 0
  const float* rsw_q;
  const int32_t* rsw_stage;    // (B, R)
  const uint8_t* rsw_drain;    // (B, R)
  const int32_t* rsw_timer;    // (B, R, P)
  const uint8_t* rack_valid;   // (B, R)
  const float* rsw_arr;
  int arr_stride;
  // CSW-uplink tier: (B, NC, CUP) queues
  const float* csw_q;
  const int32_t* csw_stage;    // (B, NC)
  const uint8_t* csw_drain;    // (B, NC)
  const int32_t* csw_timer;    // (B, NC, CUP)
  const uint8_t* csw_valid;    // (B, NC)
  const float* cap;            // (B,)
  float rsw_rate, csw_rate;
  float rsw_inv, csw_inv;      // float32 1 / rate
  int R, P, NCL, RPC, NC, CUP;
  bool vec;                    // queues and timers 16-byte aligned
  const float* acc_in[kTierAcc];  // (B,) each
  float* rsw_q_out;            // (B, R, P, 2)
  float* rsw_wait;             // (B, R)
  float* to_csw;               // (B, NCL, P, 2)
  float* csw_q_out;            // (B, NC, CUP)
  float* csw_wait;             // (B, NC)
  float* fc_in;                // (B, CUP)
  float* acc_out[kTierAcc];    // (B,) each
};

// One RSW row (rack r of its scenario, global row `row`): its tick, its
// served split into shared memory, its tier sums into part[0..5).
template <int L>
__device__ __forceinline__ void rsw_row(const TiersArgs& a, size_t row,
                                        int r, float cap, float* served_s,
                                        float (&part)[kTierParts]) {
  constexpr int K = 2;
  float q[L * K];
  int32_t timer[L];
  load_row<L * K>(a.rsw_q + row * (L * K), q, a.vec);
  load_row<L>(a.rsw_timer + row * L, timer, a.vec);
  const float* ap = a.rsw_arr + row * a.arr_stride;
  const float arr[K] = {__ldg(ap), __ldg(ap + 1)};
  const int stage = __ldg(a.rsw_stage + row);
  const bool drain = __ldg(a.rsw_drain + row) != 0;
  const bool rack = __ldg(a.rack_valid + row) != 0;
  bool valid[L];
#pragma unroll
  for (int l = 0; l < L; ++l) valid[l] = rack && timer[l] == 0;

  float served[L * K];
  const RowTaps t = tier_row<L, K>(q, arr, valid, stage, drain, cap, 0.0f,
                                   0.0f, a.rsw_rate, a.rsw_inv, served);
  store_row<L * K>(a.rsw_q_out + row * (L * K), q, a.vec);
  a.rsw_wait[row] = t.wait;
  float qs = q[0], ss = served[0];
#pragma unroll
  for (int i = 1; i < L * K; ++i) {
    qs = qs + q[i];
    ss = ss + served[i];
  }
#pragma unroll
  for (int i = 0; i < L * K; ++i) served_s[r * (L * K) + i] = served[i];
  part[0] += t.drop;
  part[1] += qs;
  part[2] += ss;
  part[3] += t.m1;
  part[4] += t.m2;
}

// One CSW-uplink row (CSW c of its scenario, global row `row`) with its
// arrival `inter`: its tick, its served packets into shared memory, its
// tier sums into part[5..10).
template <int L>
__device__ __forceinline__ void csw_row(const TiersArgs& a, size_t row,
                                        int c, float cap, float inter,
                                        float* cserve_s,
                                        float (&part)[kTierParts]) {
  float q[L];
  int32_t timer[L];
  load_row<L>(a.csw_q + row * L, q, a.vec);
  load_row<L>(a.csw_timer + row * L, timer, a.vec);
  const int stage = __ldg(a.csw_stage + row);
  const bool drain = __ldg(a.csw_drain + row) != 0;
  const bool sw = __ldg(a.csw_valid + row) != 0;
  bool valid[L];
#pragma unroll
  for (int l = 0; l < L; ++l) valid[l] = sw && timer[l] == 0;
  float qin = q[0];
#pragma unroll
  for (int l = 1; l < L; ++l) qin = qin + q[l];
  const float arr[1] = {inter};

  float served[L];
  const RowTaps t = tier_row<L, 1>(q, arr, valid, stage, drain, cap, 0.0f,
                                   0.0f, a.csw_rate, a.csw_inv, served);
  store_row<L>(a.csw_q_out + row * L, q, a.vec);
  a.csw_wait[row] = t.wait;
  float ss = served[0];
#pragma unroll
  for (int l = 1; l < L; ++l) ss = ss + served[l];
#pragma unroll
  for (int l = 0; l < L; ++l) cserve_s[c * L + l] = served[l];
  part[5] += t.drop;
  part[6] += qin;
  part[7] += ss;
  part[8] += t.m1;
  part[9] += t.m2;
}

__global__ void __launch_bounds__(kTiersThreads)
switch_tiers_kernel(const TiersArgs a) {
  extern __shared__ float smem[];
  __shared__ float red[kTiersThreads / 32][kTierParts];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int R = a.R, P = a.P, NC = a.NC, CUP = a.CUP;
  float* served_s = smem;                   // (R, P, 2) RSW served
  float* cserve_s = served_s + R * P * 2;   // (NC, CUP) CSW served
  float* inter_s = cserve_s + NC * CUP;     // (NC,) CSW arrivals
  const float cap = __ldg(a.cap + b);

  float part[kTierParts];
#pragma unroll
  for (int i = 0; i < kTierParts; ++i) part[i] = 0.0f;

  // 1. the RSW rows (serve rate 1)
  for (int r = tid; r < R; r += nt) {
    const size_t row = static_cast<size_t>(b) * R + r;
    switch (P) {
#define LCDC_RSW_CASE(N) \
      case N: rsw_row<N>(a, row, r, cap, served_s, part); break;
      LCDC_FOR_EACH_LINKS(LCDC_RSW_CASE)
#undef LCDC_RSW_CASE
    }
  }
  __syncthreads();

  // 2. served traffic per (cluster, plane, component): uplink p of rack
  // r lands on CSW (cluster(r), p). Racks summed in index order.
  const int n_sums = a.NCL * P * 2;
  const int rack_stride = P * 2;
  for (int i = tid; i < n_sums; i += nt) {
    const int cl = i / rack_stride;
    const int pk = i - cl * rack_stride;
    const float* src = served_s + cl * a.RPC * rack_stride + pk;
    float s = src[0];
#pragma unroll 8
    for (int rr = 1; rr < a.RPC; ++rr) s = s + src[rr * rack_stride];
    a.to_csw[static_cast<size_t>(b) * n_sums + i] = s;
    if (pk & 1) inter_s[cl * P + (pk >> 1)] = s;   // inter component
  }
  __syncthreads();

  // 3. the CSW-uplink rows (serve rate 4), fed the inter sums
  for (int c = tid; c < NC; c += nt) {
    const size_t row = static_cast<size_t>(b) * NC + c;
    switch (CUP) {
#define LCDC_CSW_CASE(N) \
      case N: csw_row<N>(a, row, c, cap, inter_s[c], cserve_s, part); break;
      LCDC_FOR_EACH_LINKS(LCDC_CSW_CASE)
#undef LCDC_CSW_CASE
    }
  }
  __syncthreads();

  // 4. CSW-served traffic per FC: uplink f of every CSW lands on FC f.
  // CSWs summed in index order.
  for (int f = tid; f < CUP; f += nt) {
    float s = cserve_s[f];
    for (int c = 1; c < NC; ++c) s = s + cserve_s[c * CUP + f];
    a.fc_in[static_cast<size_t>(b) * CUP + f] = s;
  }

  // 5. the scenario's tier sums: warps, then the block's warps in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kTierParts; ++i) {
    float v = part[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float s[kTierParts];
#pragma unroll
    for (int i = 0; i < kTierParts; ++i) {
      s[i] = red[0][i];
      for (int w = 1; w < nt / 32; ++w) s[i] = s[i] + red[w][i];
    }
    float in[kTierAcc];
#pragma unroll
    for (int i = 0; i < kTierAcc; ++i) in[i] = __ldg(a.acc_in[i] + b);
    // the tick's order of adds: drops gets the RSW sum, then the CSW's
    a.acc_out[0][b] = (in[0] + s[0]) + s[5];   // drops
    a.acc_out[1][b] = in[1] + (s[1] + s[2]);   // rsw_backlog
    a.acc_out[2][b] = in[2] + s[2];            // rsw_served
    a.acc_out[3][b] = in[3] + s[3];            // rsw_occ_m1
    a.acc_out[4][b] = in[4] + s[4];            // rsw_occ_m2
    a.acc_out[5][b] = in[5] + s[6];            // csw_up_backlog
    a.acc_out[6][b] = in[6] + s[7];            // csw_up_served
    a.acc_out[7][b] = in[7] + s[8];            // csw_occ_m1
    a.acc_out[8][b] = in[8] + s[9];            // csw_occ_m2
  }
}

}  // namespace

// C entries for ctypes. All pointers are device pointers; `stream` is a
// cudaStream_t. Each launches on `stream` and returns the launch's
// cudaError_t (cudaErrorInvalidValue for shapes the kernels do not
// take).

// One switch tick for n rows: q (n, L, K) f32, stage (n,) i32, arrivals
// (n, K) f32, drain (n,) u8, valid (n, L) u8, cap/hi/lo (n,) f32, all
// contiguous; outputs q and served (n, L, K) f32, hi/lo (n,) i32,
// dropped/enq_wait/occ_m1/occ_m2 (n,) f32.
extern "C" int lcdc_switch_step(
    const float* q, const int32_t* stage, const float* arrivals,
    const uint8_t* drain, const uint8_t* valid, const float* cap,
    const float* hi, const float* lo, float serve_rate, int n_rows,
    int n_links, int n_comp, float* q_out, float* served_out,
    int32_t* hi_out, int32_t* lo_out, float* drop_out, float* wait_out,
    float* m1_out, float* m2_out, void* stream) {
  if (n_links < 1 || n_links > kMaxLinks) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(q_out) |
                     reinterpret_cast<uintptr_t>(served_out)) & 15) == 0;
  // the reciprocal the reference compiles its division by the rate to,
  // rounded once (IEEE float division on the host)
  const float inv_rate = 1.0f / serve_rate;
  const StepArgs a{q, stage, arrivals, drain, valid, cap, hi, lo,
                   serve_rate, inv_rate, n_rows, vec, q_out, served_out,
                   hi_out, lo_out, drop_out, wait_out, m1_out, m2_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_comp == 1) return (int)launch_step<1>(a, n_links, s);
  if (n_comp == 2) return (int)launch_step<2>(a, n_links, s);
  return (int)cudaErrorInvalidValue;
}

// Both switch tiers of one simulator tick for B scenarios on a hull of
// n_clusters x racks_per_cluster racks, `planes` (= CSWs per cluster =
// RSW uplinks) and csw_uplinks (CSW-uplink ports): inputs as in
// TiersArgs (acc_in: 9 (B,) f32 pointers, TIER_ACC order), outputs
// rsw_q (B, R, P, 2), rsw_wait (B, R), to_csw (B, NCL, P, 2), csw_q
// (B, NC, CUP), csw_wait (B, NC), fc_in (B, CUP) and 9 (B,) f32
// accumulators (acc_out).
extern "C" int lcdc_switch_tiers(
    const float* rsw_q, const int32_t* rsw_stage, const uint8_t* rsw_drain,
    const int32_t* rsw_timer, const uint8_t* rack_valid,
    const float* rsw_arr, int arr_stride, const float* csw_q,
    const int32_t* csw_stage, const uint8_t* csw_drain,
    const int32_t* csw_timer, const uint8_t* csw_valid, const float* cap,
    const float* const* acc_in, float rsw_rate, float csw_rate, int B,
    int n_clusters, int racks_per_cluster, int planes, int csw_uplinks,
    float* rsw_q_out, float* rsw_wait, float* to_csw, float* csw_q_out,
    float* csw_wait, float* fc_in, float* const* acc_out, void* stream) {
  if (planes < 1 || planes > kMaxLinks || csw_uplinks < 1 ||
      csw_uplinks > kMaxLinks || n_clusters < 1 || racks_per_cluster < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  TiersArgs a{};
  a.rsw_q = rsw_q;
  a.rsw_stage = rsw_stage;
  a.rsw_drain = rsw_drain;
  a.rsw_timer = rsw_timer;
  a.rack_valid = rack_valid;
  a.rsw_arr = rsw_arr;
  a.arr_stride = arr_stride;
  a.csw_q = csw_q;
  a.csw_stage = csw_stage;
  a.csw_drain = csw_drain;
  a.csw_timer = csw_timer;
  a.csw_valid = csw_valid;
  a.cap = cap;
  a.rsw_rate = rsw_rate;
  a.csw_rate = csw_rate;
  a.rsw_inv = 1.0f / rsw_rate;
  a.csw_inv = 1.0f / csw_rate;
  a.NCL = n_clusters;
  a.RPC = racks_per_cluster;
  a.P = planes;
  a.CUP = csw_uplinks;
  a.R = n_clusters * racks_per_cluster;
  a.NC = n_clusters * planes;
  a.vec = ((reinterpret_cast<uintptr_t>(rsw_q) |
            reinterpret_cast<uintptr_t>(rsw_timer) |
            reinterpret_cast<uintptr_t>(csw_q) |
            reinterpret_cast<uintptr_t>(csw_timer) |
            reinterpret_cast<uintptr_t>(rsw_q_out) |
            reinterpret_cast<uintptr_t>(csw_q_out)) & 15) == 0;
  for (int i = 0; i < kTierAcc; ++i) {
    a.acc_in[i] = acc_in[i];
    a.acc_out[i] = acc_out[i];
  }
  a.rsw_q_out = rsw_q_out;
  a.rsw_wait = rsw_wait;
  a.to_csw = to_csw;
  a.csw_q_out = csw_q_out;
  a.csw_wait = csw_wait;
  a.fc_in = fc_in;

  // a warp for every 32 rows of the wider tier, at most kTiersThreads
  int rows = a.R > a.NC ? a.R : a.NC;
  int threads = ((rows + 31) / 32) * 32;
  if (threads > kTiersThreads) threads = kTiersThreads;
  // dynamic shared memory: the RSW served split, the CSW served
  // packets and the CSW arrivals
  const long long smem = 4LL * ((long long)a.R * a.P * 2 +
                                (long long)a.NC * a.CUP + a.NC);
  if (smem > 48 * 1024) {   // beyond the default; the launch checks the rest
    const cudaError_t e = cudaFuncSetAttribute(
        switch_tiers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch_tiers_kernel<<<B, threads, (size_t)smem, s>>>(a);
  return (int)cudaGetLastError();
}
