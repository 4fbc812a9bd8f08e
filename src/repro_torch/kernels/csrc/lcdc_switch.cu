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
// Two entries share that row body (tier_row, templated on the float
// type T, the arrivals' type A, the port count L and the component count
// K), each built for float and for double (the x64 mode, entries with
// an _f64 suffix):
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
// explicit fused multiply-adds (__fmaf_rn, __fma_rn in double), as the
// plain version's ref.fma, and every division is IEEE. The per-scenario
// accumulator sums (which feed no state) are summed per thread, then
// over the block in a fixed tree.
//
// The double instantiation follows the reference's types under x64, as
// its tick hands them to the datapath: float64 queues, served packets,
// taps and accumulators; the RSW arrivals stay float32 (the tick's
// packet counts; their sum over the two components is a float32 sum,
// widened where it meets the float64 queues) and the CSW arrivals are
// float64 (the RSW tier's served sums); the per-scenario cap is a
// float32 knob widened where it meets a queue, and hi * cap a float32
// product, as the reference computes them. The same body serves both
// types: T(x) widens, tmin/tmax/fma_rn pick the type's intrinsic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLinks = 16;       // MAX_FAULT_LINKS: widest link axis
constexpr double kBig = 1e30;       // masked-out port sentinel (ref.BIG)
constexpr int kStepThreads = 128;
constexpr int kTiersThreads = 256;  // largest switch_tiers block
constexpr int kTierAcc = 9;         // accumulators switch_tiers adds to
constexpr int kTierParts = 10;      // per-thread partial sums

// Every link width the wrappers accept, for the compile-time switches.
#define LCDC_FOR_EACH_LINKS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// The float type's min, max and fused multiply-add (one rounding).
__device__ __forceinline__ float tmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double tmin(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double tmax(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ void from_word(uint32_t w, float& x) {
  x = __uint_as_float(w);
}
__device__ __forceinline__ void from_word(uint32_t w, int32_t& x) {
  x = static_cast<int32_t>(w);
}
__device__ __forceinline__ uint32_t to_word(float x) {
  return __float_as_uint(x);
}

// v[0..N) = p[0..N): 16-byte loads when p is 16-byte aligned (vec) and
// N is a multiple of 4 32-bit words (2 doubles), narrower loads
// otherwise. All loads are issued before any value is used.
template <int N, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         T (&v)[N], bool vec) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "32- or 64-bit words");
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
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
  if constexpr (sizeof(T) == 8 && N % 2 == 0) {
    if (vec) {
      const double2* p2 = reinterpret_cast<const double2*>(p);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const double2 w = __ldg(p2 + i);
        v[2 * i] = w.x;
        v[2 * i + 1] = w.y;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = __ldg(p + i);
}

// p[0..N) = v[0..N), with 16-byte stores where load_row would use
// 16-byte loads.
template <int N, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ p,
                                          const T (&v)[N], bool vec) {
  if constexpr (sizeof(T) == 4 && N % 4 == 0) {
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
  if constexpr (sizeof(T) == 8 && N % 2 == 0) {
    if (vec) {
      double2* p2 = reinterpret_cast<double2*>(p);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) p2[i] = make_double2(v[2 * i],
                                                           v[2 * i + 1]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = v[i];
}

// Taps of one switch row besides its queues.
template <typename T>
struct RowTaps {
  T drop, wait, m1, m2;
  bool hi_t, lo_t;
};

// The tick of one switch row with L ports and K components, on
// registers. q (port-major, q[l*K + k]) holds the row's queues on entry
// and its post-serve queues on return; served gets the served split.
// The arrivals arr are of type A (their sum over components is taken in
// A); cap, hi and lo are float32 knobs. inv_rate is 1 / serve_rate in
// T. The sums and the tie-break follow switch_step_ref's order. The two
// divisions of the plain version are taken only where their value is
// not known exactly: for d > 0, x / d is 0 for x == 0 and 1 for x == d,
// and a correctly rounded x / d is >= 1 for x >= d, so min(1, room / d)
// is 1 there.
template <typename T, typename A, int L, int K>
__device__ __forceinline__ RowTaps<T> tier_row(
    T (&q)[L * K], const A (&arr)[K], const bool (&valid)[L], int stage,
    bool drain, float cap, float hi, float lo, T serve_rate, T inv_rate,
    T (&served)[L * K]) {
  bool act[L];
  bool vswitch = false, has_usable = false;
  // (1) min-backlog usable port: a strict '<' scan keeps the lowest
  // index among ties, as cumsum(pick) == 1 does in the plain version
  T mn = T(kBig);
  int pick = 0;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    T tot = q[l * K];
#pragma unroll
    for (int k = 1; k < K; ++k) tot = tot + q[l * K + k];
    vswitch |= valid[l];
    act[l] = (l < stage) && valid[l];
    const bool top = (l == stage - 1) && (stage > 1);
    const bool usable = act[l] && !(drain && top);
    has_usable |= usable;
    const T masked = usable ? tot : T(kBig);
    if (l == 0 || masked < mn) {
      mn = masked;
      pick = l;
    }
  }
  const T mn0 = has_usable ? mn : T(0);

  RowTaps<T> t;
  // (5a) backlog-age of the pick, times the reciprocal of the rate (the
  // reference compiles its division by the static rate so)
  t.wait = (vswitch ? mn0 : T(0)) * inv_rate;

  // (2) enqueue with capacity clamp, proportional over components; the
  // pick is a predicated select over the unrolled ports
  A add_tot = arr[0];
#pragma unroll
  for (int k = 1; k < K; ++k) add_tot = add_tot + arr[k];
  const T room = has_usable ? tmax(T(cap) - mn0, T(0)) : T(0);
  const T add_d = T(tmax(add_tot, A(1e-9)));
  T scale = T(1);                      // min(1, room / add_d)
  if (room < add_d) scale = room / add_d;
  t.drop = vswitch ? T(add_tot) * (T(1) - scale) : T(add_tot);
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T enq = q[l * K + k] + T(arr[k]) * scale;
      q[l * K + k] = (l == pick) ? enq : q[l * K + k];
    }
  }

  // (3) serve up to serve_rate per active port; (5b) moments; (4)
  // watermark triggers on the post-serve backlogs
  const T hi_lvl = T(hi * cap);
  const T lo_lvl = T(lo * cap);
  T m1 = T(0), m2 = T(0);  // m2 starts at +0: fma(x, x, 0) == x*x
  bool hi_t = false, lo_t = true;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    T tot = q[l * K];
#pragma unroll
    for (int k = 1; k < K; ++k) tot = tot + q[l * K + k];
    const T serve_tot = act[l] ? tmin(tot, serve_rate) : T(0);
    const T tot_d = tmax(tot, T(1e-9));
    T frac = T(0);                     // serve_tot / tot_d
    if (serve_tot == tot_d) {
      frac = T(1);
    } else if (serve_tot != T(0)) {
      frac = serve_tot / tot_d;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T x = q[l * K + k];
      served[l * K + k] = x * frac;
      q[l * K + k] = fma_rn(-x, frac, x);
    }
    const T qpost = tot - serve_tot;
    m1 = (l == 0) ? qpost : m1 + qpost;
    m2 = fma_rn(qpost, qpost, m2);
    if (act[l]) {
      hi_t |= qpost > hi_lvl;
      lo_t &= qpost < lo_lvl;
    }
  }
  t.m1 = vswitch ? m1 : T(0);
  t.m2 = vswitch ? m2 : T(0);
  t.hi_t = hi_t && vswitch;
  t.lo_t = lo_t && vswitch;
  return t;
}

// ---------------------------------------------------------------------
// switch_step: one thread a row.

template <typename T>
struct StepArgs {
  const T* q;              // (n, L, K)
  const int32_t* stage;    // (n,)
  const T* arr;            // (n, K)
  const uint8_t* drain;    // (n,)
  const uint8_t* valid;    // (n, L)
  const float* cap;        // (n,)
  const float* hi;         // (n,)
  const float* lo;         // (n,)
  T serve_rate, inv_rate;
  int n_rows;
  bool vec;                // q, q_out, served_out 16-byte aligned
  T* q_out;                // (n, L, K)
  T* served_out;           // (n, L, K)
  int32_t* hi_out;         // (n,)
  int32_t* lo_out;         // (n,)
  T* drop_out;             // (n,)
  T* wait_out;             // (n,)
  T* m1_out;               // (n,)
  T* m2_out;               // (n,)
};

template <typename T, int L, int K>
__global__ void __launch_bounds__(kStepThreads)
switch_step_kernel(const StepArgs<T> a) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.n_rows) return;
  const size_t r = static_cast<size_t>(row);
  T q[L * K];
  load_row<L * K>(a.q + r * (L * K), q, a.vec);
  T arr[K];
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

  T served[L * K];
  const RowTaps<T> t = tier_row<T, T, L, K>(q, arr, valid, stage, drain,
                                            cap, hi, lo, a.serve_rate,
                                            a.inv_rate, served);
  store_row<L * K>(a.q_out + r * (L * K), q, a.vec);
  store_row<L * K>(a.served_out + r * (L * K), served, a.vec);
  a.hi_out[r] = t.hi_t ? 1 : 0;
  a.lo_out[r] = t.lo_t ? 1 : 0;
  a.drop_out[r] = t.drop;
  a.wait_out[r] = t.wait;
  a.m1_out[r] = t.m1;
  a.m2_out[r] = t.m2;
}

template <typename T, int K>
cudaError_t launch_step(const StepArgs<T>& a, int n_links, cudaStream_t s) {
  const int blocks = (a.n_rows + kStepThreads - 1) / kStepThreads;
  switch (n_links) {
#define LCDC_STEP_CASE(N) \
    case N: switch_step_kernel<T, N, K><<<blocks, kStepThreads, 0, s>>>(a); \
      break;
    LCDC_FOR_EACH_LINKS(LCDC_STEP_CASE)
#undef LCDC_STEP_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// One switch tick for n rows in T (the C entries below).
template <typename T>
int step_entry(const T* q, const int32_t* stage, const T* arrivals,
               const uint8_t* drain, const uint8_t* valid, const float* cap,
               const float* hi, const float* lo, T serve_rate, int n_rows,
               int n_links, int n_comp, T* q_out, T* served_out,
               int32_t* hi_out, int32_t* lo_out, T* drop_out, T* wait_out,
               T* m1_out, T* m2_out, void* stream) {
  if (n_links < 1 || n_links > kMaxLinks) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(q_out) |
                     reinterpret_cast<uintptr_t>(served_out)) & 15) == 0;
  // the reciprocal the reference compiles its division by the rate to,
  // rounded once (IEEE division on the host)
  const T inv_rate = T(1) / serve_rate;
  const StepArgs<T> a{q, stage, arrivals, drain, valid, cap, hi, lo,
                      serve_rate, inv_rate, n_rows, vec, q_out, served_out,
                      hi_out, lo_out, drop_out, wait_out, m1_out, m2_out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_comp == 1) return (int)launch_step<T, 1>(a, n_links, s);
  if (n_comp == 2) return (int)launch_step<T, 2>(a, n_links, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// switch_tiers: one block per scenario.

template <typename T>
struct TiersArgs {
  // RSW tier: (B, R, P, 2) queues; float32 arrivals (B*R, 2) rows
  // arr_stride floats apart; a link is valid iff its rack is and its
  // fault timer is 0
  const T* rsw_q;
  const int32_t* rsw_stage;    // (B, R)
  const uint8_t* rsw_drain;    // (B, R)
  const int32_t* rsw_timer;    // (B, R, P)
  const uint8_t* rack_valid;   // (B, R)
  const float* rsw_arr;
  int arr_stride;
  // CSW-uplink tier: (B, NC, CUP) queues
  const T* csw_q;
  const int32_t* csw_stage;    // (B, NC)
  const uint8_t* csw_drain;    // (B, NC)
  const int32_t* csw_timer;    // (B, NC, CUP)
  const uint8_t* csw_valid;    // (B, NC)
  const float* cap;            // (B,)
  T rsw_rate, csw_rate;
  T rsw_inv, csw_inv;          // 1 / rate in T
  int R, P, NCL, RPC, NC, CUP;
  bool vec;                    // queues and timers 16-byte aligned
  const T* acc_in[kTierAcc];   // (B,) each
  T* rsw_q_out;                // (B, R, P, 2)
  T* rsw_wait;                 // (B, R)
  T* to_csw;                   // (B, NCL, P, 2)
  T* csw_q_out;                // (B, NC, CUP)
  T* csw_wait;                 // (B, NC)
  T* fc_in;                    // (B, CUP)
  T* acc_out[kTierAcc];        // (B,) each
};

// One RSW row (rack r of its scenario, global row `row`): its tick, its
// served split into shared memory, its tier sums into part[0..5).
template <typename T, int L>
__device__ __forceinline__ void rsw_row(const TiersArgs<T>& a, size_t row,
                                        int r, float cap, T* served_s,
                                        T (&part)[kTierParts]) {
  constexpr int K = 2;
  T q[L * K];
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

  T served[L * K];
  const RowTaps<T> t = tier_row<T, float, L, K>(
      q, arr, valid, stage, drain, cap, 0.0f, 0.0f, a.rsw_rate, a.rsw_inv,
      served);
  store_row<L * K>(a.rsw_q_out + row * (L * K), q, a.vec);
  a.rsw_wait[row] = t.wait;
  T qs = q[0], ss = served[0];
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
template <typename T, int L>
__device__ __forceinline__ void csw_row(const TiersArgs<T>& a, size_t row,
                                        int c, float cap, T inter,
                                        T* cserve_s, T (&part)[kTierParts]) {
  T q[L];
  int32_t timer[L];
  load_row<L>(a.csw_q + row * L, q, a.vec);
  load_row<L>(a.csw_timer + row * L, timer, a.vec);
  const int stage = __ldg(a.csw_stage + row);
  const bool drain = __ldg(a.csw_drain + row) != 0;
  const bool sw = __ldg(a.csw_valid + row) != 0;
  bool valid[L];
#pragma unroll
  for (int l = 0; l < L; ++l) valid[l] = sw && timer[l] == 0;
  T qin = q[0];
#pragma unroll
  for (int l = 1; l < L; ++l) qin = qin + q[l];
  const T arr[1] = {inter};

  T served[L];
  const RowTaps<T> t = tier_row<T, T, L, 1>(
      q, arr, valid, stage, drain, cap, 0.0f, 0.0f, a.csw_rate, a.csw_inv,
      served);
  store_row<L>(a.csw_q_out + row * L, q, a.vec);
  a.csw_wait[row] = t.wait;
  T ss = served[0];
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

template <typename T>
__global__ void __launch_bounds__(kTiersThreads)
switch_tiers_kernel(const TiersArgs<T> a) {
  // one dynamic buffer for both instantiations, typed here
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kTiersThreads / 32][kTierParts];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int R = a.R, P = a.P, NC = a.NC, CUP = a.CUP;
  T* served_s = smem;                       // (R, P, 2) RSW served
  T* cserve_s = served_s + R * P * 2;       // (NC, CUP) CSW served
  T* inter_s = cserve_s + NC * CUP;         // (NC,) CSW arrivals
  const float cap = __ldg(a.cap + b);

  T part[kTierParts];
#pragma unroll
  for (int i = 0; i < kTierParts; ++i) part[i] = T(0);

  // 1. the RSW rows (serve rate 1)
  for (int r = tid; r < R; r += nt) {
    const size_t row = static_cast<size_t>(b) * R + r;
    switch (P) {
#define LCDC_RSW_CASE(N) \
      case N: rsw_row<T, N>(a, row, r, cap, served_s, part); break;
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
    const T* src = served_s + cl * a.RPC * rack_stride + pk;
    T s = src[0];
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
      case N: csw_row<T, N>(a, row, c, cap, inter_s[c], cserve_s, part); \
        break;
      LCDC_FOR_EACH_LINKS(LCDC_CSW_CASE)
#undef LCDC_CSW_CASE
    }
  }
  __syncthreads();

  // 4. CSW-served traffic per FC: uplink f of every CSW lands on FC f.
  // CSWs summed in index order.
  for (int f = tid; f < CUP; f += nt) {
    T s = cserve_s[f];
    for (int c = 1; c < NC; ++c) s = s + cserve_s[c * CUP + f];
    a.fc_in[static_cast<size_t>(b) * CUP + f] = s;
  }

  // 5. the scenario's tier sums: warps, then the block's warps in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kTierParts; ++i) {
    T v = part[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = v + __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][i] = v;
  }
  __syncthreads();
  if (tid == 0) {
    T s[kTierParts];
#pragma unroll
    for (int i = 0; i < kTierParts; ++i) {
      s[i] = red[0][i];
      for (int w = 1; w < nt / 32; ++w) s[i] = s[i] + red[w][i];
    }
    T in[kTierAcc];
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

// Both switch tiers of one simulator tick in T (the C entries below).
template <typename T>
int tiers_entry(const T* rsw_q, const int32_t* rsw_stage,
                const uint8_t* rsw_drain, const int32_t* rsw_timer,
                const uint8_t* rack_valid, const float* rsw_arr,
                int arr_stride, const T* csw_q, const int32_t* csw_stage,
                const uint8_t* csw_drain, const int32_t* csw_timer,
                const uint8_t* csw_valid, const float* cap,
                const T* const* acc_in, T rsw_rate, T csw_rate, int B,
                int n_clusters, int racks_per_cluster, int planes,
                int csw_uplinks, T* rsw_q_out, T* rsw_wait, T* to_csw,
                T* csw_q_out, T* csw_wait, T* fc_in, T* const* acc_out,
                void* stream) {
  if (planes < 1 || planes > kMaxLinks || csw_uplinks < 1 ||
      csw_uplinks > kMaxLinks || n_clusters < 1 || racks_per_cluster < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  TiersArgs<T> a{};
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
  a.rsw_inv = T(1) / rsw_rate;
  a.csw_inv = T(1) / csw_rate;
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
  const long long smem = (long long)sizeof(T) *
      ((long long)a.R * a.P * 2 + (long long)a.NC * a.CUP + a.NC);
  if (smem > 48 * 1024) {   // beyond the default; the launch checks the rest
    const cudaError_t e = cudaFuncSetAttribute(
        switch_tiers_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch_tiers_kernel<T><<<B, threads, (size_t)smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes. All pointers are device pointers; `stream` is a
// cudaStream_t. Each launches on `stream` and returns the launch's
// cudaError_t (cudaErrorInvalidValue for shapes the kernels do not
// take). The _f64 entries are the same with double where the float32
// entries have float, but for the float32 knobs (cap, hi, lo) and the
// float32 RSW arrivals of switch_tiers.

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
  return step_entry<float>(q, stage, arrivals, drain, valid, cap, hi, lo,
                           serve_rate, n_rows, n_links, n_comp, q_out,
                           served_out, hi_out, lo_out, drop_out, wait_out,
                           m1_out, m2_out, stream);
}

// lcdc_switch_step in float64: q, arrivals and the float outputs f64.
extern "C" int lcdc_switch_step_f64(
    const double* q, const int32_t* stage, const double* arrivals,
    const uint8_t* drain, const uint8_t* valid, const float* cap,
    const float* hi, const float* lo, double serve_rate, int n_rows,
    int n_links, int n_comp, double* q_out, double* served_out,
    int32_t* hi_out, int32_t* lo_out, double* drop_out, double* wait_out,
    double* m1_out, double* m2_out, void* stream) {
  return step_entry<double>(q, stage, arrivals, drain, valid, cap, hi, lo,
                            serve_rate, n_rows, n_links, n_comp, q_out,
                            served_out, hi_out, lo_out, drop_out, wait_out,
                            m1_out, m2_out, stream);
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
  return tiers_entry<float>(
      rsw_q, rsw_stage, rsw_drain, rsw_timer, rack_valid, rsw_arr,
      arr_stride, csw_q, csw_stage, csw_drain, csw_timer, csw_valid, cap,
      acc_in, rsw_rate, csw_rate, B, n_clusters, racks_per_cluster, planes,
      csw_uplinks, rsw_q_out, rsw_wait, to_csw, csw_q_out, csw_wait, fc_in,
      acc_out, stream);
}

// lcdc_switch_tiers in float64: the queues, accumulators and outputs
// f64; the RSW arrivals and cap stay f32.
extern "C" int lcdc_switch_tiers_f64(
    const double* rsw_q, const int32_t* rsw_stage, const uint8_t* rsw_drain,
    const int32_t* rsw_timer, const uint8_t* rack_valid,
    const float* rsw_arr, int arr_stride, const double* csw_q,
    const int32_t* csw_stage, const uint8_t* csw_drain,
    const int32_t* csw_timer, const uint8_t* csw_valid, const float* cap,
    const double* const* acc_in, double rsw_rate, double csw_rate, int B,
    int n_clusters, int racks_per_cluster, int planes, int csw_uplinks,
    double* rsw_q_out, double* rsw_wait, double* to_csw, double* csw_q_out,
    double* csw_wait, double* fc_in, double* const* acc_out, void* stream) {
  return tiers_entry<double>(
      rsw_q, rsw_stage, rsw_drain, rsw_timer, rack_valid, rsw_arr,
      arr_stride, csw_q, csw_stage, csw_drain, csw_timer, csw_valid, cap,
      acc_in, rsw_rate, csw_rate, B, n_clusters, racks_per_cluster, planes,
      csw_uplinks, rsw_q_out, rsw_wait, to_csw, csw_q_out, csw_wait, fc_in,
      acc_out, stream);
}
