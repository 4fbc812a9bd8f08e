// One LC/DC switch tick per switch row, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/lcdc_switch.py
// (switch_step -> _kernel): the per-switch datapath of the simulator's
// RSW tier ((B*R, P, 2) rows, serve rate 1) and CSW-uplink tier
// ((B*NC, CUP, 1) rows, serve rate 4), launched twice per simulated tick.
// Semantics are those of kernels/ref.py::switch_step_ref:
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
// What bounds it on this card: nothing but launch latency. A launch
// moves about 0.2 MB at the sim's RSW shape (1280 rows x 4 ports x 2
// components) — some 60 ns of HBM time at 3.35 TB/s — and does a few
// dozen flops per row. The design therefore stays simple and exact:
// one thread per switch row, the row's L*K queue values held in
// registers, every step a short sequential loop in the same order as
// the plain version's sums, and IEEE division. The build uses
// -fmad=false and no fast math, so the compiler fuses nothing on its
// own; the two updates the reference's compiled code does fuse (the
// post-serve queue q - q*frac and the sum of squares) are explicit
// __fmaf_rn calls, as the plain version's ref.fma. Coalescing is left on the table on
// purpose: the bytes are not the limit. Fusing this launch with the
// rest of the tick is where the time is, and is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLinks = 16;   // MAX_FAULT_LINKS: widest hull link axis
constexpr float kBig = 1e30f;   // masked-out port sentinel (ref.BIG)

template <int K>
__global__ void switch_step_kernel(
    const float* __restrict__ q_in, const int32_t* __restrict__ stage_in,
    const float* __restrict__ arr_in, const uint8_t* __restrict__ drain_in,
    const uint8_t* __restrict__ valid_in, const float* __restrict__ cap_in,
    const float* __restrict__ hi_in, const float* __restrict__ lo_in,
    float serve_rate, int n_rows, int n_links,
    float* __restrict__ q_out, float* __restrict__ served_out,
    int32_t* __restrict__ hi_out, int32_t* __restrict__ lo_out,
    float* __restrict__ drop_out, float* __restrict__ wait_out,
    float* __restrict__ m1_out, float* __restrict__ m2_out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const int L = n_links;
  const float* q_row = q_in + (size_t)row * L * K;
  const uint8_t* v_row = valid_in + (size_t)row * L;
  const int stage = stage_in[row];
  const bool drain = drain_in[row] != 0;
  const float cap = cap_in[row];

  float q[kMaxLinks][K];
  bool act[kMaxLinks];
  bool usable[kMaxLinks];
  bool vswitch = false;
  bool has_usable = false;
  // (1) min-backlog usable port: a strict '<' scan keeps the lowest
  // index among ties, as cumsum(pick) == 1 does in the plain version
  float mn = kBig;
  int pick = 0;
  for (int l = 0; l < L; ++l) {
    float tot = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      q[l][k] = q_row[l * K + k];
      tot = (k == 0) ? q[l][k] : tot + q[l][k];
    }
    const bool lv = v_row[l] != 0;
    vswitch |= lv;
    act[l] = (l < stage) && lv;
    const bool top = (l == stage - 1) && (stage > 1);
    usable[l] = act[l] && !(drain && top);
    has_usable |= usable[l];
    const float masked = usable[l] ? tot : kBig;
    if (l == 0 || masked < mn) {
      mn = masked;
      pick = l;
    }
  }
  const float mn0 = has_usable ? mn : 0.0f;

  // (5a) backlog-age of the pick, times the float32 reciprocal of the
  // rate (the reference compiles its division by the static rate so)
  wait_out[row] = (vswitch ? mn0 : 0.0f) * (1.0f / serve_rate);

  // (2) enqueue with capacity clamp, proportional over components
  float arr[K];
  float add_tot = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    arr[k] = arr_in[(size_t)row * K + k];
    add_tot = (k == 0) ? arr[k] : add_tot + arr[k];
  }
  const float room = has_usable ? fmaxf(cap - mn0, 0.0f) : 0.0f;
  const float scale = fminf(1.0f, room / fmaxf(add_tot, 1e-9f));
  drop_out[row] = vswitch ? add_tot * (1.0f - scale) : add_tot;
#pragma unroll
  for (int k = 0; k < K; ++k) q[pick][k] = q[pick][k] + arr[k] * scale;

  // (3) serve up to serve_rate per active port; (5b) moments; (4)
  // watermark triggers on the post-serve backlogs
  const float hi_lvl = hi_in[row] * cap;
  const float lo_lvl = lo_in[row] * cap;
  float m1 = 0.0f, m2 = 0.0f;  // m2 starts at +0: fma(x, x, 0) == x*x
  bool hi_t = false, lo_t = true;
  float* qo_row = q_out + (size_t)row * L * K;
  float* so_row = served_out + (size_t)row * L * K;
  for (int l = 0; l < L; ++l) {
    float tot = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) tot = (k == 0) ? q[l][k] : tot + q[l][k];
    const float serve_tot = act[l] ? fminf(tot, serve_rate) : 0.0f;
    const float frac = serve_tot / fmaxf(tot, 1e-9f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float s = q[l][k] * frac;
      so_row[l * K + k] = s;
      qo_row[l * K + k] = __fmaf_rn(-q[l][k], frac, q[l][k]);
    }
    const float qpost = tot - serve_tot;
    m1 = (l == 0) ? qpost : m1 + qpost;
    m2 = __fmaf_rn(qpost, qpost, m2);
    if (act[l]) {
      hi_t |= qpost > hi_lvl;
      lo_t &= qpost < lo_lvl;
    }
  }
  m1_out[row] = vswitch ? m1 : 0.0f;
  m2_out[row] = vswitch ? m2 : 0.0f;
  hi_out[row] = (hi_t && vswitch) ? 1 : 0;
  lo_out[row] = (lo_t && vswitch) ? 1 : 0;
}

}  // namespace

// C entry for ctypes. All pointers are device pointers of contiguous
// tensors: q (n, L, K) f32, stage (n,) i32, arrivals (n, K) f32, drain
// (n,) u8, valid (n, L) u8, cap/hi/lo (n,) f32; outputs q and served
// (n, L, K) f32, hi/lo (n,) i32, dropped/enq_wait/occ_m1/occ_m2 (n,)
// f32. Launches on `stream` and returns the launch's cudaError_t.
extern "C" int lcdc_switch_step(
    const float* q, const int32_t* stage, const float* arrivals,
    const uint8_t* drain, const uint8_t* valid, const float* cap,
    const float* hi, const float* lo, float serve_rate, int n_rows,
    int n_links, int n_comp, float* q_out, float* served_out,
    int32_t* hi_out, int32_t* lo_out, float* drop_out, float* wait_out,
    float* m1_out, float* m2_out, void* stream) {
  if (n_links < 1 || n_links > kMaxLinks) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return (int)cudaSuccess;
  const int threads = 128;
  const int blocks = (n_rows + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_comp == 1) {
    switch_step_kernel<1><<<blocks, threads, 0, s>>>(
        q, stage, arrivals, drain, valid, cap, hi, lo, serve_rate, n_rows,
        n_links, q_out, served_out, hi_out, lo_out, drop_out, wait_out,
        m1_out, m2_out);
  } else if (n_comp == 2) {
    switch_step_kernel<2><<<blocks, threads, 0, s>>>(
        q, stage, arrivals, drain, valid, cap, hi, lo, serve_rate, n_rows,
        n_links, q_out, served_out, hi_out, lo_out, drop_out, wait_out,
        m1_out, m2_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
