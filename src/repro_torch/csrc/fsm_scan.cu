// ToggleCCI FSM scan over a fleet: window sums, OFF->WAITING->ON cascade and
// the toggle cost, for N rows of T hours each, in one launch.
//
// Replaces: the jax.lax.scan of src/repro/fleet/policy.py::policy_scan
// (vmapped over rows by src/repro/fleet/engine.py::_run_policies), with the
// window sums of src/repro/core/togglecci.py::window_sums and the step of
// policy.py::_fsm_cascade / ReactivePolicy.step / HysteresisPolicy.step. The
// JAX package has no Pallas kernel for it; on the GPU an eager loop over T
// would launch ~10^5 small kernels per plan.
//
// What bounds it on an H100. Each element reads vpn and cci (2 x 8 B) and
// writes x and state (2 x 4 B): 24 B per element, 26.9 MB at 128 x 8760 and
// 430 MB at 2048 x 8760 (0.13 ms at 3.35 TB/s), and ~11 float64 operations.
// But each row is one dependent chain of T hours (the prefixes, the FSM carry,
// the toggle cost), and the rows are few: 2048 on the main path, one thread
// each. So the kernel is bound by the latency of one hour's step on one
// thread, times T, as long as the data is at hand when the step needs it.
//
// Design. A block owns kRows = 16 rows, so that 2048 rows take 128 of the 132
// SMs, one block each (the chains run in SIMT, so a block takes as long for 8
// rows as for 16: fewer rows a block only spread small fleets over more SMs,
// and timed no faster; a fleet past 132 x 16 rows runs in waves). Each row's
// chain is cut into three dependent chains that share no value within a tile
// of kTile hours, and each runs in a warp of its own, lane r on row r, one
// tile behind the other: at step j, warp 0 forms tile j's float64 prefixes,
// window sums and raw triggers (one bit per hour, shifted into two 64-bit
// masks), warp 1 runs the FSM over tile j - 1's masks (integers only; its
// decisions go into two more masks), warp 2 adds tile j - 2's toggle cost in
// hour order. Two copy warps stage tile j + kAhead from device memory with
// cp.async and write tile j - 2's x and state back from the decision masks,
// lanes over hours. Four streams are staged per tile: vpn and cci at hours
// [t0, t0 + kTile), and the lagged vpn and cci at each row's own offset
// t0 - h - 1 (from L2: the lead stream read them h + 1 hours earlier, 2048
// x 337 x 16 B = 11 MB at the scenario's widest window; +0.0 before hour 0). A
// segment of a row is contiguous, so the copies are coalesced; they are 8
// bytes each, which any row start (T x 8 B apart, any T, any view) allows, and
// hours past T are never copied. Rows of shared memory are padded to kTile + 1
// words so that the chain lanes (one row each) hit distinct banks. One
// __syncthreads per step hands the tiles on.
//
// The gated instance (GATED = true) runs ForecastGatedPolicy: it replaces the
// same lax.scan under src/repro/fleet/policy.py::ForecastGatedPolicy.step
// (:290-305), and the predicted mode costs its features form (:278-288,
// predicted_mode_costs at :220) are formed here too, from the (N, T)
// prediction and the rows' (N, 4) cost coefficients. Its request is
// A_req | (raw_req & B_req) and its release A_rel | (raw_rel & B_rel); the
// four A/B bits (fsm_step.cuh::fsm_gate_bits) compare the hour's predicted
// mode costs with the row's thresholds (its margin formed into four, once)
// and read no window sum. So they stay off the prefix chain: four gate warps
// form tile j's four masks (bit i = hour t0 + i; 0 past T, as settle leaves
// the raw masks) while the sums warp, which runs the reactive instance's
// hour, forms its raw ones, and the FSM warp combines them at the top of its
// tile, two 64-bit operations a trigger; the FSM and cost warps are the
// reactive instance's, with hold counts of 1. A gate warp takes 4 rows of a
// tile, 8 half-rows of 32 hours, lanes over hours, their predictions loaded
// into registers a tile ahead (gate_load), and one __ballot_sync a compare
// and half-row sets the bits. The instance asks for one block an SM
// (__launch_bounds__), which leaves its registers to the compiler: it runs
// faster so. It reads 32 B an element (pred, vpn and cci read,
// x and state written: 574 MB at 2048 x 8760, 0.171 ms at 3.35 TB/s).
//
// The exact costs, exp(a + b * log1p(pred)) per mode with CUDA's log1p and
// exp (live_forecast.cuh::mode_costs, which give torch's CUDA ops' bits),
// take about 180 instructions an hour, serially dependent and branching:
// formed for every hour, they set the pace with 4 to 16 gate warps, well
// behind the reactive instance. The bits need only the sign of
// log p_cci - log(t p_vpn), so a screen (gate_screen, ~20 float32
// instructions) decides every bit whose margin clears the rounding of both
// forms, and the lanes it leaves (a prediction within ~1e-5 in log of a
// threshold, below 0, past 1e15 or past the costs' normal range) form the
// exact costs: every bit is the exact form's. The gate warps run on the two
// schedulers (warp % 4) that hold neither the sums nor the FSM warp, warps
// 6, 7, 10 and 11 of 12 (5, 8 and 9 only meet the barrier): a busy warp
// beside a chain warp slows the chain.
//
// What bounds it now: the instructions the FSM warp and the sums warp run,
// hour after hour, on every row at once (PERF.md has the time an hour). The
// loops are unrolled by 8, not by the tile: fully unrolled, the four warps'
// loops do not fit the SM's instruction cache, and with every SM fetching
// code from L2 the kernel slowed down as more SMs ran it.
//
// Exactness: the sums warp keeps two float64 running prefixes of vpn (and two
// of cci) in registers: pref[t] = v[0] + ... + v[t-1], added in order, and the
// same sum lagging h hours behind, pref[max(0, t-h)], which adds v[t-h-1]
// once t > h. A prefix summed in order is the same number whenever it is
// formed, so the lagging one equals pref[t-h] bit for bit without a scratch
// plane, and the window sums r[t] = pref[t] - pref[max(0, t-h)] equal the
// plain version's, which subtracts two entries of a sequential cumsum (the
// CPU's torch.cumsum). Every add and product uses __dadd_rn / __dmul_rn and
// the file is compiled with -fmad=false. total_cost sums (x ? cci : vpn) in
// hour order.
//
// fsm_chunk, the second kernel here, is the streaming runtime's FSM: K hours
// from a carry (state, t_state, up, down and the two float64 prefixes) in,
// the carry out. It replaces the jax.lax.scan of
// src/repro/fleet/runtime.py::_build_step_many (runtime.py:577) together with
// that chunk's prefix-snapshot scan and window gather (runtime.py:501-515).
// Its planes are hour-major (K, M), so unlike fsm_scan its loads and stores
// are coalesced. Bound on an H100: it reads four (K, M) float64 planes and
// writes four float64 and two int32 planes, 0.15 MB per hour at M = 2048;
// at the runtime's K = 24 that is 3.5 MB, ~1.1 us at 3.35 TB/s. What holds it
// back is not the launch (PERF.md times it on the device, launch excluded):
// one thread per row in one-warp blocks walks its K hours and loads each hour's
// planes when it needs them, and snap_v/snap_c, written and read back in the
// same loop, keep every load behind the previous hour's stores, so each hour
// waits a device-memory round trip. The
// hour step (fsm_triggers, fsm_step, from fsm_step.cuh) is the one fsm_scan
// and stream_chunk.cu take, so all three decide alike. The streaming runtime
// now runs stream_chunk, which fuses this kernel with the calendar pricing;
// fsm_chunk stays as its same-run yardstick.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fsm_step.cuh"
#include "live_forecast.cuh"

namespace {

using fsm::FsmCarry;
using fsm::FsmGate;
using fsm::FsmRow;
using fsm::fsm_gate;
using fsm::fsm_gate_bits;
using fsm::fsm_hour;
using fsm::fsm_step;
using fsm::fsm_triggers;
using fsm::kOn;
using fsm::kWaiting;
using fsm::kOff;

constexpr int kRows = 16;                 // rows a block, one lane each
constexpr int kTile = 64;                 // hours per staged tile: one bit each in a mask
constexpr int kAhead = 2;                 // tiles in flight ahead of the sums warp
constexpr int kLead = kAhead + 3;         // tiles of vpn/cci in the ring: j - 2 .. j + kAhead
constexpr int kLag = kAhead + 1;          // tiles of lagged vpn/cci: j .. j + kAhead
constexpr int kPad = kTile + 1;           // row stride in shared memory (words)
constexpr int kCopyWarps = 2;
constexpr int kScanThreads = 32 * (3 + kCopyWarps);   // sums, FSM, cost, copies
constexpr int kGateWarps = 4;             // the gated instance's gate warps ...
constexpr int kGatedThreads = 32 * 12;    // ... among its 12 warps (gate_slot)
constexpr int kGateUnits = 2 * kRows / kGateWarps;   // half-rows a gate warp takes a tile
static_assert(kGateUnits * kGateWarps == 2 * kRows && kGateUnits <= 8,
              "a gate warp's half-rows pack 4 bits each into 32");

// The rings of one fsm_scan block. Tile t's vpn/cci sit in lead
// slot t % kLead, its lagged vpn/cci (hours t0 - h - 1 + i, +0.0 before hour
// 0) in lag slot t % kLag, its trigger and decision masks (bit i = hour
// t0 + i) in mask slot t % 2.
struct ScanTiles {
  double v[kLead][kRows][kPad], c[kLead][kRows][kPad];
  double vl[kLag][kRows][kPad], cl[kLag][kRows][kPad];
  uint64_t req[2][kRows], rel[2][kRows], on[2][kRows], wait[2][kRows];
  int64_t base[kRows];                      // row r's first element
  int lag[kRows];                           // h + 1
};

// One row's gate operands: the exact form's coefficients and thresholds, and
// the screen's (gate_screen) float32 differences, lp range and bounds.
struct GateRow {
  double coef[4];        // a_vpn, b_vpn, a_cci, b_cci
  FsmGate th;            // theta1 - m, theta1 + m, theta2 + m, theta2 - m
  float c0, c1;          // a_cci - a_vpn, b_cci - b_vpn
  float lp_lo, lp_hi;    // the lp the screen takes
  float lo[4], hi[4];    // log t -/+ the tolerance, rounded outwards
};

// The gated instance's shared memory after the ScanTiles: tile t's gate
// masks A_req, B_req, A_rel, B_rel (bit i = hour t0 + i) in slot t % 2, and
// each row's gate operands.
struct GateTiles {
  uint64_t mask[2][4][kRows];
  GateRow row[kRows];
};

constexpr double kScreenRel = 0x1p-40;     // slack of every rounding of the exact form
constexpr double kScreenLp = 34.5;         // largest lp the screen takes (pred near 1e15)
constexpr double kScreenArg = 690.0;       // largest |a + b lp| the screen takes
constexpr double kScreenEdge = 0.01;       // the lp range's inward margin

// A row's gate operands from its coefficients, thresholds and margin.
__device__ __forceinline__ GateRow gate_row(const double* coef, double theta1, double theta2,
                                           double margin) {
  GateRow g;
  for (int q = 0; q < 4; ++q) g.coef[q] = coef[q];
  g.th = fsm_gate(FsmRow{theta1, theta2}, margin);
  // lp in [0, kScreenLp] where both |a + b lp| <= kScreenArg, less the margin
  double lo = 0.0, hi = kScreenLp;
  for (int m = 0; m < 2; ++m) {
    const double a = coef[2 * m], b = coef[2 * m + 1];
    if (!(isfinite(a) && isfinite(b))) {
      hi = -1.0;
    } else if (b == 0.0) {
      hi = fabs(a) <= kScreenArg ? hi : -1.0;
    } else {
      const double e1 = (-kScreenArg - a) / b, e2 = (kScreenArg - a) / b;
      lo = fmax(lo, fmin(e1, e2) + kScreenEdge);
      hi = fmin(hi, fmax(e1, e2) - kScreenEdge);
    }
  }
  g.lp_lo = __double2float_ru(lo);
  g.lp_hi = __double2float_rd(hi);
  const double c0 = coef[2] - coef[0], c1 = coef[3] - coef[1];
  g.c0 = __double2float_rn(c0);
  g.c1 = __double2float_rn(c1);
  // the screen's d against (a_cci - a_vpn) + (b_cci - b_vpn) log1p(pred):
  // its lp (see gate_screen) and float32 roundings; the exact form's
  // roundings (log1p, the product and sum, exp: an ulp each; the product with
  // t: half an ulp; log t: an ulp)
  const double lpm = kScreenLp;
  const double e = fabs(c1) * 0x1p-19 * (1.0 + lpm) + 0x1p-21 * (fabs(c0) + fabs(c1) * lpm) +
                   kScreenRel * (1.0 + fabs(coef[0]) + fabs(coef[2]) +
                                 2.0 * (fabs(coef[1]) + fabs(coef[3])) * lpm);
  const double t[4] = {g.th.t1_lo, g.th.t1_hi, g.th.t2_hi, g.th.t2_lo};
  for (int q = 0; q < 4; ++q) {
    const double lt = t[q] > 0.0 ? log(t[q]) : t[q] <= 0.0 ? -HUGE_VAL : t[q];
    const double tol = e + (isfinite(lt) ? kScreenRel * fabs(lt) : 0.0);
    g.lo[q] = __double2float_rd(lt - tol);
    g.hi[q] = __double2float_ru(lt + tol);
  }
  return g;
}

// The screen: the four gate bits of a prediction, without its mode costs,
// where they are sure; false where the exact form must decide. In log
// space p_cci < t * p_vpn reads d = (a_cci - a_vpn) + (b_cci - b_vpn) lp <
// log t, lp = log1p(pred). The screen forms lp = log(1 + pred) in float32
// with the hardware's log2 (within 3.5e-7 (1 + lp) of log1p(pred) for
// pred >= 0 by the intrinsics' stated errors; taken at 2^-19 (1 + lp)) and d
// in float32. Every rounding of the screen and of the exact form moves d -
// log t by less than the tolerance gate_row puts into the bounds lo and hi,
// so a d below lo (above hi) has the exact form's sign, and the exact bit's.
// In the screen's lp range both costs are normal and positive: a threshold
// at or below 0 (log -inf) makes p_cci < t p_vpn false and p_cci > t p_vpn
// true, a threshold of +inf (log +inf) the reverse, as the exact form
// decides; a NaN threshold is never sure. A NaN prediction makes every
// compare false; a prediction below 0 or past 1e15 is never sure. No branch,
// so that a gate warp's half-rows interleave.
__device__ __forceinline__ bool gate_screen(const GateRow& g, double pred, uint32_t& bits) {
  const float y = __fadd_rn(__double2float_rn(pred), 1.0f);
  const float lp = __fmul_rn(__log2f(y), 0.693147180559945f);
  const float d = __fmaf_rn(g.c1, lp, g.c0);
  bool sure = (lp >= g.lp_lo) & (lp <= g.lp_hi);
  uint32_t b = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool below = d < g.lo[q], above = d > g.hi[q];
    sure &= below | above;
    b |= (uint32_t)(q < 2 ? below : above) << q;   // "<" for the requests
  }
  const bool nan = isnan(pred);
  bits = nan ? 0u : b;
  return nan | sure;
}

// The gate warps: warps 6, 7, 10 and 11, on the schedulers of warps 2 and 3
// (warp % 4), which hold neither the sums nor the FSM warp; -1 for another.
__device__ __forceinline__ int gate_slot(int warp) {
  return warp >= 6 && warp % 4 >= 2 ? 2 * ((warp - 6) / 4) + warp % 4 - 2 : -1;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy warp cw: stage tile j (a no-op past the last tile) for rows cw,
// cw + kCopyWarps, ..., lanes over hours. A lagged slot before hour 0 gets +0.0:
// adding it leaves a prefix that starts at +0.0 (and so is never -0.0) as it
// is.
__device__ __forceinline__ void stage_tile(ScanTiles& sm, int j, const double* vpn,
                                           const double* cci, int rows, int T, int cw,
                                           int lane) {
  const int t0 = j * kTile;
  if (t0 >= T) return;
  const int len = min(kTile, T - t0);
  const int bl = j % kLead, bg = j % kLag;
  for (int r = cw; r < rows; r += kCopyWarps) {
    const double* vr = vpn + sm.base[r];
    const double* cr = cci + sm.base[r];
    const int64_t k0 = (int64_t)t0 - sm.lag[r];
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) {
      const int i = lane + 32 * k;
      if (i < len) {
        cp_async8(&sm.v[bl][r][i], vr + t0 + i);
        cp_async8(&sm.c[bl][r][i], cr + t0 + i);
        if (k0 + i >= 0) {
          cp_async8(&sm.vl[bg][r][i], vr + (k0 + i));
          cp_async8(&sm.cl[bg][r][i], cr + (k0 + i));
        } else {
          sm.vl[bg][r][i] = 0.0;
          sm.cl[bg][r][i] = 0.0;
        }
      }
    }
  }
}

// The sums warp, one hour of a row: the lagged and leading prefixes, the
// window sums, and the hour's raw triggers, shifted into two masks from the
// top (after a whole tile, bit i is hour t0 + i).
struct Sums {
  double pv = 0.0, pc = 0.0;    // pref[t]: sum of hours [0, t)
  double lv = 0.0, lc = 0.0;    // pref[max(0, t - h)]
  __device__ __forceinline__ void hour(const FsmRow& p, const double* V, const double* C,
                                       const double* VL, const double* CL, int i,
                                       uint64_t& req, uint64_t& rel) {
    lv = __dadd_rn(lv, VL[i]);
    lc = __dadd_rn(lc, CL[i]);
    bool raw_req, raw_rel;
    fsm_triggers(p, __dsub_rn(pv, lv), __dsub_rn(pc, lc), raw_req, raw_rel);
    req = req >> 1 | (uint64_t)raw_req << 63;
    rel = rel >> 1 | (uint64_t)raw_rel << 63;
    pv = __dadd_rn(pv, V[i]);
    pc = __dadd_rn(pc, C[i]);
  }
};

// A mask of len < kTile hours shifted in from the top, moved down to bit 0.
__device__ __forceinline__ uint64_t settle(uint64_t m, int len) {
  return len < kTile ? m >> (kTile - len) : m;
}

// The exact form of an hour's four gate bits (bit q: A_req, B_req, A_rel,
// B_rel): its predicted mode costs, then the compares.
__device__ __forceinline__ uint32_t gate_exact(double pred, const GateRow& row) {
  double p_vpn, p_cci;
  live::mode_costs(pred, row.coef, p_vpn, p_cci);
  bool b[4];
  fsm_gate_bits(row.th, p_vpn, p_cci, b[0], b[1], b[2], b[3]);
  return (uint32_t)b[0] | (uint32_t)b[1] << 1 | (uint32_t)b[2] << 2 | (uint32_t)b[3] << 3;
}

// gate_exact as a subroutine, for gate_masks_kernel: its body in the SASS is
// the exact form's instructions alone (chip_smoke.py counts them).
__device__ __noinline__ uint32_t gate_exact_call(double pred, const GateRow& row) {
  return gate_exact(pred, row);
}

// Gate warp g's half-row v: rows 4g .. 4g + 3, both halves of each, so that
// a row's operands serve two half-rows.
__device__ __forceinline__ int gate_unit(int g, int v) { return g * kGateUnits + v; }

// Gate warp g: tile t's predictions of its half-rows (row u / 2, hours
// 32 (u % 2) .. + 31 of the tile, u = gate_unit(g, v)), lanes over
// hours, from device memory into registers; 0.0 past T or the block's rows.
__device__ __forceinline__ void gate_load(const int64_t* base, const double* pred, int t,
                                          int rows, int T, int g, int lane,
                                          double (&p)[kGateUnits]) {
#pragma unroll
  for (int v = 0; v < kGateUnits; ++v) {
    const int u = gate_unit(g, v);
    const int64_t i = (int64_t)t * kTile + 32 * (u & 1) + lane;
    p[v] = u < 2 * rows && i < T ? pred[base[u >> 1] + i] : 0.0;
  }
}

// Gate warp g, tile j of len hours: the gate masks of its half-rows from
// their predictions p, each half-row's four 32-bit words from one ballot a
// compare. The screen decides every bit it can, for all of the warp's
// half-rows at once; where it is not sure, those lanes form the exact mode
// costs and compare them (all lanes, without the screen). Hours past T (and
// rows past the block's) get 0.
template <bool CALL = false>
__device__ __forceinline__ void gate_tile(GateTiles& gt, int j, int rows, int len, int g,
                                          int lane, const double (&p)[kGateUnits],
                                          bool screen = true) {
  uint32_t bits = 0, unsure = 0;          // 4 bits and 1 bit a half-row v
#pragma unroll
  for (int v = 0; v < kGateUnits; ++v) {
    const int u = gate_unit(g, v), i = 32 * (u & 1) + lane;
    uint32_t b = 0;
    const bool sure =
        u >= 2 * rows || i >= len || (screen && gate_screen(gt.row[u >> 1], p[v], b));
    bits |= b << (4 * v);
    unsure |= (uint32_t)!sure << v;
  }
  if (__any_sync(0xffffffffu, unsure != 0)) {
#pragma unroll 1
    for (int v = 0; v < kGateUnits; ++v) {
      if (!((unsure >> v) & 1)) continue;
      double x = p[0];                    // p[v], kept in registers
#pragma unroll
      for (int w = 1; w < kGateUnits; ++w) x = v == w ? p[w] : x;
      const GateRow& row = gt.row[gate_unit(g, v) >> 1];
      bits = (bits & ~(0xfu << (4 * v))) |
             (CALL ? gate_exact_call(x, row) : gate_exact(x, row)) << (4 * v);
    }
  }
#pragma unroll
  for (int v = 0; v < kGateUnits; ++v) {
    const int u = gate_unit(g, v);
    uint32_t word = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t m = __ballot_sync(0xffffffffu, (bits >> (4 * v + q)) & 1);
      word = lane == q ? m : word;
    }
    if (lane < 4 && u < 2 * rows)
      reinterpret_cast<uint32_t*>(&gt.mask[j % 2][lane][u >> 1])[u & 1] = word;
  }
}

// The FSM warp, one hour of a row: the step from the hour's trigger bits
// (bit 0 of the masks, shifted out), and the decision shifted into two masks.
template <bool RENEW>
__device__ __forceinline__ void decide_hour(const FsmRow& p, FsmCarry& fc, uint64_t& req,
                                            uint64_t& rel, uint64_t& on, uint64_t& wait) {
  const int s = fsm_step(p, fc, req & 1, rel & 1, RENEW);
  req >>= 1;
  rel >>= 1;
  on = on >> 1 | (uint64_t)(s == kOn) << 63;
  wait = wait >> 1 | (uint64_t)(s == kWaiting) << 63;
}

// Copy warp cw: write tile t's x and state for rows cw, cw + kCopyWarps,
// ..., from the decision masks, lanes over hours.
__device__ __forceinline__ void store_tile(const ScanTiles& sm, int t, int* x_out,
                                           int* state_out, int rows, int T, int cw,
                                           int lane) {
  const int t0 = t * kTile, len = min(kTile, T - t0);
  for (int r = cw; r < rows; r += kCopyWarps) {
    const uint64_t on = sm.on[t % 2][r], wait = sm.wait[t % 2][r];
    int* xr = x_out + sm.base[r] + t0;
    int* sr = state_out + sm.base[r] + t0;
#pragma unroll
    for (int k = 0; k < kTile / 32; ++k) {
      const int i = lane + 32 * k;
      if (i < len) {
        const int is_on = (int)((on >> i) & 1);
        xr[i] = is_on;
        sr[i] = is_on ? kOn : (int)((wait >> i) & 1);
      }
    }
  }
}

// Each row is walked by three warps one tile apart, lane r on row n0 + r:
// at step j, warp 0 sums tile j, warp 1 decides tile j - 1 and warp 2 adds
// tile j - 2's toggle cost in hour order, while the copy warps stage tile
// j + kAhead and write tile j - 2's x and state (and the gated instance's
// gate warps form tile j's gate masks). One __syncthreads per step hands the
// tiles on. pred, coef and margin are read by the gated instance only.
template <bool RENEW, bool GATED>
__global__ void __launch_bounds__(GATED ? kGatedThreads : kScanThreads, GATED ? 1 : 0)
fsm_scan_kernel(const double* __restrict__ vpn, const double* __restrict__ cci,
                const double* __restrict__ pred, const double* __restrict__ coef,
                const double* __restrict__ margin,
                const double* __restrict__ theta1, const double* __restrict__ theta2,
                const int* __restrict__ win, const int* __restrict__ delay,
                const int* __restrict__ commit, const int* __restrict__ up_hold,
                const int* __restrict__ down_hold, int N, int T,
                int* __restrict__ x_out, int* __restrict__ state_out,
                double* __restrict__ total_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanTiles& sm = *reinterpret_cast<ScanTiles*>(smem_raw);
  GateTiles* gt = GATED ? reinterpret_cast<GateTiles*>(smem_raw + sizeof(ScanTiles)) : nullptr;
  const int64_t n0 = (int64_t)blockIdx.x * kRows;
  const int rows = (int)min((int64_t)kRows, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (T + kTile - 1) / kTile;
  if ((int)threadIdx.x < rows) {
    const int r = threadIdx.x;
    sm.base[r] = (n0 + r) * (int64_t)T;
    sm.lag[r] = win[n0 + r] + 1;
    if (GATED) {
      const int64_t n = n0 + r;
      gt->row[r] = gate_row(coef + 4 * n, theta1[n], theta2[n], margin[n]);
    }
  }
  __syncthreads();
  const bool copier = warp >= 3 && (!GATED || warp < 3 + kCopyWarps);
  if (copier) {
    for (int j = 0; j < kAhead; ++j) {
      stage_tile(sm, j, vpn, cci, rows, T, warp - 3, lane);
      cp_async_commit();
    }
  }
  const int gw = GATED ? gate_slot(warp) : -1;  // this warp's gate slot, if any
  double p_cur[kGateUnits], p_next[kGateUnits];  // its predictions, tile j and j + 1
  if (gw >= 0) gate_load(sm.base, pred, 0, rows, T, gw, lane, p_next);
  const bool mine = lane < rows;                 // lane r walks row n0 + r
  const int64_t n = n0 + lane;
  FsmRow p = {};
  if (mine && warp < 2)
    p = {theta1[n], theta2[n], delay[n], commit[n], up_hold[n], down_hold[n], RENEW};
  Sums sums;
  FsmCarry fc = {kOff, 0, 0, 0, 0};
  double total = 0.0;

  for (int j = 0; j <= n_tiles + 1; ++j) {
    if (copier) cp_async_wait<kAhead - 1>();  // tile j has landed
    __syncthreads();
    if (warp == 0) {
      if (mine && j < n_tiles) {
        const int len = min(kTile, T - j * kTile);
        const double *V = sm.v[j % kLead][lane], *C = sm.c[j % kLead][lane];
        const double *VL = sm.vl[j % kLag][lane], *CL = sm.cl[j % kLag][lane];
        uint64_t req = 0, rel = 0;
#pragma unroll 8
        for (int i = 0; i < len; ++i) sums.hour(p, V, C, VL, CL, i, req, rel);
        sm.req[j % 2][lane] = settle(req, len);
        sm.rel[j % 2][lane] = settle(rel, len);
      }
    } else if (warp == 1) {
      const int t = j - 1;
      if (mine && t >= 0 && t < n_tiles) {
        const int len = min(kTile, T - t * kTile);
        uint64_t req = sm.req[t % 2][lane], rel = sm.rel[t % 2][lane], on = 0, wait = 0;
        if (GATED) {
          const uint64_t(*m)[kRows] = gt->mask[t % 2];
          req = m[0][lane] | (req & m[1][lane]);
          rel = m[2][lane] | (rel & m[3][lane]);
        }
#pragma unroll 8
        for (int i = 0; i < len; ++i) decide_hour<RENEW>(p, fc, req, rel, on, wait);
        sm.on[t % 2][lane] = settle(on, len);
        sm.wait[t % 2][lane] = settle(wait, len);
      }
    } else if (warp == 2) {
      const int t = j - 2;
      if (mine && t >= 0) {
        const int len = min(kTile, T - t * kTile);
        uint64_t on = sm.on[t % 2][lane];
        const double *V = sm.v[t % kLead][lane], *C = sm.c[t % kLead][lane];
#pragma unroll 8
        for (int i = 0; i < len; ++i, on >>= 1) total = __dadd_rn(total, on & 1 ? C[i] : V[i]);
      }
    } else if (copier) {
      stage_tile(sm, j + kAhead, vpn, cci, rows, T, warp - 3, lane);
      cp_async_commit();
      if (j >= 2) store_tile(sm, j - 2, x_out, state_out, rows, T, warp - 3, lane);
    } else if (gw >= 0 && j < n_tiles) {
#pragma unroll
      for (int v = 0; v < kGateUnits; ++v) p_cur[v] = p_next[v];   // loaded a step ago
      if (j + 1 < n_tiles) gate_load(sm.base, pred, j + 1, rows, T, gw, lane, p_next);
      gate_tile(*gt, j, rows, min(kTile, T - j * kTile), gw, lane, p_cur);
    }
  }
  if (mine && warp == 2) total_out[n] = total;
}

// K hours of the FSM from a carry, for the streaming runtime's chunk. Planes
// are hour-major (K, M): a warp's 32 loads of one hour are contiguous.
// Window reads older than the chunk (lo = max(0, t0 + k - h) < t0) come from
// the host's prefix ring, pre_v/pre_c; younger ones from the prefix snapshots
// this thread wrote earlier in the chunk (snap[k] = pref before hour t0 + k,
// the exclusive-prefix convention of the runtime's rings).
__global__ void fsm_chunk_kernel(const double* __restrict__ vpn,
                                 const double* __restrict__ cci,
                                 const double* __restrict__ pre_v,
                                 const double* __restrict__ pre_c,
                                 const double* __restrict__ theta1,
                                 const double* __restrict__ theta2,
                                 const int* __restrict__ win,
                                 const int* __restrict__ delay,
                                 const int* __restrict__ commit,
                                 const int* __restrict__ up_hold,
                                 const int* __restrict__ down_hold,
                                 int renew_in_chunks, int t0, int K, int M,
                                 const int* __restrict__ carry_in,     // (4, M)
                                 const double* __restrict__ pref_in,   // (2, M)
                                 int* __restrict__ x_out,
                                 int* __restrict__ state_out,
                                 double* __restrict__ rv_out,
                                 double* __restrict__ rc_out,
                                 double* snap_v,                       // written, then read
                                 double* snap_c,
                                 int* __restrict__ carry_out,
                                 double* __restrict__ pref_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const FsmRow p = {theta1[m], theta2[m], delay[m], commit[m], up_hold[m],
                    down_hold[m], renew_in_chunks != 0};
  const int h = win[m];
  FsmCarry fc = {carry_in[m], carry_in[M + m], carry_in[2 * M + m],
                 carry_in[3 * M + m], carry_in[M + m] % p.T_cci};
  double pv = pref_in[m], pc = pref_in[M + m];
  for (int k = 0; k < K; ++k) {
    const int64_t i = (int64_t)k * M + m;
    snap_v[i] = pv;
    snap_c[i] = pc;
    const int lo = max(0, t0 + k - h);
    double bv, bc;
    if (lo >= t0) {
      const int64_t j = (int64_t)(lo - t0) * M + m;  // lo - t0 <= k: written
      bv = snap_v[j];
      bc = snap_c[j];
    } else {
      bv = pre_v[i];
      bc = pre_c[i];
    }
    const double r_vpn = __dsub_rn(pv, bv);
    const double r_cci = __dsub_rn(pc, bc);
    rv_out[i] = r_vpn;
    rc_out[i] = r_cci;
    const int s = fsm_hour(p, fc, r_vpn, r_cci);
    x_out[i] = s == kOn ? 1 : 0;
    state_out[i] = s;
    pv = __dadd_rn(pv, vpn[i]);
    pc = __dadd_rn(pc, cci[i]);
  }
  carry_out[m] = fc.state;
  carry_out[M + m] = fc.t_state;
  carry_out[2 * M + m] = fc.up;
  carry_out[3 * M + m] = fc.down;
  pref_out[m] = pv;
  pref_out[M + m] = pc;
}

// The gated instance's gate stage alone, for the checks: blocks of kRows
// rows and kGateWarps gate warps form every tile's gate masks as the gated
// fsm_scan does (gate_load, gate_tile; with screen = false, every hour by
// the exact form) and write tile t's mask q of row n to
// masks[(n * n_tiles + t) * 4 + q].
__global__ void __launch_bounds__(32 * kGateWarps)
gate_masks_kernel(const double* __restrict__ pred, const double* __restrict__ coef,
                  const double* __restrict__ margin, const double* __restrict__ theta1,
                  const double* __restrict__ theta2, int N, int T, bool screen,
                  uint64_t* __restrict__ masks) {
  __shared__ int64_t base[kRows];
  __shared__ GateTiles gt;
  const int64_t n0 = (int64_t)blockIdx.x * kRows;
  const int rows = (int)min((int64_t)kRows, N - n0);
  const int g = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (T + kTile - 1) / kTile;
  if ((int)threadIdx.x < rows) {
    const int64_t n = n0 + threadIdx.x;
    base[threadIdx.x] = n * (int64_t)T;
    gt.row[threadIdx.x] = gate_row(coef + 4 * n, theta1[n], theta2[n], margin[n]);
  }
  __syncthreads();
  double p[kGateUnits], p_next[kGateUnits];
  gate_load(base, pred, 0, rows, T, g, lane, p_next);
  for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int v = 0; v < kGateUnits; ++v) p[v] = p_next[v];
    if (t + 1 < n_tiles) gate_load(base, pred, t + 1, rows, T, g, lane, p_next);
    gate_tile<true>(gt, t, rows, min(kTile, T - t * kTile), g, lane, p, screen);
    __syncthreads();
    if ((int)threadIdx.x < 4 * rows) {
      const int r = threadIdx.x / 4, q = threadIdx.x % 4;
      masks[((n0 + r) * n_tiles + t) * 4 + q] = gt.mask[t % 2][q][r];
    }
    __syncthreads();
  }
}

template <bool RENEW, bool GATED>
int launch_scan(const double* vpn, const double* cci, const double* pred, const double* coef,
                const double* margin, const double* theta1, const double* theta2,
                const int* h, const int* D, const int* T_cci, const int* up_hold,
                const int* down_hold, int N, int T, int* x, int* state, double* total,
                cudaStream_t stream) {
  const int smem = (int)(sizeof(ScanTiles) + (GATED ? sizeof(GateTiles) : 0));
  cudaError_t err = cudaFuncSetAttribute(fsm_scan_kernel<RENEW, GATED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = GATED ? kGatedThreads : kScanThreads;
  fsm_scan_kernel<RENEW, GATED><<<(N + kRows - 1) / kRows, threads, smem, stream>>>(
      vpn, cci, pred, coef, margin, theta1, theta2, h, D, T_cci, up_hold, down_hold, N, T,
      x, state, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fsm_scan_f64(const double* vpn, const double* cci,
                            const double* theta1, const double* theta2,
                            const int* h, const int* D, const int* T_cci,
                            const int* up_hold, const int* down_hold,
                            int renew_in_chunks, int N, int T,
                            int* x, int* state, double* total, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  if (N < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const auto launch = renew_in_chunks ? launch_scan<true, false> : launch_scan<false, false>;
  return launch(vpn, cci, nullptr, nullptr, nullptr, theta1, theta2, h, D, T_cci, up_hold,
                down_hold, N, T, x, state, total, (cudaStream_t)stream);
}

// The gated instance: ForecastGatedPolicy over (N, T) cost planes, its (N, T)
// predicted demand, the rows' (N, 4) cost coefficients [a_vpn, b_vpn, a_cci,
// b_cci] and (N,) margins.
extern "C" int fsm_scan_gated_f64(const double* vpn, const double* cci,
                                  const double* pred, const double* coef,
                                  const double* margin, const double* theta1,
                                  const double* theta2, const int* h, const int* D,
                                  const int* T_cci, const int* up_hold, const int* down_hold,
                                  int renew_in_chunks, int N, int T,
                                  int* x, int* state, double* total, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  if (N < 0 || T < 0) return (int)cudaErrorInvalidValue;
  const auto launch = renew_in_chunks ? launch_scan<true, true> : launch_scan<false, true>;
  return launch(vpn, cci, pred, coef, margin, theta1, theta2, h, D, T_cci, up_hold,
                down_hold, N, T, x, state, total, (cudaStream_t)stream);
}

extern "C" int fsm_scan_gate_masks_f64(const double* pred, const double* coef,
                                       const double* margin, const double* theta1,
                                       const double* theta2, int N, int T, int screen,
                                       uint64_t* masks, void* stream) {
  if (N == 0 || T == 0) return (int)cudaSuccess;
  if (N < 0 || T < 0) return (int)cudaErrorInvalidValue;
  gate_masks_kernel<<<(N + kRows - 1) / kRows, 32 * kGateWarps, 0, (cudaStream_t)stream>>>(
      pred, coef, margin, theta1, theta2, N, T, screen != 0, masks);
  return (int)cudaGetLastError();
}

extern "C" int fsm_chunk_f64(const double* vpn, const double* cci,
                             const double* pre_v, const double* pre_c,
                             const double* theta1, const double* theta2,
                             const int* h, const int* D, const int* T_cci,
                             const int* up_hold, const int* down_hold,
                             int renew_in_chunks, int t0, int K, int M,
                             const int* carry_in, const double* pref_in,
                             int* x, int* state, double* r_vpn, double* r_cci,
                             double* snap_v, double* snap_c, int* carry_out,
                             double* pref_out, void* stream) {
  if (M == 0) return (int)cudaSuccess;
  const int threads = 32;
  const int blocks = (M + threads - 1) / threads;
  fsm_chunk_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      vpn, cci, pre_v, pre_c, theta1, theta2, h, D, T_cci, up_hold, down_hold,
      renew_in_chunks, t0, K, M, carry_in, pref_in, x, state, r_vpn, r_cci,
      snap_v, snap_c, carry_out, pref_out);
  return (int)cudaGetLastError();
}
