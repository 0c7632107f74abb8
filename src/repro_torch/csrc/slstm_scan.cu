// sLSTM recurrence over a whole sequence in one launch, for Hopper.
//
// Replaces the TPU kernel slstm_scan_pallas (src/repro/kernels/slstm_scan/
// slstm_scan.py, body _slstm_chunk_kernel), which keeps the stacked
// recurrent weights R (4, H, hd, hd) and the running state (c, n, h, m) in
// VMEM while the precomputed input pre-activations wx stream through in
// time chunks. Per step and (lane, head):
//
//   pre_g = wx[t, g] + h_{t-1} @ R[g]           g in (i, f, z, o)
//   logf = log_sigmoid(pre_f); m' = max(logf + m, pre_i)
//   c' = exp(logf + m - m') c + exp(pre_i - m') tanh(pre_z)
//   n' = exp(logf + m - m') n + exp(pre_i - m')
//   h' = sigmoid(pre_o) c' / max(n', 1e-6)
//
// in f32, the stabiliser only ever exponentiating differences that are
// <= 0, so saturated gates (i >> 0, f << 0) neither overflow nor NaN.
//
// Bound on this card: the step is sequential, so the time grows with S
// whatever the bound says. Per step a (lane, head) needs 4 * hd * hd
// multiply-adds against R; at full xlstm-350m width (H = 4, hd = 256) R is
// 4 MB, 1 MB a head, against 227 KB of shared memory a block. So R cannot
// live in one block's shared memory as it lived in VMEM: it is read through
// L2 (50 MB, where it stays for the whole sequence) every step. Design: one
// block per (lane, head), one thread per (gate, column) pair, 4 * hd
// threads; h_{t-1} sits in shared memory and is broadcast to every thread,
// R's rows are read coalesced along the column axis with four independent
// partial sums so several loads are in flight, and the threads of gate 0
// then hold (c, n, m) of their column in registers across all steps.
// h_{t-1} is kept in shared memory already widened to f64, so only R's
// element is converted for each product. state0 is read once (decode
// resumes from a lane's pool state), every step's h is written, and the
// final (c, n, h, m) once at the end.
//
// What limits a step is the issue of one SM, not L2 (measured by
// kernels/slstm_scan/probe.py, PERF.md): per multiply-add a thread issues
// a global load of R, a shared load of h and an f32 -> f64 conversion of
// R's element (16 a clock an SM: 8.3 us a step for 4 * 256 * 256 of them
// at 1.98 GHz, of ~12.9 us); R taken from L1 instead is no faster. The
// faster design, a cluster of CTAs per head each holding a slice of R in
// shared memory (already widened) with h broadcast through distributed
// shared memory, and several columns a thread, is a later change.

#include "common.cuh"
#include <stddef.h>

// Measurement builds only (kernels/slstm_scan/probe.py times them beside
// the shipped build, SLSTM_PROBE 0, which is the only one the port
// loads): 1 sums the dot in f32 (no f32 -> f64 conversion), 2 and 3 are 0
// and 1 with R's rows taken mod 32, so the 128 KB of R a block then reads
// stays in L1 and no step waits on L2, and 4 skips the dot (the step's
// fixed cost: wx, the cell update, two barriers).
#ifndef SLSTM_PROBE
#define SLSTM_PROBE 0
#endif
#if SLSTM_PROBE == 1 || SLSTM_PROBE == 3
typedef float acc_t;
#else
typedef double acc_t;
#endif
#if SLSTM_PROBE == 2 || SLSTM_PROBE == 3
#define R_ROW(e) ((e) & 31)
#else
#define R_ROW(e) (e)
#endif

namespace {

constexpr int MAX_HD = 256;

__device__ __forceinline__ float round_f32(double x) {
  return __double2float_rn(x);
}
__device__ __forceinline__ float round_f32(float x) { return x; }

// The step is evaluated in the plain version's operations and order
// (kernels/slstm_scan/plain.py), each rounded to f32 by an intrinsic that
// the compiler may not contract into an FMA, and the recurrent dot product
// accumulates its exact f32 x f32 products in f64, so its f32 result is
// the correctly rounded one whatever the order of the sum. The kernel and
// its plain version then agree to the last bit but for rare ties of that
// rounding: a model of 24 blocks amplifies f32 summation-order noise in
// the state into different tokens, and the end-to-end check that holds
// the kernels against the plain versions would otherwise see only that.

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

__global__ void __launch_bounds__(4 * MAX_HD)
slstm_scan_kernel(const float* __restrict__ wx, const float* __restrict__ r,
                  const float* __restrict__ state0, float* __restrict__ hs,
                  float* __restrict__ state_out, int S, int B, int H,
                  int hd) {
  __shared__ acc_t sh_h[MAX_HD];      // h_{t-1}, widened once a step
  __shared__ float sh_pre[4 * MAX_HD];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;            // lane * H + head
  const int head = bh % H;
  const size_t plane = (size_t)B * H * hd;    // one gate / state leaf
  const size_t base = (size_t)bh * hd;        // this (lane, head) row

  // this thread's (gate, column) of the recurrent product
  const bool dot = tid < 4 * hd;
  const int g = tid / hd;
  const int f = tid % hd;
  const float* __restrict__ rcol =
      r + ((size_t)(dot ? g : 0) * H + head) * hd * hd + f;

  // the column state of the cell-update threads
  const bool cell = tid < hd;
  float c = 0.f, n = 0.f, h = 0.f, m = 0.f;
  if (cell) {
    c = state0[base + tid];
    n = state0[plane + base + tid];
    h = state0[2 * plane + base + tid];
    m = state0[3 * plane + base + tid];
    sh_h[tid] = (acc_t)h;
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    if (dot) {
      acc_t acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
      int e = 0;
#if SLSTM_PROBE != 4
      for (; e + 4 <= hd; e += 4) {
        acc0 = fma(sh_h[e], (acc_t)__ldg(rcol + (size_t)R_ROW(e) * hd), acc0);
        acc1 = fma(sh_h[e + 1],
                   (acc_t)__ldg(rcol + (size_t)R_ROW(e + 1) * hd), acc1);
        acc2 = fma(sh_h[e + 2],
                   (acc_t)__ldg(rcol + (size_t)R_ROW(e + 2) * hd), acc2);
        acc3 = fma(sh_h[e + 3],
                   (acc_t)__ldg(rcol + (size_t)R_ROW(e + 3) * hd), acc3);
      }
      for (; e < hd; ++e)
        acc0 = fma(sh_h[e], (acc_t)__ldg(rcol + (size_t)R_ROW(e) * hd), acc0);
#endif
      const float w = wx[((size_t)t * 4 + g) * plane + base + f];
      sh_pre[g * hd + f] =
          __fadd_rn(w, round_f32((acc0 + acc1) + (acc2 + acc3)));
    }
    __syncthreads();
    if (cell) {
      const float i_r = sh_pre[tid];
      const float f_r = sh_pre[hd + tid];
      const float z_r = sh_pre[2 * hd + tid];
      const float o_r = sh_pre[3 * hd + tid];
      const float logf = log_sigmoid(f_r);
      const float lm = __fadd_rn(logf, m);
      const float m_new = fmaxf(lm, i_r);
      const float i_g = expf(__fsub_rn(i_r, m_new));
      const float f_g = expf(__fsub_rn(lm, m_new));
      c = __fadd_rn(__fmul_rn(f_g, c), __fmul_rn(i_g, tanhf(z_r)));
      n = __fadd_rn(__fmul_rn(f_g, n), i_g);
      h = __fdiv_rn(__fmul_rn(sigmoid(o_r), c), fmaxf(n, 1e-6f));
      m = m_new;
      sh_h[tid] = (acc_t)h;
      hs[(size_t)t * plane + base + tid] = h;
    }
    __syncthreads();
  }

  if (cell) {
    state_out[base + tid] = c;
    state_out[plane + base + tid] = n;
    state_out[2 * plane + base + tid] = h;
    state_out[3 * plane + base + tid] = m;
  }
}

}  // namespace

// wx (S, 4, B, H, hd), r (4, H, hd, hd), state0 and state_out (4, B, H,
// hd), hs (S, B, H, hd): all float32 and contiguous; 1 <= hd <= 256.
extern "C" int slstm_scan(const void* wx, const void* r, const void* state0,
                          void* hs, void* state_out, int s, int b, int h,
                          int hd, void* stream) {
  if (hd < 1 || hd > MAX_HD || b < 1 || h < 1 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((4 * hd + 31) / 32) * 32;
  slstm_scan_kernel<<<b * h, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wx), static_cast<const float*>(r),
      static_cast<const float*>(state0), static_cast<float*>(hs),
      static_cast<float*>(state_out), s, b, h, hd);
  return static_cast<int>(cudaGetLastError());
}
