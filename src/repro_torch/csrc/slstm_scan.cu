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
// <= 0, so saturated gates (i >> 0, f << 0) neither overflow nor NaN. R is
// f32 or bf16 as stored; the kernel widens it as it reads it (a bf16 value
// is exact in f32 and f64, so every product is the same).
//
// Bound on this card: the step is sequential, so the time grows with S
// whatever the bound says; a step is a chain of a dot of h against R, the
// cell update and the hand-over of h to the next step. At full xlstm-350m
// width (H = 4, hd = 256) R is 1 MB of f32 a head, against 227 KB of
// shared memory a block. Two layouts, chosen by the wrapper (kernels/
// slstm_scan/ops.py, plan) and checked here:
//
//  * Cluster (hd = 256): a thread block cluster of C CTAs (8 or 16) per
//    (head, group of up to 4 lanes). Rank r owns 256 / C output columns of
//    all four gates and holds that slice of R in registers for the whole
//    launch (loaded once through shared memory with 16-byte loads): 64 KB
//    a rank, as f64 at C = 16 (no conversion in the step) or as f32 at C =
//    8 (widened once a step, shared by the lanes). A warp owns 256 / C /
//    16 columns; its lane L holds rows e = 32 j + L (j < 8) of the four
//    gates of those columns. Each step, every rank computes its columns'
//    dots for every lane of the group from h_{t-1} (f64, in shared memory;
//    a warp reads 32 consecutive values at once), sums them over the warp
//    by halving (each lane keeps half of its sums a level), hands each
//    (column, lane) its four gates, runs the cell update there, writes h_t
//    (widened) into every rank's shared memory (distributed shared
//    memory, double-buffered, the warp's values side by side) with
//    st.async, which counts the bytes on the receiving rank's mbarrier:
//    the next step waits on its own barrier only, with no fence and no
//    cluster-wide barrier. wx is loaded three steps ahead. R is read (and,
//    at C = 8, widened) once a step for all lanes of a group; 4 heads x 16
//    ranks run on 64 SMs.
//  * One CTA per (lane, head) (any other hd up to 256): one thread per
//    (gate, column) pair, 4 * hd threads; h_{t-1} sits in shared memory,
//    already widened, R's rows are read from L2 coalesced along the column
//    axis with four independent partial sums, and the threads of gate 0
//    hold (c, n, m) of their column across all steps. Bound by one SM's
//    instruction issue (a load and a conversion a product).
//
// state0 is read once (decode resumes from a lane's pool state), every
// step's h is written, and the final (c, n, h, m) once at the end.

#include "common.cuh"
#include "tensor_core.cuh"
#include <cooperative_groups.h>
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

// Measurement builds only (kernels/slstm_scan/probe.py times them beside
// the shipped build, SLSTM_PROBE 0, which is the only one the port loads):
// they take parts out of the cluster layout's step to time the rest.
// 1: no dot (the step's fixed cost: wx, the cell update, the hand-over of
// h to the other ranks); 2: no dot and no cell update; 3: no hand-over
// either (the step's loads of wx and stores of h).
#ifndef SLSTM_PROBE
#define SLSTM_PROBE 0
#endif

namespace {

constexpr int MAX_HD = 256;

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

// One cell update from the rounded pre-activations; updates (c, n, m) and
// returns h.
__device__ __forceinline__ float cell(float i_r, float f_r, float z_r,
                                      float o_r, float& c, float& n,
                                      float& m) {
  const float logf = log_sigmoid(f_r);
  const float lm = __fadd_rn(logf, m);
  const float m_new = fmaxf(lm, i_r);
  const float i_g = expf(__fsub_rn(i_r, m_new));
  const float f_g = expf(__fsub_rn(lm, m_new));
  c = __fadd_rn(__fmul_rn(f_g, c), __fmul_rn(i_g, tanhf(z_r)));
  n = __fadd_rn(__fmul_rn(f_g, n), i_g);
  m = m_new;
  return __fdiv_rn(__fmul_rn(sigmoid(o_r), c), fmaxf(n, 1e-6f));
}

// ---------------------------------------------------------------------------
// One CTA per (lane, head)
// ---------------------------------------------------------------------------

template <typename TR>
__global__ void __launch_bounds__(4 * MAX_HD)
slstm_scan_kernel(const float* __restrict__ wx, const TR* __restrict__ r,
                  const float* __restrict__ state0, float* __restrict__ hs,
                  float* __restrict__ state_out, int S, int B, int H,
                  int hd) {
  __shared__ double sh_h[MAX_HD];     // h_{t-1}, widened once a step
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
  const TR* __restrict__ rcol =
      r + ((size_t)(dot ? g : 0) * H + head) * hd * hd + f;

  // the column state of the cell-update threads
  const bool is_cell = tid < hd;
  float c = 0.f, n = 0.f, h = 0.f, m = 0.f;
  if (is_cell) {
    c = state0[base + tid];
    n = state0[plane + base + tid];
    h = state0[2 * plane + base + tid];
    m = state0[3 * plane + base + tid];
    sh_h[tid] = (double)h;
  }
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    if (dot) {
      double acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
      int e = 0;
      for (; e + 4 <= hd; e += 4) {
        acc0 = fma(sh_h[e], (double)to_f32(rcol[(size_t)e * hd]), acc0);
        acc1 = fma(sh_h[e + 1], (double)to_f32(rcol[(size_t)(e + 1) * hd]),
                   acc1);
        acc2 = fma(sh_h[e + 2], (double)to_f32(rcol[(size_t)(e + 2) * hd]),
                   acc2);
        acc3 = fma(sh_h[e + 3], (double)to_f32(rcol[(size_t)(e + 3) * hd]),
                   acc3);
      }
      for (; e < hd; ++e)
        acc0 = fma(sh_h[e], (double)to_f32(rcol[(size_t)e * hd]), acc0);
      const float w = wx[((size_t)t * 4 + g) * plane + base + f];
      sh_pre[g * hd + f] =
          __fadd_rn(w, __double2float_rn((acc0 + acc1) + (acc2 + acc3)));
    }
    __syncthreads();
    if (is_cell) {
      h = cell(sh_pre[tid], sh_pre[hd + tid], sh_pre[2 * hd + tid],
               sh_pre[3 * hd + tid], c, n, m);
      sh_h[tid] = (double)h;
      hs[(size_t)t * plane + base + tid] = h;
    }
    __syncthreads();
  }

  if (is_cell) {
    state_out[base + tid] = c;
    state_out[plane + base + tid] = n;
    state_out[2 * plane + base + tid] = h;
    state_out[3 * plane + base + tid] = m;
  }
}

// ---------------------------------------------------------------------------
// Cluster layout: hd = 256, C CTAs per (head, group of up to 4 lanes)
// ---------------------------------------------------------------------------

constexpr int CL_HD = 256;             // the cluster layout's head width
constexpr int CL_WARPS = 16;
constexpr int CL_NT = CL_WARPS * 32;
constexpr int CL_BT = 4;               // lanes of a cluster, at most

template <int C>
struct Cl {
  static constexpr int COLS = CL_HD / C;        // columns of a rank
  static constexpr int CPW = COLS / CL_WARPS;   // columns of a warp
  static constexpr int ROW = COLS + 1;          // staged row stride (odd)
  static constexpr int GATE = CL_HD * ROW;      // staged gate stride
  // R as a thread holds it: f64 where it fits (no conversion a step)
  using RT = typename std::conditional<C == 16, double, float>::type;
};

template <int C, int BT>
constexpr size_t cl_smem() {
  return sizeof(double) * 2 * BT * CL_HD + sizeof(float) * 4 * Cl<C>::GATE;
}

// the shared::cluster address of local shared memory p in rank `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// 8 or 16 bytes into another rank's shared memory, completing as many
// bytes of transactions on that rank's barrier `bar`
__device__ __forceinline__ void st_async(uint32_t dst, double a,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f64 [%0], %1, "
      "[%2];\n" ::"r"(dst), "d"(a), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(uint32_t dst, double a, double b,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(dst), "d"(a), "d"(b), "r"(bar) : "memory");
}

// wait (acquiring at cluster scope) until the phase of parity `parity`
// of the local barrier has completed; a phase that never completes traps
// after 2^22 polls instead of hanging the device
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  for (int i = 0; i < (1 << 22) && !done; ++i)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  if (!done) __trap();
}

// The V sums of each lane (V a power of two <= 32) over the 32 lanes of a
// warp. At xor offsets 1, 2, 4, ... a lane keeps one half of its values,
// adds its partner's copy of that half and sends the other half; once one
// value is left, the remaining levels add it whole. Lane L then holds the
// total of value bitrev(L mod V) (its low log2 V bits reversed). The order
// of every sum is fixed.
template <int V, int OFF>
__device__ __forceinline__ void warp_sum_scatter(double* v, int lane) {
  if constexpr (OFF < 32) {
    if constexpr (V > 1) {
      constexpr int H = V / 2;
      const bool up = lane & OFF;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const double send = up ? v[j] : v[j + H];
        const double keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      warp_sum_scatter<H, OFF * 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      warp_sum_scatter<1, OFF * 2>(v, lane);
    }
  }
}

template <int V>
__host__ __device__ constexpr int log2_of() {
  if constexpr (V <= 1) return 0;
  else return 1 + log2_of<V / 2>();
}

// CTA (rank r of the cluster along grid dim x, head blockIdx.y, lanes
// [4 blockIdx.z, + BT)). Warp w owns the CPW columns r * COLS + w * CPW +
// c; its lane L holds R[g][e][column] for the 4 gates, the CPW columns and
// rows e = 32 j + L (j < 8), so a warp's reads of h are 32 consecutive
// f64 and its dots end in one sum over the warp. Cell slot q = lane < CPW
// * BT: column c = q / BT, lane b = q % BT.
template <int C, int BT, typename TR>
__global__ void __launch_bounds__(CL_NT, 1)
slstm_cluster_kernel(const float* __restrict__ wx, const TR* __restrict__ r,
                     const float* __restrict__ state0, float* __restrict__ hs,
                     float* __restrict__ state_out, int S, int B, int H) {
  using L = Cl<C>;
  using RT = typename L::RT;
  constexpr int COLS = L::COLS, CPW = L::CPW, Q = CPW * BT;
  constexpr int V = CPW * 4 * BT;       // dots a lane adds: (c, g, b)
  constexpr int LOGV = log2_of<V>();
  static_assert(Q <= 8 && V <= 32 && (1 << LOGV) == V, "slots and sums");
  extern __shared__ double2 cl_raw[];
  __shared__ uint64_t full[2];   // h_t of all ranks in buffer (t + 1) & 1
  double* const hbuf = reinterpret_cast<double*>(cl_raw);   // [2][HD][BT]
  float* const stage = reinterpret_cast<float*>(hbuf + 2 * BT * CL_HD);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;
  const int head = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t plane = (size_t)B * H * CL_HD;

  // this rank's columns of R as f32 in shared memory, 16-byte loads
  {
    constexpr int EV = 16 / sizeof(TR);       // elements a load
    constexpr int CPR = COLS / EV;            // loads a row
    constexpr int TOTAL = 4 * CL_HD * CPR;
    constexpr int BATCH = 8;
    const TR* const rb = r + (size_t)head * CL_HD * CL_HD + rank * COLS;
    for (int i0 = tid; i0 < TOTAL; i0 += BATCH * CL_NT) {
      uint4 raw[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int idx = i0 + u * CL_NT;
        const int row = idx / CPR, ch = idx % CPR;   // row = gate * HD + e
        raw[u] = idx < TOTAL
            ? __ldg(reinterpret_cast<const uint4*>(
                  rb + ((size_t)(row / CL_HD) * H * CL_HD + row % CL_HD) *
                           CL_HD + ch * EV))
            : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int idx = i0 + u * CL_NT;
        if (idx >= TOTAL) break;
        const int row = idx / CPR, ch = idx % CPR;
        float* dst = stage + (row / CL_HD) * L::GATE +
                     (row % CL_HD) * L::ROW + ch * EV;
        const TR* v = reinterpret_cast<const TR*>(&raw[u]);
#pragma unroll
        for (int k = 0; k < EV; ++k) dst[k] = to_f32(v[k]);
      }
    }
  }
  // h_{-1} of the group's lanes, widened (0 for lanes past B): BT * 256
  // values, at most two a thread, both loads in flight
  {
    double v[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * CL_NT, b = i / CL_HD, e = i % CL_HD;
      v[u] = i < BT * CL_HD && b0 + b < B
          ? (double)state0[2 * plane + ((size_t)(b0 + b) * H + head) * CL_HD +
                           e]
          : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * CL_NT;
      if (i < BT * CL_HD) hbuf[(i % CL_HD) * BT + i / CL_HD] = v[u];
    }
  }
  __syncthreads();
  RT rr[CPW][4][8];
#pragma unroll
  for (int c = 0; c < CPW; ++c)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rr[c][g][j] = (RT)stage[g * L::GATE + (32 * j + lane) * L::ROW +
                                warp * CPW + c];

  const int cq = lane / BT, bq = lane % BT;
  const int col = rank * COLS + warp * CPW + cq;
  const bool slot = lane < Q && b0 + bq < B;
  const size_t at = ((size_t)(b0 + bq) * H + head) * CL_HD + col;
  float c_st = 0.f, n_st = 0.f, h_st = 0.f, m_st = 0.f;
  if (slot) {
    c_st = state0[at];
    n_st = state0[plane + at];
    h_st = state0[2 * plane + at];
    m_st = state0[3 * plane + at];
  }
  // lane holding slot (cq, bq)'s sum of gate g
  int src[4];
#pragma unroll
  for (int g = 0; g < 4; ++g)
    src[g] = __brev(((cq * 4 + g) * BT + bq) & (V - 1)) >> (32 - LOGV);
  // the slot's wx, three steps ahead of its use
  auto load_wx = [&](float (&w)[4], int t) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      w[g] = slot && t < S ? wx[((size_t)t * 4 + g) * plane + at] : 0.f;
  };
  float w0[4], w1[4], w2[4], w3[4];
  load_wx(w0, 0);
  load_wx(w1, 1);
  load_wx(w2, 2);
  // each buffer's barrier: one local arrival (with the bytes to expect)
  // and every rank's st.async of its slice of h_t a phase. Every rank has
  // started and initialised them before any writes into another (the
  // cluster's barrier); one step needs neither
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  if (S > 1) cluster.sync();

  for (int t = 0; t < S; ++t) {
    const double* const hb = hbuf + (t & 1) * BT * CL_HD;
#if SLSTM_PROBE <= 2
    // h_{t-1} of all ranks (the k-th use of buffer t & 1 has parity k & 1)
    if (t > 0) mbar_wait_cluster(&full[t & 1], ((t - 1) >> 1) & 1);
#endif
    double acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0;
#if SLSTM_PROBE == 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      double hv[BT];   // h[b][32 j + lane], b < BT: BT neighbouring values
      if constexpr (BT == 1) {
        hv[0] = hb[32 * j + lane];
      } else {
#pragma unroll
        for (int b = 0; b < BT; b += 2) {
          const double2 h2 = *reinterpret_cast<const double2*>(
              hb + (32 * j + lane) * BT + b);
          hv[b] = h2.x;
          hv[b + 1] = h2.y;
        }
      }
#pragma unroll
      for (int c = 0; c < CPW; ++c)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const double rv = (double)rr[c][g][j];
#pragma unroll
          for (int b = 0; b < BT; ++b)
            acc[(c * 4 + g) * BT + b] = fma(hv[b], rv, acc[(c * 4 + g) * BT + b]);
        }
    }
    warp_sum_scatter<V, 1>(acc, lane);
#endif
    const float dot = __double2float_rn(acc[0]);
    float pre[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      pre[g] = __fadd_rn(w0[g], __shfl_sync(0xffffffffu, dot, src[g]));
#if SLSTM_PROBE <= 1
    const float h_new = cell(pre[0], pre[1], pre[2], pre[3], c_st, n_st,
                             m_st);
#else
    const float h_new = pre[0];
#endif
    h_st = h_new;
    if (t + 1 < S) {
      // the warp's Q values of h_t (slot q = column c, lane b) lie side by
      // side in every rank's other buffer: lane 16 + r writes them into
      // rank r with st.async, which counts their bytes on rank r's
      // barrier; thread 0 expects all ranks' bytes on its own. No fence
      // and no cluster-wide barrier: a rank writes h_{t+1} into a buffer
      // only after it has every h_t, so after the owner has read h_{t-1}
      // from it and moved that barrier past its phase
      double hq[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q)
        hq[q] = (double)__shfl_sync(0xffffffffu, h_new, q);
#if SLSTM_PROBE <= 2
      const int nb = (t + 1) & 1;
      if (tid == 0) mbar_expect_tx(&full[nb], BT * CL_HD * sizeof(double));
      if (lane >= 16 && lane < 16 + C) {
        const uint32_t dst = cluster_addr(
            hbuf + nb * BT * CL_HD + (rank * COLS + warp * CPW) * BT,
            lane - 16);
        const uint32_t bar = cluster_addr(&full[nb], lane - 16);
        if constexpr (Q == 1) {
          st_async(dst, hq[0], bar);
        } else {
#pragma unroll
          for (int q = 0; q < Q; q += 2)
            st_async(dst + q * sizeof(double), hq[q], hq[q + 1], bar);
        }
      }
#else
      (void)hq;
#endif
    }
    if (slot) hs[(size_t)t * plane + at] = h_new;
    load_wx(w3, t + 3);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      w0[g] = w1[g];
      w1[g] = w2[g];
      w2[g] = w3[g];
    }
  }

  if (slot) {
    state_out[at] = c_st;
    state_out[plane + at] = n_st;
    state_out[2 * plane + at] = h_st;
    state_out[3 * plane + at] = m_st;
  }
}

template <int C, int BT, typename TR>
int launch_cluster(const void* wx, const void* r, const void* state0,
                   void* hs, void* state_out, int s, int b, int h,
                   cudaStream_t stream) {
  auto kernel = slstm_cluster_kernel<C, BT, TR>;
  constexpr size_t smem = cl_smem<C, BT>();
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && C > 8)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, h, (b + BT - 1) / BT);
  cfg.blockDim = dim3(CL_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(wx), static_cast<const TR*>(r),
      static_cast<const float*>(state0), static_cast<float*>(hs),
      static_cast<float*>(state_out), s, b, h));
}

// clusters of C CTAs that can be resident at once (0: it cannot launch)
template <int C, int BT, typename TR>
int max_clusters(int h) {
  auto kernel = slstm_cluster_kernel<C, BT, TR>;
  constexpr size_t smem = cl_smem<C, BT>();
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  if (C > 8)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, h, 1);
  cfg.blockDim = dim3(CL_NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = C;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

template <int C, typename TR>
int launch_cluster_bt(const void* wx, const void* r, const void* state0,
                      void* hs, void* state_out, int s, int b, int h,
                      cudaStream_t stream) {
  if (b == 1)
    return launch_cluster<C, 1, TR>(wx, r, state0, hs, state_out, s, b, h, stream);
  if (b == 2)
    return launch_cluster<C, 2, TR>(wx, r, state0, hs, state_out, s, b, h, stream);
  return launch_cluster<C, CL_BT, TR>(wx, r, state0, hs, state_out, s, b, h,
                                      stream);
}

template <typename TR>
int launch_any(int layout, int cluster, const void* wx, const void* r,
               const void* state0, void* hs, void* state_out, int s, int b,
               int h, int hd, cudaStream_t stream) {
  if (layout == 0) {
    const int threads = ((4 * hd + 31) / 32) * 32;
    slstm_scan_kernel<TR><<<b * h, threads, 0, stream>>>(
        static_cast<const float*>(wx), static_cast<const TR*>(r),
        static_cast<const float*>(state0), static_cast<float*>(hs),
        static_cast<float*>(state_out), s, b, h, hd);
    return 0;
  }
  if (layout != 1 || hd != CL_HD ||
      (reinterpret_cast<uintptr_t>(r) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cluster == 8)
    return launch_cluster_bt<8, TR>(wx, r, state0, hs, state_out, s, b, h, stream);
  if (cluster == 16)
    return launch_cluster_bt<16, TR>(wx, r, state0, hs, state_out, s, b, h, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// wx (S, 4, B, H, hd), state0 and state_out (4, B, H, hd), hs (S, B, H,
// hd): float32; r (4, H, hd, hd) float32 (r_dtype 0) or bfloat16 (1); all
// contiguous; 1 <= hd <= 256. layout 0: one CTA per (lane, head); layout
// 1: the cluster layout (hd = 256, r 16-byte aligned) with `cluster` CTAs
// a head (8 or 16). Anything else returns cudaErrorInvalidValue.
extern "C" int slstm_scan(const void* wx, const void* r, const void* state0,
                          void* hs, void* state_out, int s, int b, int h,
                          int hd, int r_dtype, int layout, int cluster,
                          void* stream) {
  if (hd < 1 || hd > MAX_HD || b < 1 || h < 1 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = static_cast<int>(cudaErrorInvalidValue);
  if (r_dtype == 0)
    rc = launch_any<float>(layout, cluster, wx, r, state0, hs, state_out, s,
                           b, h, hd, st);
  else if (r_dtype == 1)
    rc = launch_any<__nv_bfloat16>(layout, cluster, wx, r, state0, hs,
                                   state_out, s, b, h, hd, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the cluster layout (`cluster` CTAs, f32 R, 4 lanes) that the
// device can hold at once: 0 where it cannot launch that size.
extern "C" int slstm_scan_max_clusters(int cluster, int h) {
  if (cluster == 8) return max_clusters<8, CL_BT, float>(h);
  if (cluster == 16) return max_clusters<16, CL_BT, float>(h);
  return 0;
}
