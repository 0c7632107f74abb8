// Decode attention over a quantized KV cache, for Hopper: the body that
// q8_attention.cu and q4_attention.cu share. Each source instantiates it
// for its code format, a small trait over the 16 codes of one head row
// that a lane holds:
//
//   struct Fmt {
//     using code_t = ...;    // storage type of a code row
//     using raw_t = ...;     // 16 codes as loaded (16 bytes q8, 8 bytes q4)
//     // codes 16 * sub .. 16 * sub + 15 of a row
//     static __device__ raw_t load(const code_t* row, int sub);
//     // the 16 codes, unbiased, as f32 (exact)
//     static __device__ void widen16(raw_t r, float* c);
//   };
//
// The cache positions are split across CTAs (flash-decoding): a CTA
// takes one lane, one KV head and a chunk of positions, for up to RMAX
// query rows of that lane: the Q queries (1 in plain decode, spec_k in
// the speculative verify, each with its own length; the verify's token
// j attends [0, pos + j]) times the H / Hkv query heads that share the
// KV head. Each cache row is read once for all of them. The cache is
// read in place through strides, with the layer folded into the base
// pointer; only positions below the rows' largest length are read.
//
// In a CTA, a warp reads 32 / P rows at a time, P = D / 16 lanes a row
// (rounded up to a power of two), each lane 16 codes of K and of V with
// one load each, neighbouring lanes on neighbouring bytes, widened once
// for all query rows; the 32-code block's scale multiplies the lane's
// partial dot (K) and its softmax weight (V), never a code. Each lane
// keeps an online softmax (m, l and 16 dims of o per query row) over the
// positions its row slot read, two at a time; the CTA's 128 / P slots are
// merged through shared memory in slot order. A CTA holds the query rows
// in registers and at most RMAX x 64 x 36 floats of shared memory,
// whatever S is: S is bounded by the int positions only.
// With one chunk the CTA writes the output; with several, each chunk
// writes its (m, l, o) partial for each query row (m = -1e30, l = 0, o =
// 0 where the chunk holds no position the row attends) and a second
// kernel, launched as a programmatic dependent, adds the chunks in chunk
// order: deterministic, no atomics. A query of length 0 returns 0. The
// dequantized cache never exists outside registers. The query and output
// are bf16, as on the port's decode path.

#pragma once

#include "common.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 32;
constexpr int NT = 128;
constexpr int NWARP = NT / 32;
constexpr int DL = 16;     // head dims a lane holds
constexpr int RMAX = 4;    // query rows a CTA
constexpr int TP = 2;      // positions a lane reads per step
constexpr float EMPTY = -1e30f;
constexpr int SLOTS = NT / 2;          // row slots of a CTA, at most (D <= 32)
constexpr int O_FLOATS = SLOTS * 33;   // slots x (D + 1), at most

using T = __nv_bfloat16;

template <class Fmt, int RT>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, long long q_sb, long long q_sq,
                        long long q_sh, const typename Fmt::code_t* __restrict__ kc,
                        const typename Fmt::code_t* __restrict__ vc, long long kv_sb,
                        long long kv_ss, long long kv_sh,
                        const __half* __restrict__ ks, const __half* __restrict__ vs,
                        long long sc_sb, long long sc_ss, long long sc_sh,
                        const int* __restrict__ lens, T* __restrict__ o,
                        long long o_sb, long long o_sq, long long o_sh,
                        float* __restrict__ part, int Q, int H, int Hkv, int S,
                        int D, int chunk, float scale_log2) {
  using code_t = typename Fmt::code_t;
  using raw_t = typename Fmt::raw_t;
  // the row slots' partial softmaxes: m (then its weight), l, and o at a
  // pitch of D + 1 (no bank conflicts between the slots' lanes)
  __shared__ float sm_m[RT][SLOTS], sm_w[RT][SLOTS], sm_l[RT][SLOTS];
  __shared__ float sm_mx[RT];
  __shared__ float sm_o[RT][O_FLOATS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, nch = gridDim.x;
  const int G = H / Hkv;
  const int R = Q * G;
  const int rgs = (R + RT - 1) / RT;
  const int hk = blockIdx.y / rgs, rg = blockIdx.y % rgs;
  const int b = blockIdx.z;
  // let the combine kernel be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");

  const int P = D <= 32 ? 2 : (D <= 64 ? 4 : 8);   // lanes a row
  const int RW = 32 / P;                           // rows a warp
  const int sub = lane & (P - 1);
  const int grp = lane / P;
  const bool dims = sub * DL < D;

  // this CTA's query rows: row j = rg * RT + r is query j / G of head
  // hk * G + j % G. Every row's length and query slice are loaded before
  // any is used, so the loads are in flight together.
  int len[RT];
  uint4 qraw[RT][2];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int j = min(rg * RT + r, R - 1);
    const int qi = j / G, h = hk * G + j % G;
    len[r] = lens[b * Q + qi];
    const uint4* qrow = reinterpret_cast<const uint4*>(
        q + b * q_sb + qi * q_sq + h * q_sh + (dims ? sub * DL : 0));
    qraw[r][0] = qrow[0];
    qraw[r][1] = qrow[1];
  }
  int lmax = 0;
  float qv[RT][DL];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const bool row = rg * RT + r < R;
    len[r] = row ? min(max(len[r], 0), S) : 0;
    lmax = max(lmax, len[r]);
    const T* qh = reinterpret_cast<const T*>(qraw[r]);
#pragma unroll
    for (int e = 0; e < DL; ++e)
      qv[r][e] = row && dims ? to_f32(qh[e]) * scale_log2 : 0.f;
  }

  float m[RT], l[RT], acc[RT][DL];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = EMPTY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] = 0.f;
  }

  const int p0 = c * chunk;
  const int p1 = min(min(p0 + chunk, S), lmax);
  const code_t* const kbase = kc + b * kv_sb + hk * kv_sh;
  const code_t* const vbase = vc + b * kv_sb + hk * kv_sh;
  const __half* const ksb = ks + b * sc_sb + hk * sc_sh + sub / 2;
  const __half* const vsb = vs + b * sc_sb + hk * sc_sh + sub / 2;
  // a step: TP positions a lane, RW x NWARP x TP positions the CTA; the
  // loop's bound is the same for every lane of a warp (the shuffles)
  for (int base = p0 + warp * RW + grp; base - grp < p1;
       base += NWARP * RW * TP) {
    raw_t kr[TP], vr[TP];
    float ksc[TP], vsc[TP];
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      const int p = base + t * NWARP * RW;
      const bool ok = p < p1 && dims;
      kr[t] = ok ? Fmt::load(kbase + p * kv_ss, sub) : raw_t{};
      vr[t] = ok ? Fmt::load(vbase + p * kv_ss, sub) : raw_t{};
      ksc[t] = ok ? __half2float(ksb[p * sc_ss]) : 0.f;
      vsc[t] = ok ? __half2float(vsb[p * sc_ss]) : 0.f;
    }
    // scores of the TP positions for every row, each K row widened once
    float sc[RT][TP];
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float kf[DL];
      Fmt::widen16(kr[t], kf);
      const int p = base + t * NWARP * RW;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < DL; ++e) d = fmaf(qv[r][e], kf[e], d);
        d *= ksc[t];
        for (int off = 1; off < P; off <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        sc[r][t] = p >= p1 || p >= len[r] ? -INFINITY : d;
      }
    }
    // the online update: one rescale a step, then the weights
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mn = m[r];
#pragma unroll
      for (int t = 0; t < TP; ++t) mn = fmaxf(mn, sc[r][t]);
      const float a = exp2f(m[r] - mn);
      l[r] *= a;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[r][e] *= a;
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        sc[r][t] = exp2f(sc[r][t] - mn);
        l[r] += sc[r][t];
      }
      m[r] = mn;
    }
    // each V row widened once, added to every row's output
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float vf[DL];
      Fmt::widen16(vr[t], vf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float w = sc[r][t] * vsc[t];
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[r][e] = fmaf(w, vf[e], acc[r][e]);
      }
    }
  }

  // merge the CTA's NT / P row slots (slot = warp x RW + grp, each a
  // partial softmax over the positions its lanes read) through shared
  // memory: each slot's m, l and o; then each row's max and the slots'
  // weights 2^(m_s - max), one warp a row; then each output the sum of
  // the slots' o in slot order
  const int slots = NT / P;
  const int slot = warp * RW + grp;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (sub == 0) {
      sm_m[r][slot] = m[r];
      sm_l[r][slot] = l[r];
    }
    if (dims) {
#pragma unroll
      for (int e = 0; e < DL; ++e) sm_o[r][slot * (D + 1) + sub * DL + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int r = warp; r < RT; r += NWARP) {
    float mx = EMPTY;
    for (int sl = lane; sl < slots; sl += 32) mx = fmaxf(mx, sm_m[r][sl]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int sl = lane; sl < slots; sl += 32) sm_w[r][sl] = exp2f(sm_m[r][sl] - mx);
    if (lane == 0) sm_mx[r] = mx;
  }
  __syncthreads();

  // then the output, or this chunk's partial
  for (int e = tid; e < RT * D; e += NT) {
    const int r = e / D, d = e % D;
    const int j = rg * RT + r;
    if (j >= R) continue;
    float ll = 0.f, oo = 0.f;
    for (int sl = 0; sl < slots; ++sl) {
      ll = fmaf(sm_l[r][sl], sm_w[r][sl], ll);
      oo = fmaf(sm_o[r][sl * (D + 1) + d], sm_w[r][sl], oo);
    }
    const float mm = sm_mx[r];
    const int qi = j / G, h = hk * G + j % G;
    if (nch == 1) {
      o[b * o_sb + qi * o_sq + h * o_sh + d] = from_f32<T>(ll > 0.f ? oo / ll : 0.f);
    } else {
      const size_t row = ((size_t)b * Q + qi) * H + h;
      float* const pr = part + (row * nch + c) * (D + 2);
      pr[2 + d] = oo;
      if (d == 0) {
        pr[0] = mm;
        pr[1] = ll;
      }
    }
  }
}

// o = the chunks' partials of each query row merged in chunk order.
// Launched as the programmatic dependent of the kernel that wrote them:
// it may start while that kernel runs and waits here until its grid has
// finished and its writes are visible. One CTA a (lane, query, head), one
// thread a head dim.
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      T* __restrict__ o, long long o_sb,
                                      long long o_sq, long long o_sh, int Q,
                                      int H, int D, int nch) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = blockIdx.x, d = threadIdx.x;
  const int h = row % H, qi = (row / H) % Q, b = row / (H * Q);
  const float* const pr = part + (size_t)row * nch * (D + 2);
  float mx = EMPTY;
  for (int c = 0; c < nch; ++c) mx = fmaxf(mx, pr[c * (D + 2)]);
  float l = 0.f, a = 0.f;
  for (int c = 0; c < nch; ++c) {
    const float* const p = pr + c * (D + 2);
    const float w = exp2f(p[0] - mx);
    l = fmaf(p[1], w, l);
    a = fmaf(p[2 + d], w, a);
  }
  o[b * o_sb + qi * o_sq + h * o_sh + d] = from_f32<T>(l > 0.f ? a / l : 0.f);
}

// The host side of both entry points: checks D and the chunk plan,
// launches (nchunks, Hkv x row groups, B) CTAs and, with more than one
// chunk, the combine kernel as their programmatic dependent.
template <class Fmt>
int launch_decode_attention(
    const void* q, long long q_sb, long long q_sq, long long q_sh,
    const void* kc, const void* vc, long long kv_sb, long long kv_ss,
    long long kv_sh, const void* ks, const void* vs, long long sc_sb,
    long long sc_ss, long long sc_sh, const void* lens, void* o,
    long long o_sb, long long o_sq, long long o_sh, void* part, int B, int Q,
    int H, int Hkv, int S, int D, int chunk, int nch, void* stream) {
  using code_t = typename Fmt::code_t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the query rows are read as 16-byte words
  const bool q16 = (reinterpret_cast<uintptr_t>(q) & 15) == 0 && q_sb % 8 == 0 &&
                   q_sq % 8 == 0 && q_sh % 8 == 0;
  if (D % QBLOCK || D > 128 || D <= 0 || Hkv <= 0 || H % Hkv || chunk <= 0 ||
      nch <= 0 || (long long)chunk * nch < S || (nch > 1 && part == nullptr) ||
      !q16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  const int R = Q * (H / Hkv);
  const int rt = R >= 3 ? RMAX : R;   // rows a CTA: 1, 2 or RMAX
  const dim3 grid(nch, Hkv * ((R + rt - 1) / rt), B);
#define REPRO_DECODE_LAUNCH(RT_)                                              \
  decode_attention_kernel<Fmt, RT_><<<grid, NT, 0, s>>>(                      \
      static_cast<const T*>(q), q_sb, q_sq, q_sh,                             \
      static_cast<const code_t*>(kc), static_cast<const code_t*>(vc), kv_sb,  \
      kv_ss, kv_sh, static_cast<const __half*>(ks),                           \
      static_cast<const __half*>(vs), sc_sb, sc_ss, sc_sh,                    \
      static_cast<const int*>(lens), static_cast<T*>(o), o_sb, o_sq, o_sh,    \
      static_cast<float*>(part), Q, H, Hkv, S, D, chunk, scale_log2)
  if (rt == 1) REPRO_DECODE_LAUNCH(1);
  else if (rt == 2) REPRO_DECODE_LAUNCH(2);
  else REPRO_DECODE_LAUNCH(4);
#undef REPRO_DECODE_LAUNCH
  if (nch > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(B * Q * H);
    cfg.blockDim = dim3(D);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, decode_combine_kernel,
                       static_cast<const float*>(part), static_cast<T*>(o),
                       o_sb, o_sq, o_sh, Q, H, D, nch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
