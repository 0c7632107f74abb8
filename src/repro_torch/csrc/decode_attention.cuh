// Decode attention over a quantized KV cache, for Hopper: the body that
// q8_attention.cu and q4_attention.cu share. Each source instantiates it
// for its code format, a small trait:
//
//   struct Fmt {
//     using code_t = ...;                      // storage type of a code row
//     // dot of K scale block blk (32 codes) of a 16-byte aligned row with
//     // qv[0..31], before the block's scale
//     static __device__ float dot_block(const code_t* row, int blk,
//                                       const float* qv);
//     // the code of head dim d in a V row, unbiased
//     static __device__ float code(const code_t* row, int d);
//   };
//
// One block per (lane, query, head): Q is 1 in plain decode and spec_k in
// the speculative verify, where each query has its own length (the
// verify's token j attends [0, pos + j]). The cache is read in place
// through strides, with the layer folded into the base pointer and the KV
// head chosen by index (kv head = h // (H / Hkv)); only positions
// [0, length) are read, and a query of length 0 returns 0.
//
// The softmax takes two passes over scores held in shared memory: the K
// pass gives each thread whole cache rows (16-byte loads, dequantized in
// registers, one scale per 32 codes) and stores the row's score; a
// block-wide max, then a pass that turns the scores into exp(s - max)
// and a block-wide sum; then the V pass gives each thread one head dim
// over a strided subset of the rows, and the partial sums are reduced in
// shared memory. A block holds D + S + NT + NT/32 floats of shared memory,
// which bounds S at (232448 / 4) - D - 132, about 58 000 positions on
// Hopper (kernels/decode.py checks it before each launch). The dequantized
// cache never exists outside registers. The query and output are bf16, as
// on the port's decode path.

#pragma once

#include "common.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 32;
constexpr int NT = 128;
constexpr int NWARP = NT / 32;

using T = __nv_bfloat16;

__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARP; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < NWARP; ++w) r += red[w];
  return r;
}

template <class Fmt>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, long long q_sb, long long q_sq,
                        long long q_sh, const typename Fmt::code_t* __restrict__ kc,
                        const typename Fmt::code_t* __restrict__ vc, long long kv_sb,
                        long long kv_ss, long long kv_sh,
                        const __half* __restrict__ ks, const __half* __restrict__ vs,
                        long long sc_sb, long long sc_ss, long long sc_sh,
                        const int* __restrict__ lens, T* __restrict__ o,
                        long long o_sb, long long o_sq, long long o_sh, int Q,
                        int H, int Hkv, int S, int D, float scale) {
  using code_t = typename Fmt::code_t;
  extern __shared__ float smem[];
  float* qs = smem;            // D: the query, f32
  float* sc = qs + D;          // S: scores, then softmax numerators
  float* red = sc + S;         // NWARP: reduction slots
  float* part = red + NWARP;   // NT: partial outputs of the V pass

  const int tid = threadIdx.x;
  const int h = blockIdx.x % H;
  const int qi = (blockIdx.x / H) % Q;
  const int b = blockIdx.x / (H * Q);
  const int hk = h / (H / Hkv);
  int len = lens[b * Q + qi];
  len = len < 0 ? 0 : (len > S ? S : len);
  T* out = o + b * o_sb + qi * o_sq + h * o_sh;
  if (len == 0) {
    for (int d = tid; d < D; d += NT) out[d] = from_f32<T>(0.f);
    return;
  }

  const T* qrow = q + b * q_sb + qi * q_sq + h * q_sh;
  for (int d = tid; d < D; d += NT) qs[d] = to_f32(qrow[d]);
  __syncthreads();

  // K pass: one cache row per thread, scale per 32 codes
  const code_t* kbase = kc + b * kv_sb + hk * kv_sh;
  const __half* ksbase = ks + b * sc_sb + hk * sc_sh;
  const int nblk = D / QBLOCK;
  float mloc = -INFINITY;
  for (int j = tid; j < len; j += NT) {
    const code_t* row = kbase + j * kv_ss;
    const __half* srow = ksbase + j * sc_ss;
    float s = 0.f;
    for (int blk = 0; blk < nblk; ++blk)
      s = fmaf(Fmt::dot_block(row, blk, qs + blk * QBLOCK), __half2float(srow[blk]), s);
    s *= scale;
    sc[j] = s;
    mloc = fmaxf(mloc, s);
  }
  const float mx = block_max(mloc, red);

  float lloc = 0.f;
  for (int j = tid; j < len; j += NT) {
    const float p = expf(sc[j] - mx);
    sc[j] = p;
    lloc += p;
  }
  const float lsum = block_sum(lloc, red);  // its barrier publishes sc

  // V pass: thread (g, d) sums rows g, g + G, ... of head dim d
  const int groups = NT / D;
  const int g = tid / D;
  const int d = tid % D;
  float a = 0.f;
  if (g < groups) {
    const code_t* vbase = vc + b * kv_sb + hk * kv_sh;
    const __half* vscol = vs + b * sc_sb + hk * sc_sh + d / QBLOCK;
    for (int j = g; j < len; j += groups) {
      const float w = sc[j] * __half2float(vscol[j * sc_ss]);
      a = fmaf(w, Fmt::code(vbase + j * kv_ss, d), a);
    }
  }
  part[tid] = a;
  __syncthreads();
  if (tid < D) {
    float tot = 0.f;
    for (int gg = 0; gg < groups; ++gg) tot += part[gg * D + tid];
    out[tid] = from_f32<T>(tot / lsum);
  }
}

// The host side of both entry points: checks D, raises the block's
// shared-memory limit where S needs it and launches B * Q * H blocks.
template <class Fmt>
int launch_decode_attention(
    const void* q, long long q_sb, long long q_sq, long long q_sh,
    const void* kc, const void* vc, long long kv_sb, long long kv_ss,
    long long kv_sh, const void* ks, const void* vs, long long sc_sb,
    long long sc_ss, long long sc_sh, const void* lens, void* o,
    long long o_sb, long long o_sq, long long o_sh, int B, int Q, int H,
    int Hkv, int S, int D, void* stream) {
  using code_t = typename Fmt::code_t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % QBLOCK || D > NT) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const size_t smem = sizeof(float) * (size_t)(D + S + NWARP + NT);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<Fmt>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_attention_kernel<Fmt><<<B * Q * H, NT, smem, s>>>(
      static_cast<const T*>(q), q_sb, q_sq, q_sh, static_cast<const code_t*>(kc),
      static_cast<const code_t*>(vc), kv_sb, kv_ss, kv_sh,
      static_cast<const __half*>(ks), static_cast<const __half*>(vs), sc_sb,
      sc_ss, sc_sh, static_cast<const int*>(lens), static_cast<T*>(o), o_sb,
      o_sq, o_sh, Q, H, Hkv, S, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
