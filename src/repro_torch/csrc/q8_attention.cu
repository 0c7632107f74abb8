// Single-query decode attention over a Q8_0 KV cache, for Hopper.
//
// Replaces the TPU kernel q8_decode_attention_pallas (src/repro/kernels/
// q8_attention/q8_attention.py, _q8_attn_kernel): int8 K/V codes with one
// f16 scale per 32 elements along head_dim, dequantized next to the dot
// (paper C1), each lane b attending positions [0, length[b]). Unlike the
// TPU kernel it
//  * reads only positions [0, length) (no padded blocks of 128),
//  * reads the serving engine's stacked (L, B, S, Hkv, .) cache planes
//    in place through their strides, with the layer folded into the base
//    pointer and the KV head chosen by index (kv head = h // (H / Hkv)),
//    so the per-step repeat/transpose/copy of the reference's
//    _quant_cache_attention does not happen on the card,
//  * returns 0 for a lane of length 0 (nothing to attend).
//
// Bound on this card: bytes. Each code and scale is read once and feeds
// 2 FLOP (q.k and p.v), ~2 FLOP/byte against the H100's ~600 int8
// OP/byte ridge. Design: one block per (b, h); the K pass gives each
// thread whole cache rows, read as 16-byte vectors and dequantized in
// registers (one scale per 32 codes); scores stay in shared memory; a
// block-wide max and sum give the softmax; the V pass gives each thread
// one head dim over a strided subset of the rows, read coalesced across
// the warp, and the partial sums are reduced in shared memory. The
// dequantized cache never exists outside registers.
//
// The query and output are bf16, as on the port's decode path.

#include "common.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 32;
constexpr int NT = 128;
constexpr int NWARP = NT / 32;

// dot of four int8 codes packed little-endian in one int with q[0..3]
__device__ __forceinline__ float dot4(int packed, const float* qv) {
  return qv[0] * static_cast<float>(static_cast<int8_t>(packed & 0xff)) +
         qv[1] * static_cast<float>(static_cast<int8_t>((packed >> 8) & 0xff)) +
         qv[2] * static_cast<float>(static_cast<int8_t>((packed >> 16) & 0xff)) +
         qv[3] * static_cast<float>(static_cast<int8_t>((packed >> 24) & 0xff));
}

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

using T = __nv_bfloat16;

__global__ void __launch_bounds__(NT)
q8_decode_attention_kernel(const T* __restrict__ q, long long q_sb, long long q_sh,
                           const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
                           long long kv_sb, long long kv_ss, long long kv_sh,
                           const __half* __restrict__ ks, const __half* __restrict__ vs,
                           long long sc_sb, long long sc_ss, long long sc_sh,
                           const int* __restrict__ lens, T* __restrict__ o,
                           long long o_sb, long long o_sh, int H, int Hkv, int S,
                           int D, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;            // D: the query, f32
  float* sc = qs + D;          // S: scores, then softmax numerators
  float* red = sc + S;         // NWARP: reduction slots
  float* part = red + NWARP;   // NT: partial outputs of the V pass

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  int len = lens[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  T* out = o + b * o_sb + h * o_sh;
  if (len == 0) {
    for (int d = tid; d < D; d += NT) out[d] = from_f32<T>(0.f);
    return;
  }

  const T* qrow = q + b * q_sb + h * q_sh;
  for (int d = tid; d < D; d += NT) qs[d] = to_f32(qrow[d]);
  __syncthreads();

  // K pass: one cache row per thread, 16-byte loads, scale per 32 codes
  const int8_t* kbase = kq + b * kv_sb + hk * kv_sh;
  const __half* ksbase = ks + b * sc_sb + hk * sc_sh;
  const int nblk = D / QBLOCK;
  float mloc = -INFINITY;
  for (int j = tid; j < len; j += NT) {
    const int4* row = reinterpret_cast<const int4*>(kbase + j * kv_ss);
    const __half* srow = ksbase + j * sc_ss;
    float s = 0.f;
    for (int blk = 0; blk < nblk; ++blk) {
      float pd = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int4 pk = row[blk * 2 + c];
        const float* qv = qs + blk * QBLOCK + c * 16;
        pd += dot4(pk.x, qv) + dot4(pk.y, qv + 4) + dot4(pk.z, qv + 8) + dot4(pk.w, qv + 12);
      }
      s = fmaf(pd, __half2float(srow[blk]), s);
    }
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
    const int8_t* vcol = vq + b * kv_sb + hk * kv_sh + d;
    const __half* vscol = vs + b * sc_sb + hk * sc_sh + d / QBLOCK;
    for (int j = g; j < len; j += groups) {
      const float w = sc[j] * __half2float(vscol[j * sc_ss]);
      a = fmaf(w, static_cast<float>(vcol[j * kv_ss]), a);
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

}  // namespace

// q: lane b, head h at q + b*q_sb + h*q_sh (D contiguous values);
// kq/vq: int8 row (b, s, kv head) at b*kv_sb + s*kv_ss + hk*kv_sh;
// ks/vs: f16 scales, D/32 per row, strides sc_*; lens: (B,) int32;
// o: like q; q and o bf16. Strides are in elements. D % 32 == 0,
// D <= 128, and every code row 16-byte aligned.
extern "C" int q8_decode_attention(
    const void* q, long long q_sb, long long q_sh, const void* kq,
    const void* vq, long long kv_sb, long long kv_ss, long long kv_sh,
    const void* ks, const void* vs, long long sc_sb, long long sc_ss,
    long long sc_sh, const void* lens, void* o, long long o_sb,
    long long o_sh, int B, int H, int Hkv, int S, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  const size_t smem = sizeof(float) * (size_t)(D + S + NWARP + NT);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(q8_decode_attention_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  q8_decode_attention_kernel<<<B * H, NT, smem, s>>>(
      static_cast<const T*>(q), q_sb, q_sh, static_cast<const int8_t*>(kq),
      static_cast<const int8_t*>(vq), kv_sb, kv_ss, kv_sh,
      static_cast<const __half*>(ks), static_cast<const __half*>(vs), sc_sb,
      sc_ss, sc_sh, static_cast<const int*>(lens), static_cast<T*>(o), o_sb,
      o_sh, H, Hkv, S, D, scale);
  return static_cast<int>(cudaGetLastError());
}
