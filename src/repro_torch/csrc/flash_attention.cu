// Online-softmax (flash) attention over (B, S, H, D) tensors, for Hopper.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention/flash_attention.py, _flash_kernel): running (m, l)
// statistics over KV tiles so the scores never reach device memory, with
// causal, sliding-window and logit-softcap masks, masked scores set to
// -1e30 and a row whose l stays 0 divided by 1. Unlike the TPU kernel it
//  * takes sq != skv (the decoder's cross-attention prefill),
//  * masks a ragged S itself instead of shrinking the block to a divisor
//    of S (the TPU wrapper turns S=1500 into blocks of 4),
//  * reads GQA by index (kv head = h // (H / Hkv)); K and V are never
//    repeated in memory,
//  * reads and writes the (B, S, H, D) layout through its strides, so no
//    transpose runs around it.
//
// Bound on this card: at the encoder shape (B*H=6, S=1500, D=64) the work
// is operations (4*S*S*D FLOP per head over ~4*S*D bytes: ~3000
// FLOP/byte). Design: one block per (b*h, 32-query tile), looping over KV
// tiles staged in shared memory as f32; four threads share a query row,
// each holding a quarter of q and of the output accumulator in registers
// (interleaved dims, so the four read neighbouring shared-memory words),
// and the row's dot products are completed with two warp shuffles. The
// softmax statistics are updated once per 16 keys. Under a causal mask
// the KV tiles above the block's diagonal are skipped. The FMAs run on
// the CUDA cores; tensor cores are left for a later, faster version.
//
// Instantiated for what the port runs: bf16, head_dim 64 (whisper-tiny.en)
// and 32 (its reduced configuration).

#include "common.cuh"
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TPQ = 4;          // threads per query row
constexpr int BQ = 32;          // query rows per block
constexpr int NT = BQ * TPQ;    // 128 threads
constexpr int SUB = 16;         // keys per online-softmax update
constexpr float NEG_INF = -1e30f;  // the reference's mask value

using T = __nv_bfloat16;

template <int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int Hkv, int causal, int window,
                       float softcap, float scale) {
  constexpr int DP = D / TPQ;     // dims held by one thread
  constexpr int BKV = 4096 / D;   // keys per tile: 16 KB of f32 per plane
  __shared__ float Ks[BKV][D];
  __shared__ float Vs[BKV][D];

  const int tid = threadIdx.x;
  const int qi = tid / TPQ;
  const int part = tid % TPQ;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qpos = q0 + qi;
  const bool q_ok = qpos < Sq;

  float qr[DP], acc[DP];
  const size_t q_off = (((size_t)b * Sq + (q_ok ? qpos : 0)) * H + h) * D;
#pragma unroll
  for (int i = 0; i < DP; ++i) {
    qr[i] = q_ok ? to_f32(q[q_off + i * TPQ + part]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  // Causal without a window: every row has key 0 unmasked, so the tiles
  // above the block's last row are masked for all rows and add exactly 0.
  int kv_end = Skv;
  if (causal && window <= 0) kv_end = min(Skv, q0 + BQ);

  for (int t0 = 0; t0 < kv_end; t0 += BKV) {
    const int nk = min(BKV, kv_end - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int e = tid; e < BKV * D; e += NT) {
      const int r = e / D;
      const int c = e % D;
      float kk = 0.f, vv = 0.f;
      if (r < nk) {
        const size_t off = (((size_t)b * Skv + t0 + r) * Hkv + hk) * D + c;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[r][c] = kk;
      Vs[r][c] = vv;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nk; j0 += SUB) {
      float s[SUB];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int r = j0 + j;
        float dot = 0.f;
        if (r < nk) {
#pragma unroll
          for (int i = 0; i < DP; ++i) dot = fmaf(qr[i], Ks[r][i * TPQ + part], dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        float sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
        const int kpos = t0 + r;
        bool keep = true;
        if (causal) keep = keep && (kpos <= qpos);
        if (window > 0) keep = keep && (qpos - kpos < window);
        sc = keep ? sc : NEG_INF;
        if (r >= nk) sc = -INFINITY;  // past the last key: weight exactly 0
        s[j] = sc;
        mx = fmaxf(mx, sc);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        s[j] = expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < DP; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int r = j0 + j;
        if (r < nk) {
          const float p = s[j];
#pragma unroll
          for (int i = 0; i < DP; ++i) acc[i] = fmaf(p, Vs[r][i * TPQ + part], acc[i]);
        }
      }
      m = m_new;
    }
  }

  if (q_ok) {
    const float denom = (l == 0.f) ? 1.f : l;
    const size_t o_off = (((size_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP; ++i) o[o_off + i * TPQ + part] = from_f32<T>(acc[i] / denom);
  }
}

template <int D>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int Sq, int Skv, int H, int Hkv, int causal, int window,
            float softcap, float scale, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, Hkv, causal,
      window, softcap, scale);
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Skv, Hkv, D), all contiguous bf16;
// D is 32 or 64. window <= 0: none; softcap <= 0: none.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Skv, int H,
                               int Hkv, int D, int causal, int window,
                               float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  switch (D) {
    case 32: launch<32>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, softcap, scale, s); break;
    case 64: launch<64>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, window, softcap, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
