// Decode attention over a Q8_0 KV cache, for Hopper: one query per lane
// in plain decode, Q <= spec_k queries in the speculative verify.
//
// Replaces the TPU kernel q8_decode_attention_pallas (src/repro/kernels/
// q8_attention/q8_attention.py, _q8_attn_kernel): int8 K/V codes with one
// f16 scale per 32 elements along head_dim, dequantized next to the dot
// (paper C1), each query attending positions [0, length). Unlike the
// TPU kernel it
//  * takes Q queries per lane, each with its own length (the verify's
//    token j attends [0, pos + j]); the TPU kernel is single-query and
//    the reference sends the verify to its host path,
//  * reads only positions [0, length) (no padded blocks of 128),
//  * reads the serving engine's stacked (L, B, S, Hkv, .) cache planes
//    in place through their strides, so the per-step repeat/transpose/
//    copy of the reference's _quant_cache_attention does not happen on
//    the card,
//  * returns 0 for a query of length 0 (nothing to attend).
//
// Bound on this card: bytes. Each code and scale is read once and feeds
// 2 FLOP (q.k and p.v), ~2 FLOP/byte against the H100's ~600 int8
// OP/byte ridge. The kernel body, shared with the Q4_0 cache, is in
// decode_attention.cuh; this file gives it the int8 code format: a K
// scale block is two 16-byte loads, a V code one byte read coalesced
// across the warp.

#include "decode_attention.cuh"

namespace {

// dot of four int8 codes packed little-endian in one int with q[0..3]
__device__ __forceinline__ float dot4(int packed, const float* qv) {
  return qv[0] * static_cast<float>(static_cast<int8_t>(packed & 0xff)) +
         qv[1] * static_cast<float>(static_cast<int8_t>((packed >> 8) & 0xff)) +
         qv[2] * static_cast<float>(static_cast<int8_t>((packed >> 16) & 0xff)) +
         qv[3] * static_cast<float>(static_cast<int8_t>((packed >> 24) & 0xff));
}

struct Q8Codes {
  using code_t = int8_t;
  static __device__ __forceinline__ float dot_block(const int8_t* row, int blk,
                                                    const float* qv) {
    const int4* r = reinterpret_cast<const int4*>(row) + 2 * blk;
    float pd = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int4 pk = r[c];
      const float* qc = qv + c * 16;
      pd += dot4(pk.x, qc) + dot4(pk.y, qc + 4) + dot4(pk.z, qc + 8) + dot4(pk.w, qc + 12);
    }
    return pd;
  }
  static __device__ __forceinline__ float code(const int8_t* row, int d) {
    return static_cast<float>(row[d]);
  }
};

}  // namespace

// q: lane b, query qi, head h at q + b*q_sb + qi*q_sq + h*q_sh (D
// contiguous values); kq/vq: int8 row (b, s, kv head) at b*kv_sb +
// s*kv_ss + hk*kv_sh; ks/vs: f16 scales, D/32 per row, strides sc_*;
// lens: (B, Q) int32, query (b, qi) attends [0, lens[b*Q + qi]); o: like
// q; q and o bf16. Strides are in elements. D % 32 == 0, D <= 128, and
// every code row 16-byte aligned.
extern "C" int q8_decode_attention(
    const void* q, long long q_sb, long long q_sq, long long q_sh,
    const void* kq, const void* vq, long long kv_sb, long long kv_ss,
    long long kv_sh, const void* ks, const void* vs, long long sc_sb,
    long long sc_ss, long long sc_sh, const void* lens, void* o,
    long long o_sb, long long o_sq, long long o_sh, int B, int Q, int H,
    int Hkv, int S, int D, void* stream) {
  return launch_decode_attention<Q8Codes>(
      q, q_sb, q_sq, q_sh, kq, vq, kv_sb, kv_ss, kv_sh, ks, vs, sc_sb, sc_ss,
      sc_sh, lens, o, o_sb, o_sq, o_sh, B, Q, H, Hkv, S, D, stream);
}
