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
// Bound on this card: bytes. Each code and scale is read once a lane,
// for all of its queries, and feeds 2 FLOP a query (q.k and p.v), ~2
// FLOP/byte against the H100's ~600 int8 OP/byte ridge. The kernel body,
// shared with the Q4_0 cache, is in decode_attention.cuh: it splits the
// positions across CTAs and merges their partial softmaxes. This file
// gives it the int8 code format: a lane's 16 codes of a row are one
// 16-byte load, widened to f32 bitwise.

#include "decode_attention.cuh"

namespace {

// code i (0..3) of a word of four int8 codes biased bytewise to c + 128,
// as f32: 2^23 + (c + 128) built bitwise, less 2^23 + 128 (exact)
__device__ __forceinline__ float biased_byte_f32(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

struct Q8Codes {
  using code_t = int8_t;
  using raw_t = uint4;
  static __device__ __forceinline__ uint4 load(const int8_t* row, int sub) {
    return __ldg(reinterpret_cast<const uint4*>(row) + sub);
  }
  // the 16 codes, c + 128 bytewise, as f32 less 128
  static __device__ __forceinline__ void widen16(uint4 r, float* c) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                           r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i) c[i] = biased_byte_f32(w[i / 4], i % 4);
  }
};

}  // namespace

// q: lane b, query qi, head h at q + b*q_sb + qi*q_sq + h*q_sh (D
// contiguous values); kq/vq: int8 row (b, s, kv head) at b*kv_sb +
// s*kv_ss + hk*kv_sh; ks/vs: f16 scales, D/32 per row, strides sc_*;
// lens: (B, Q) int32, query (b, qi) attends [0, lens[b*Q + qi]); o: like
// q; q and o bf16. Strides are in elements. D % 32 == 0, D <= 128, and
// every code row 16-byte aligned. Positions are split into nchunks chunks
// of chunk positions (chunk * nchunks >= S); with nchunks > 1, part holds
// B * Q * H * nchunks * (D + 2) floats of partials.
extern "C" int q8_decode_attention(
    const void* q, long long q_sb, long long q_sq, long long q_sh,
    const void* kq, const void* vq, long long kv_sb, long long kv_ss,
    long long kv_sh, const void* ks, const void* vs, long long sc_sb,
    long long sc_ss, long long sc_sh, const void* lens, void* o,
    long long o_sb, long long o_sq, long long o_sh, void* part, int B,
    int Q, int H, int Hkv, int S, int D, int chunk, int nchunks,
    void* stream) {
  return launch_decode_attention<Q8Codes>(
      q, q_sb, q_sq, q_sh, kq, vq, kv_sb, kv_ss, kv_sh, ks, vs, sc_sb, sc_ss,
      sc_sh, lens, o, o_sb, o_sq, o_sh, part, B, Q, H, Hkv, S, D, chunk,
      nchunks, stream);
}
