// Decode attention over a Q4_0 KV cache, for Hopper: one query per lane
// in plain decode, Q <= spec_k queries in the speculative verify.
//
// Replaces the TPU kernel q4_decode_attention_pallas (src/repro/kernels/
// q4_attention/q4_attention.py, _q4_attn_kernel): K/V rows stored as two
// 4-bit codes a byte along head_dim (low nibble = even dim, +8 bias) with
// one f16 scale per 32 dims, unpacked and scaled next to the dot (paper
// C1), each query attending cache positions [0, length). Unlike the TPU
// kernel it
//  * takes Q queries per lane, each with its own length (the verify's
//    token j attends [0, pos + j]); the TPU kernel is single-query and
//    the reference sends the verify to its host path,
//  * reads only positions [0, length) (no padded blocks of 128),
//  * reads the serving engine's stacked (L, B, S, Hkv, D/2) cache planes
//    in place through their strides,
//  * returns 0 for a query of length 0 (nothing to attend).
//
// Bound on this card: bytes. Each packed byte (two codes) and scale is
// read once a lane, for all of its queries, and feeds 4 FLOP a query.
// The kernel body, shared with the Q8_0 cache, is in
// decode_attention.cuh: it splits the positions across CTAs and merges
// their partial softmaxes. This file gives it the nibble code format: a
// lane's 16 codes of a row are one 8-byte load, unpacked in registers.

#include "decode_attention.cuh"

namespace {

struct Q4Codes {
  using code_t = uint8_t;
  using raw_t = uint2;
  static __device__ __forceinline__ uint2 load(const uint8_t* row, int sub) {
    return __ldg(reinterpret_cast<const uint2*>(row) + sub);
  }
  // the 16 codes (byte i: dims 2i and 2i + 1 in its low and high nibble,
  // +8 bias) as f32: 2^23 + nibble built bitwise, less 2^23 + 8 (exact)
  static __device__ __forceinline__ void widen16(uint2 r, float* c) {
    const uint32_t w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t nib = (w[i / 8] >> (4 * (i % 8))) & 0xfu;
      c[i] = __uint_as_float(0x4B000000u | nib) - 8388616.f;
    }
  }
};

}  // namespace

// q: lane b, query qi, head h at q + b*q_sb + qi*q_sq + h*q_sh (D
// contiguous values); kp/vp: packed uint8 row (b, s, kv head) of D/2
// bytes at b*kv_sb + s*kv_ss + hk*kv_sh; ks/vs: f16 scales, D/32 per
// row, strides sc_*; lens: (B, Q) int32, query (b, qi) attends
// [0, lens[b*Q + qi]); o: like q; q and o bf16. Strides are in elements.
// D % 32 == 0, D <= 128, and every packed row 16-byte aligned. Positions
// are split into nchunks chunks of chunk positions (chunk * nchunks >=
// S); with nchunks > 1, part holds B * Q * H * nchunks * (D + 2) floats
// of partials.
extern "C" int q4_decode_attention(
    const void* q, long long q_sb, long long q_sq, long long q_sh,
    const void* kp, const void* vp, long long kv_sb, long long kv_ss,
    long long kv_sh, const void* ks, const void* vs, long long sc_sb,
    long long sc_ss, long long sc_sh, const void* lens, void* o,
    long long o_sb, long long o_sq, long long o_sh, void* part, int B,
    int Q, int H, int Hkv, int S, int D, int chunk, int nchunks,
    void* stream) {
  return launch_decode_attention<Q4Codes>(
      q, q_sb, q_sq, q_sh, kp, vp, kv_sb, kv_ss, kv_sh, ks, vs, sc_sb, sc_ss,
      sc_sh, lens, o, o_sb, o_sq, o_sh, part, B, Q, H, Hkv, S, D, chunk,
      nchunks, stream);
}
