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
// read once per query and feeds 4 FLOP. The kernel body, shared with the
// Q8_0 cache, is in decode_attention.cuh; this file gives it the nibble
// code format: a K scale block is one 16-byte load (32 codes), unpacked
// in registers, and a V code is one nibble of a byte.

#include "decode_attention.cuh"

namespace {

// dot of the eight codes packed in one 32-bit word (byte i: dims 2i, 2i+1
// in its low and high nibble, +8 bias) with qv[0..7]
__device__ __forceinline__ float dot8(unsigned w, const float* qv) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned byte = (w >> (8 * i)) & 0xffu;
    s = fmaf(qv[2 * i], static_cast<float>(static_cast<int>(byte & 0xfu) - 8), s);
    s = fmaf(qv[2 * i + 1], static_cast<float>(static_cast<int>(byte >> 4) - 8), s);
  }
  return s;
}

struct Q4Codes {
  using code_t = uint8_t;
  static __device__ __forceinline__ float dot_block(const uint8_t* row, int blk,
                                                    const float* qv) {
    const uint4 pk = reinterpret_cast<const uint4*>(row)[blk];
    return dot8(pk.x, qv) + dot8(pk.y, qv + 8) + dot8(pk.z, qv + 16) +
           dot8(pk.w, qv + 24);
  }
  static __device__ __forceinline__ float code(const uint8_t* row, int d) {
    return static_cast<float>(static_cast<int>((row[d / 2] >> (4 * (d & 1))) & 0xfu) - 8);
  }
};

}  // namespace

// q: lane b, query qi, head h at q + b*q_sb + qi*q_sq + h*q_sh (D
// contiguous values); kp/vp: packed uint8 row (b, s, kv head) of D/2
// bytes at b*kv_sb + s*kv_ss + hk*kv_sh; ks/vs: f16 scales, D/32 per
// row, strides sc_*; lens: (B, Q) int32, query (b, qi) attends
// [0, lens[b*Q + qi]); o: like q; q and o bf16. Strides are in elements.
// D % 32 == 0, D <= 128, and every packed row 16-byte aligned.
extern "C" int q4_decode_attention(
    const void* q, long long q_sb, long long q_sq, long long q_sh,
    const void* kp, const void* vp, long long kv_sb, long long kv_ss,
    long long kv_sh, const void* ks, const void* vs, long long sc_sb,
    long long sc_ss, long long sc_sh, const void* lens, void* o,
    long long o_sb, long long o_sq, long long o_sh, int B, int Q, int H,
    int Hkv, int S, int D, void* stream) {
  return launch_decode_attention<Q4Codes>(
      q, q_sb, q_sq, q_sh, kp, vp, kv_sb, kv_ss, kv_sh, ks, vs, sc_sb, sc_ss,
      sc_sh, lens, o, o_sb, o_sq, o_sh, B, Q, H, Hkv, S, D, stream);
}
