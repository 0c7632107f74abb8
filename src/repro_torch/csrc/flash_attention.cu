// Online-softmax (flash) attention over (B, S, H, D) tensors, on Hopper's
// tensor cores.
//
// Replaces the TPU kernel flash_attention_pallas (src/repro/kernels/
// flash_attention/flash_attention.py, _flash_kernel): running (m, l)
// statistics over KV tiles so the scores never reach device memory, with
// causal, sliding-window and logit-softcap masks, masked scores set to
// -1e30 (a row whose every key is masked averages V over its keys) and a
// row whose l stays 0 divided by 1. Unlike the TPU kernel it
//  * takes sq != skv (the decoder's cross-attention prefill),
//  * takes a query offset q_off: query row i sits at position q_off + i
//    and key j at j, so a rank of a context-parallel prefill attends
//    its block of the positions over the whole K and V,
//  * masks a ragged S itself: rows past Skv are zero-filled by the copy
//    and their scores are -inf, so they weigh exactly 0,
//  * reads GQA by index (kv head = h // (H / Hkv)); K and V are never
//    repeated in memory,
//  * reads and writes the (B, S, H, D) layout through its strides (a
//    head's row of D bf16 is 16-byte aligned), so no transpose runs
//    around it.
//
// Bound on this card: operations at the encoder's shape (B*H = 6, S =
// 1500, D = 64: 4*S*S*D FLOP a head over ~4*S*D bytes, ~3000 FLOP/byte),
// bytes or launch latency at the prefills (Sq = 32). In practice the
// latency of each KV tile's chain (barrier, ldmatrix, products, row max,
// exponentials, shuffles) sets the pace, and shared-memory reads of K
// and V follow it. Design:
//  * S = Q K^T and O += P V run as mma.sync m16n8k16 with bf16 operands
//    and f32 accumulators. At D <= 64 a CTA of 4 warps owns 128 queries,
//    32 a warp as two 16-row tiles, so each K or V fragment read by
//    ldmatrix feeds two MMAs, and the two tiles' softmax chains run side
//    by side; a warp's Q fragments stay in registers for the whole KV
//    loop. Wider heads change the layout (Layout<D> below), because a
//    warp's O accumulator grows with D: 32 rows x 128 dims would be 128
//    f32 registers a thread before the scores and the Q fragments. At
//    D = 128 a warp owns one 16-row tile (64 queries a CTA: O is 64
//    registers, Q 32) and two CTAs still share an SM (85 KB of shared
//    memory each). At D = 256 a warp owns one tile too, a K/V tile holds
//    32 keys (so a stage is 16 KB of K and of V: 99 KB in all, above the
//    48 KB default, hence the opt-in at launch) and the Q fragments are
//    read from shared memory at each k16 step instead of being held (O
//    alone is 128 registers); one CTA an SM by its bound, two by what it
//    takes. The
//    online softmax runs on the accumulator fragments in log2 units
//    (scores times scale * log2(e), 2^x on the SFU): each score is owned
//    by one thread, so its exponential is computed once; a row's max
//    and sum are completed over the 4 threads of a quad with two
//    shuffles. Masks are applied only on a tile that crosses the
//    diagonal, a window or the end of K. P is rounded to bf16 for the
//    P V product (the l it is divided by stays f32), as in
//    FlashAttention-2: each p carries at most 2^-9 relative error, so
//    the output at most 2^-9 of max |V|.
//  * K and V tiles of 64 keys are staged in shared memory as bf16 by
//    cp.async, 16 bytes a thread, two stages: the copy of tile t + 1
//    runs under the products of tile t, one __syncthreads a tile. Rows
//    are padded by 16 bytes (stride D + 8), which keeps ldmatrix (plain
//    for K, .trans for V) free of bank conflicts. 55 KB of dynamic
//    shared memory at D = 64, two CTAs an SM (registers).
//  * The KV range is split across CTAs (grid.z) as far as the SMs hold
//    the CTAs at once (flash_attention/ops.py, kv_splits: two an SM at
//    D <= 128, one at 256);
//    each split writes its partial (m, l, acc) to a workspace and a
//    second kernel combines the splits in split order (deterministic,
//    no atomics). The cross prefill, 6 CTAs of 32 queries, runs as 24
//    splits of one 64-key tile, 144 CTAs. The encoder, 12 query tiles x
//    6 heads = 72 CTAs, runs as 3 splits of 8 tiles: 216 CTAs, all
//    resident, against 72 (one CTA holds an SM's latency alone) or 288
//    (a second round); measured, PERF.md, PR 14.
//  * Causal attention skips the KV tiles above the CTA's last row:
//    exact, because they lie after every row's own key (the diagonal,
//    kept under a window too, a window being at least 1 wide), which
//    makes the row's m finite before them, so they would only add
//    exactly 0. A row at or past Skv (Sq > Skv, or q_off + Sq > Skv)
//    lies in a CTA whose range the skip leaves whole. A split whose
//    tiles are all skipped (or lie past Skv: the later splits of a CTA
//    near position 0, whose causal range is shorter than the splits
//    cover) reads no tile and writes m = -1e30, l = 0, acc = 0, which
//    the combine weighs exactly 0 (or, in a row whose every key is
//    masked, adds nothing to l or acc); m never starts at -inf, so no
//    exp(-inf + inf).
//
// Instantiated for what the port runs: bf16 at head_dim 64
// (whisper-tiny.en, whisper-base), 32 (the reduced configurations), 112
// (zamba2-7b's shared attention block: 3584 / 32 heads), 128 (qwen3-4b,
// qwen3-moe-30b-a3b and the other decoder-only models) and 256
// (gemma2-2b). Any other D is refused. D = 112 takes Layout<128>'s tiles
// and needs no padding: its 7 k16 steps of Q K^T are taken one at a
// time, its 14 n8 tiles of P V two at a time (one ldmatrix.x4 a pair),
// a row is 14 chunks of 16 bytes, so a 64-row tile is 7 rounds of the
// CTA's 128 copies, and the row stride of 120 elements (240 bytes) keeps
// ldmatrix's 8 rows on distinct banks. 75 KB of shared memory a CTA:
// two an SM.

#include "common.cuh"
#include "tensor_core.cuh"
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NW = 4;              // warps a CTA
constexpr int NT = NW * 32;
constexpr int STAGES = 2;          // K/V tiles in shared memory
constexpr float NEG_INF = -1e30f;  // the reference's mask value

// The layout of each head_dim (flash_attention/ops.py, LAYOUT, mirrors
// BQ, BKV and MINB): m16 query tiles a warp, keys a K/V tile, CTAs an SM
// by the launch bound, and whether a warp holds its Q fragments in
// registers for the whole KV loop.
template <int D>
struct Layout {
  // whole k16 steps, pairs of n8 tiles, and a tile's 16-byte copies in
  // whole rounds of the CTA's threads
  static_assert(D % 16 == 0, "head_dim: whole k16 steps and n8 pairs");
  static constexpr int MT = D <= 64 ? 2 : 1;
  static constexpr int BKV = D <= 128 ? 64 : 32;
  static constexpr int MINB = D <= 128 ? 2 : 1;
  static constexpr bool QREG = D <= 128;
  static constexpr int BQ = NW * MT * 16;   // queries a CTA
  static_assert(BKV * (D / 8) % NT == 0 && BQ * (D / 8) % NT == 0,
                "a tile's copies in whole rounds");
};
constexpr float LOG2E = 1.4426950408889634f;

// 2^x (the SFU's approximation: ~2 ulp; -inf and -1e30 give +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

using T = __nv_bfloat16;

struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  float* part_o;   // (splits, B*H*Sq, D) unnormalised acc, splits > 1
  float* part_ml;  // (splits, B*H*Sq, 2) m and l, splits > 1
  int Sq, Skv, H, Hkv, causal, window;
  int q_off;   // the position of query row 0
  float softcap, scale, scale_log2;   // scale_log2 = scale * log2(e)
  int splits, tiles_per_split;
};

template <int D>
__global__ void __launch_bounds__(NT, Layout<D>::MINB)
flash_attention_kernel(Args a) {
  constexpr int MT = Layout<D>::MT;
  constexpr int BKV = Layout<D>::BKV;
  constexpr int BQ = Layout<D>::BQ;
  constexpr bool QREG = Layout<D>::QREG;
  constexpr int LD = D + 8;       // shared row stride, elements
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int KS = D / 16;      // k16 steps of Q K^T
  constexpr int NKT = BKV / 8;    // n8 tiles of a score row
  constexpr int NDT = D / 8;      // n8 tiles of an output row
  // bf16 tiles, held as their 16-bit patterns: Q, then K and V of
  // STAGES stages each (smem_bytes<D>())
  extern __shared__ __align__(128) uint16_t smem[];
  uint16_t* const Qs = smem;
  auto k_tile = [&](int st) { return smem + (BQ + st * BKV) * LD; };
  auto v_tile = [&](int st) {
    return smem + (BQ + (STAGES + st) * BKV) * LD;
  };

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int H = a.H;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / (H / a.Hkv);
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.z;

  // Causal: the tiles above the CTA's last row (position q_off + q0 +
  // BQ - 1) add 0.
  int kv_end = a.Skv;
  if (a.causal) kv_end = min(a.Skv, a.q_off + q0 + BQ);
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int t_begin = split * a.tiles_per_split;
  const int t_end = min(n_tiles, t_begin + a.tiles_per_split);

  auto load_kv = [&](int t, int st) {
#pragma unroll
    for (int c0 = 0; c0 < BKV * CH; c0 += NT) {
      const int c = c0 + tid;
      const int r = c / CH, ch = c % CH;
      const int ks = t * BKV + r;
      const bool ok = ks < a.Skv;
      const size_t off =
          (((size_t)b * a.Skv + (ok ? ks : 0)) * a.Hkv + hk) * D + ch * 8;
      cp_async16(k_tile(st) + r * LD + ch * 8, a.k + off, ok);
      cp_async16(v_tile(st) + r * LD + ch * 8, a.v + off, ok);
    }
  };

  if (t_begin < t_end) {
#pragma unroll
    for (int c0 = 0; c0 < BQ * CH; c0 += NT) {
      const int c = c0 + tid;
      const int r = c / CH, ch = c % CH;
      const int qs = q0 + r;
      const bool ok = qs < a.Sq;
      const size_t off =
          (((size_t)b * a.Sq + (ok ? qs : 0)) * H + h) * D + ch * 8;
      cp_async16(&Qs[r * LD + ch * 8], a.q + off, ok);
    }
  }
  // tiles t_begin .. t_begin + STAGES - 2 in flight (Q with the first)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t_begin + i < t_end) load_kv(t_begin + i, i);
    cp_async_commit();
  }

  // the warp's rows: MT tiles of 16, rows qrow + 16 * mt and + 8 more
  const int rw = warp * MT * 16;
  const int qrow = q0 + rw + lane / 4;
  const bool warp_active = q0 + rw < a.Sq;
  float o[MT][NDT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
  float m[MT][2], l[MT][2];          // l: this thread's share
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = NEG_INF;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // the warp's Q fragments: all KS k16 steps held (QREG), or one step
  // read from shared memory when it is used
  uint32_t qf[MT][QREG ? KS : 1][4];
  auto load_q = [&](int mt, int kk, uint32_t(&frag)[4]) {
    ldmatrix_x4(frag, &Qs[(rw + mt * 16 + (lane & 15)) * LD + kk * 16 +
                          (lane >> 4) * 8]);
  };

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t landed everywhere; tile t - 1 consumed
    if (t + STAGES - 1 < t_end)   // into the stage tile t - 1 used
      load_kv(t + STAGES - 1, (t - t_begin + STAGES - 1) % STAGES);
    cp_async_commit();
    if (!warp_active) continue;
    if (QREG && t == t_begin) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < (QREG ? KS : 1); ++kk) load_q(mt, kk, qf[mt][kk]);
    }
    const uint16_t* const Kt = k_tile(buf);
    const uint16_t* const Vt = v_tile(buf);

    // S = Q K^T: each K fragment feeds the warp's MT row tiles. Keys
    // (lane & 7) + 8 * (lane >> 4), dims 8 * bit 3
    float s[MT][NKT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NKT; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (!QREG) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) load_q(mt, kk, qf[mt][0]);
      }
#pragma unroll
      for (int jp = 0; jp < NKT / 2; ++jp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &Kt[(jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + (((lane >> 3) & 1) << 3)]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t(&qk)[4] = qf[mt][QREG ? kk : 0];
          mma16816<T>(s[mt][2 * jp], qk, kb[0], kb[1]);
          mma16816<T>(s[mt][2 * jp + 1], qk, kb[2], kb[3]);
        }
      }
    }

    // scores in log2 units (softcap first where set); the masks only on
    // a tile that crosses the diagonal, a window or the end of K
    if (a.softcap > 0.f) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[mt][j][e] =
                a.softcap * tanhf(s[mt][j][e] * a.scale / a.softcap) * LOG2E;
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] *= a.scale_log2;
    }
    const int k_last = t * BKV + BKV - 1;
    if ((a.causal && k_last > a.q_off + q0 + rw) || a.window > 0 ||
        k_last >= a.Skv) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NKT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = t * BKV + j * 8 + (lane & 3) * 2 + (e & 1);
            const int qpos = a.q_off + qrow + mt * 16 + (e >> 1) * 8;
            bool keep = true;
            if (a.causal) keep = keep && (kpos <= qpos);
            if (a.window > 0) keep = keep && (qpos - kpos < a.window);
            if (!keep) s[mt][j][e] = NEG_INF;
            if (kpos >= a.Skv) s[mt][j][e] = -INFINITY;   // past K: 0
          }
    }
    // each row's max over the quad, then each score's exponential once
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r]);   // >= -1e30: finite
        alpha[r] = ex2(m[mt][r] - m_new);
        m[mt][r] = m_new;
      }
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NKT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[mt][j][e] - m[mt][e >> 1]);
          s[mt][j][e] = p;
          ps[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * alpha[r] + ps[r];
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        o[mt][j][0] *= alpha[0];
        o[mt][j][1] *= alpha[0];
        o[mt][j][2] *= alpha[1];
        o[mt][j][3] *= alpha[1];
      }
    }

    // O += P V: P's accumulator layout is the A fragment's, 16 keys a
    // step; each V fragment (read transposed: keys (lane & 7) + 8 * bit
    // 3, dims 8 * (lane >> 4)) feeds the MT row tiles
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack2<T>(s[mt][2 * kc][0], s[mt][2 * kc][1]);
        pa[mt][1] = pack2<T>(s[mt][2 * kc][2], s[mt][2 * kc][3]);
        pa[mt][2] = pack2<T>(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
        pa[mt][3] = pack2<T>(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, &Vt[(kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                    dp * 16 + ((lane >> 4) << 3)]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816<T>(o[mt][2 * dp], pa[mt], vb[0], vb[1]);
          mma16816<T>(o[mt][2 * dp + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
    }
  if (!warp_active) return;
  const int rows = gridDim.y * a.Sq;   // B*H*Sq
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = qrow + mt * 16 + r * 8;
      if (qpos >= a.Sq) continue;
      if (a.splits == 1) {
        const float inv = 1.f / (l[mt][r] == 0.f ? 1.f : l[mt][r]);
        T* dst =
            a.o + (((size_t)b * a.Sq + qpos) * H + h) * D + (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < NDT; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
              __floats2bfloat162_rn(o[mt][j][2 * r] * inv,
                                    o[mt][j][2 * r + 1] * inv);
      } else {
        const size_t row = (size_t)split * rows + (size_t)bh * a.Sq + qpos;
        float* dst = a.part_o + row * D + (lane & 3) * 2;
#pragma unroll
        for (int j = 0; j < NDT; ++j)
          *reinterpret_cast<float2*>(dst + j * 8) =
              make_float2(o[mt][j][2 * r], o[mt][j][2 * r + 1]);
        if ((lane & 3) == 0) {
          a.part_ml[row * 2] = m[mt][r];
          a.part_ml[row * 2 + 1] = l[mt][r];
        }
      }
    }
  }
}

// One output row (b, q, h) per threadIdx.y, one dim per threadIdx.x: the
// splits' partials weighed by 2^(m_s - max m) (m in log2 units) and
// summed in split order.
template <int D>
__global__ void __launch_bounds__(D * 4)
flash_combine_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml, T* __restrict__ o,
                     int rows, int Sq, int H, int splits) {
  const int row = blockIdx.x * 4 + threadIdx.y;   // bh * Sq + q
  if (row >= rows) return;
  const int d = threadIdx.x;
  float mmax = NEG_INF;
  for (int s = 0; s < splits; ++s)
    mmax = fmaxf(mmax, part_ml[((size_t)s * rows + row) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t pr = (size_t)s * rows + row;
    const float w = exp2f(part_ml[pr * 2] - mmax);   // m in log2 units
    l = fmaf(w, part_ml[pr * 2 + 1], l);
    acc = fmaf(w, part_o[pr * D + d], acc);
  }
  const int bh = row / Sq, q = row % Sq;
  const int b = bh / H, h = bh % H;
  o[(((size_t)b * Sq + q) * H + h) * D + d] =
      from_f32<T>(acc / (l == 0.f ? 1.f : l));
}

template <int D>
constexpr int smem_bytes() {
  return (Layout<D>::BQ + 2 * STAGES * Layout<D>::BKV) * (D + 8) * 2;
}

template <int D>
void launch(Args a, int B, cudaStream_t stream) {
  constexpr int BQ = Layout<D>::BQ;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<D>());
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((a.Sq + BQ - 1) / BQ, B * a.H, a.splits);
  flash_attention_kernel<D><<<grid, NT, smem_bytes<D>(), stream>>>(a);
  if (a.splits > 1) {
    const int rows = B * a.H * a.Sq;
    flash_combine_kernel<D><<<(rows + 3) / 4, dim3(D, 4), 0, stream>>>(
        a.part_o, a.part_ml, a.o, rows, a.Sq, a.H, a.splits);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Skv, Hkv, D), all contiguous bf16 with
// 16-byte aligned bases; D is 32, 64, 112, 128 or 256. window <= 0: none;
// q_off >= 0: the position of query row 0 (key j at j); softcap <= 0:
// none. splits >= 1 KV splits of whole Layout<D>::BKV-key tiles; with
// splits > 1, part_o holds splits * B*H*Sq * D floats and part_ml
// splits * B*H*Sq * 2.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* part_o, void* part_ml, int B,
                               int Sq, int Skv, int H, int Hkv, int D,
                               int causal, int window, int q_off,
                               float softcap, int splits, void* stream) {
  if (q_off < 0 || splits < 1 ||
      (splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int bkv = 0;
  switch (D) {
    case 32: bkv = Layout<32>::BKV; break;
    case 64: bkv = Layout<64>::BKV; break;
    case 112: bkv = Layout<112>::BKV; break;
    case 128: bkv = Layout<128>::BKV; break;
    case 256: bkv = Layout<256>::BKV; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (Skv + bkv - 1) / bkv;
  const double scale = 1.0 / sqrt(static_cast<double>(D));
  Args a{static_cast<const T*>(q), static_cast<const T*>(k),
         static_cast<const T*>(v), static_cast<T*>(o),
         static_cast<float*>(part_o), static_cast<float*>(part_ml), Sq, Skv,
         H, Hkv, causal, window, q_off, softcap, static_cast<float>(scale),
         static_cast<float>(scale * 1.4426950408889634), splits,
         (n_tiles + splits - 1) / splits};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: launch<32>(a, B, s); break;
    case 64: launch<64>(a, B, s); break;
    case 112: launch<112>(a, B, s); break;
    case 128: launch<128>(a, B, s); break;
    case 256: launch<256>(a, B, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
