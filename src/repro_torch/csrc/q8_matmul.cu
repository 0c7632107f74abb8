// Q8_0 GEMM y[M,N] = x[M,K] @ (wq[K,N] * ws[K/32,N]) with f32
// accumulation, for Hopper.
//
// Replaces the TPU kernel q8_matmul_pallas (src/repro/kernels/q8_matmul/
// q8_matmul.py, _q8_matmul_kernel), which dequantizes each int8 tile with
// its per-32-row f16 scales in VMEM right before the MXU dot (paper C1),
// so device memory streams ~1.06 bytes per weight instead of 2.
//
// Bound on this card: operations at the encoder's shapes (M = 1500
// frames: ~2*M*N*K FLOP over ~K*N bytes of codes), bytes at decode shapes
// (M = the serving lanes, 1-4, or the speculative verify's rows): the
// code plane is read once and each code feeds only M multiply-adds, so
// (4,1536)@(1536,384) is bound by 0.63 MB, 0.19 µs, and in practice by
// the latency of one pass over device memory and of the launch. One
// source, two layouts; the C entry point picks by M (GEMV_MAX_M = 16):
//
//  * Tile (M > 16: the encoder and cross K/V projections over 1500
//    frames, the 32-row prefill). mma.sync m16n8k16 on bf16 (or f16)
//    operands with f32 accumulators, 4 warps a block. The x tile and the
//    int8 code tile are staged by cp.async, 3 stages in flight, each
//    stage 2 or 3 scale blocks of 32 rows; the codes are widened to x's
//    type in shared memory (exact: every int8 is a bf16 and an f16;
//    built bitwise, no integer-to-float conversion), never to code * scale,
//    and read as the B operand with ldmatrix.trans. Each 32-deep scale
//    block runs as two k16 MMAs into a partial accumulator that is
//    folded in as acc += partial * scale[block, n] in f32: the
//    reference's x @ (q * s) with the scale applied once a block instead
//    of once an element (each bf16 x code product is exact in f32; the
//    difference is f32 summation order). What sets the pace is each
//    stage's chain of barrier, ldmatrix, MMAs and fold, so a stage
//    carries several scale blocks and the block shape keeps every block
//    resident (TileWide, TileDeep below).
//  * GEMV (M <= 16: decode and the verify). A warp reads one 32-row
//    block of 128 columns: lane = 8 column groups of 16 x 4 quarters of
//    8 rows, one 16-byte load a row, neighbouring lanes on neighbouring
//    columns, issued before x is staged. x (4 rows a block) is staged
//    once in shared memory as f32; the codes are widened bitwise in
//    registers and the scale applied to each lane's 8-row partial sums.
//    K is split across warps and across blocks (the wrapper's k_splits)
//    so that N = 384 launches ~144 blocks: (4,1536)@(1536,384) runs as 3
//    column tiles x 48 splits of one scale block. Each split writes its
//    partial sums to a workspace and a second kernel, launched as a
//    programmatic dependent (its launch overlaps the GEMV), adds the
//    splits in split order: deterministic, no atomics on y. One split
//    writes y directly.
//  * f32 x keeps f32 arithmetic: the GEMV layout multiplies in f32 on
//    the CUDA cores, and above 16 rows f32 x runs the register-tiled f32
//    FMA loop (64x64 tiles, 4x4 accumulators a thread) that dequantizes
//    the weight tile into shared memory; rounding it to bf16 for the
//    tensor cores would lose its low bits. The main path gives bf16 x.
//
// Codes and scales are read with 16-byte loads where N % 16 == 0 and the
// planes are 16-byte aligned (every shape of the port); other shapes take
// element loads. Ragged M and N are masked in the loads and the store;
// K is a multiple of 32.

#include "common.cuh"
#include "tensor_core.cuh"
#include <stddef.h>
#include <stdint.h>
#include <algorithm>

namespace {

constexpr int QBLOCK = 32;
constexpr int GEMV_MAX_M = 16;   // M at or under it: the GEMV layout

// ---------------------------------------------------------------------------
// Tile layout: tensor cores, bf16 or f16 x
// ---------------------------------------------------------------------------

// A tile shape: BM x BN outputs, warps of WM x WN each; a stage holds SB
// scale blocks (32 * SB rows of K), ST stages in flight; at least MINB
// blocks resident on an SM. Shared memory: ST stages of the x tile (rows
// padded by 16 bytes), the int8 code tile and the f16 scales, and two
// buffers of the widened code tile (rows padded by 16 bytes): the
// paddings keep ldmatrix free of bank conflicts.
template <int BM_, int BN_, int WM_, int WN_, int SB_, int ST_, int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int SB = SB_, ST = ST_, MINB = MINB_;
  static constexpr int BK = SB * QBLOCK;   // rows of K a stage
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = (BM / WM) * WARPS_N * 32;
  static constexpr int MI = WM / 16;   // m16 tiles of a warp
  static constexpr int NJ = WN / 8;    // n8 tiles of a warp
  static constexpr int XLD = BK + 8;
  static constexpr int BLD = BN + 8;
  static constexpr int X_BYTES = BM * XLD * 2;
  static constexpr int C_BYTES = BK * BN;
  static constexpr int S_BYTES = SB * BN * 2;
  static constexpr int B_BYTES = BK * BLD * 2;
  static constexpr int SMEM =
      ST * (X_BYTES + C_BYTES + S_BYTES) + 2 * B_BYTES;
  static_assert((BM * BK / 8) % NT == 0 && (BK * (BN / 16)) % NT == 0,
                "the threads split the tile loads evenly");
  static_assert(SB * BN / 8 <= NT && NJ % 2 == 0, "tile shape");
  static_assert(ST >= 3, "a stage is widened one iteration ahead");
};
// Where 64x64 tiles number at least two an SM (N = 1536 at 1500 rows:
// 576), 64x96 tiles of 4 warps (32x48 each): 384 blocks, all resident
// at 3 an SM (72 KB each). Else 64x64 tiles (58 KB, 3 an SM), K split
// across blocks by the wrapper (k_splits) so that they fill the SMs:
// N = 384 at 1500 rows runs as 144 tiles x 2 splits, the 32-row
// prefill's (32,1536)@(1536,384) as 6 x 24. 2 scale blocks a stage in
// both. Chosen by measurement (PERF.md, PR 14).
using TileWide = Tile<64, 96, 32, 48, 2, 3, 3>;
using TileDeep = Tile<64, 64, 32, 32, 2, 3, 3>;

// code i of a word of four, biased bytewise to c + 128: 2^23 + (c + 128)
// built bitwise as an f32, less 2^23 + 128 (exact, no integer-to-float
// conversion)
__device__ __forceinline__ float code_f32(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// four int8 codes (one 32-bit word) -> four exact values of T, as two
// packed pairs. bf16: through code_f32 (the f32 -> bf16 rounding is
// exact for |c| <= 128); f16: 1024 + (c + 128) built bitwise as an f16
// pair, minus 1152.
template <typename T>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;   // c + 128, bytewise
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 bias = __half2half2(__ushort_as_half(0x6480));   // 1152
    uint32_t p0 = __byte_perm(u, 0x64646464u, 0x4140);   // 1024 + u0, u1
    uint32_t p1 = __byte_perm(u, 0x64646464u, 0x4342);   // 1024 + u2, u3
    __half2 a = __hsub2(*reinterpret_cast<__half2*>(&p0), bias);
    __half2 b = __hsub2(*reinterpret_cast<__half2*>(&p1), bias);
    lo = *reinterpret_cast<uint32_t*>(&a);
    hi = *reinterpret_cast<uint32_t*>(&b);
  } else {
    lo = pack2<T>(code_f32(u, 0), code_f32(u, 1));
    hi = pack2<T>(code_f32(u, 2), code_f32(u, 3));
  }
}

// 16 codes of the staged tile -> 16 values of T in the widened tile
template <typename T>
__device__ __forceinline__ void widen16(const int8_t* src, uint16_t* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  uint32_t out[8];
  widen4<T>(raw.x, out[0], out[1]);
  widen4<T>(raw.y, out[2], out[3]);
  widen4<T>(raw.z, out[4], out[5]);
  widen4<T>(raw.w, out[6], out[7]);
  uint4* const d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(out[0], out[1], out[2], out[3]);
  d[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// two neighbouring outputs of a row (n, n + 1), one store where both lie
// inside y and the pair is aligned (N even)
template <typename TO>
__device__ __forceinline__ void store2(TO* y, size_t idx, int n, int N,
                                       float v0, float v1) {
  if (n + 1 < N && (N & 1) == 0) {
    if constexpr (std::is_same<TO, float>::value) {
      *reinterpret_cast<float2*>(y + idx) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<uint32_t*>(y + idx) = pack2<TO>(v0, v1);
    }
  } else {
    if (n < N) y[idx] = from_f32<TO>(v0);
    if (n + 1 < N) y[idx + 1] = from_f32<TO>(v1);
  }
}

template <typename TI, typename TO, bool VEC, typename C>
__global__ void __launch_bounds__(C::NT, C::MINB)
q8_tile_kernel(const TI* __restrict__ x, const int8_t* __restrict__ wq,
               const __half* __restrict__ ws, TO* __restrict__ y, int M,
               int N, int K, float* __restrict__ work) {
  constexpr int XS = C::X_BYTES / 2, BS = C::B_BYTES / 2;
  constexpr int BN = C::BN, BK = C::BK, SB = C::SB, NT = C::NT;
  constexpr int XLD = C::XLD, BLD = C::BLD;
  constexpr int MI = C::MI, NJ = C::NJ, STAGES = C::ST;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / C::WARPS_N;   // the warp's WM rows
  const int wn = warp % C::WARPS_N;   // the warp's WN columns
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.x * BN;
  const int nkb = K / QBLOCK;
  const int nks = (nkb + SB - 1) / SB;   // stages of K
  // this block's share of K: split blockIdx.z of gridDim.z, whole stages
  const int sps = (nks + gridDim.z - 1) / gridDim.z;
  const int s_begin = blockIdx.z * sps;
  const int n_local = max(0, min(nks, s_begin + sps) - s_begin);
  // let the split-sum kernel be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");

  extern __shared__ __align__(128) uint8_t tile_smem[];
  uint16_t* const xs = reinterpret_cast<uint16_t*>(tile_smem);
  int8_t* const cs =
      reinterpret_cast<int8_t*>(tile_smem + STAGES * C::X_BYTES);
  uint16_t* const ss = reinterpret_cast<uint16_t*>(   // f16 scales
      tile_smem + STAGES * (C::X_BYTES + C::C_BYTES));
  uint16_t* const bs = reinterpret_cast<uint16_t*>(
      tile_smem + STAGES * (C::X_BYTES + C::C_BYTES + C::S_BYTES));

  // the block's stage i of K into stage buffer st; scale blocks past K
  // (a K that is not a multiple of 32 * SB) are zero-filled
  auto load = [&](int i, int st) {
    if (i >= n_local) return;
    const int ks = s_begin + i;
    const int k0 = ks * BK;
    // x: BM rows x BK / 8 chunks of 8 elements
#pragma unroll
    for (int c0 = 0; c0 < C::BM * BK / 8; c0 += NT) {
      const int c = c0 + tid;
      const int r = c / (BK / 8), ch = c % (BK / 8);
      const int gm = m0 + r;
      const bool ok = gm < M && k0 + ch * 8 < K;
      const TI* src = x + (ok ? (size_t)gm * K + k0 + ch * 8 : 0);
      uint16_t* dst = xs + st * XS + r * XLD + ch * 8;
      if (VEC) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = ok ? reinterpret_cast<const uint16_t*>(src)[e] : 0;
      }
    }
    // codes: BK rows x BN / 16 chunks of 16 columns
#pragma unroll
    for (int c0 = 0; c0 < BK * (BN / 16); c0 += NT) {
      const int c = c0 + tid;
      const int r = c / (BN / 16), ch = c % (BN / 16);
      const int gn = n0 + ch * 16;
      const bool ok = gn < N && k0 + r < K;
      const int8_t* src = wq + (ok ? (size_t)(k0 + r) * N + gn : 0);
      int8_t* dst = cs + st * C::C_BYTES + r * BN + ch * 16;
      if (VEC) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = ok && gn + e < N ? src[e] : 0;
      }
    }
    // scales: SB rows of BN columns, chunks of 8
    if (tid < SB * BN / 8) {
      const int sb = tid / (BN / 8), ch = tid % (BN / 8);
      const int gn = n0 + ch * 8;
      const int kb = ks * SB + sb;
      const bool ok = gn < N && kb < nkb;
      const __half* src = ws + (ok ? (size_t)kb * N + gn : 0);
      uint16_t* dst = ss + (st * SB + sb) * BN + ch * 8;
      if (VEC) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = ok && gn + e < N ? __half_as_ushort(src[e]) : 0;
      }
    }
  };
  // the block's stage i of codes, widened into bs buffer i & 1
  auto widen = [&](int i) {
    if (i >= n_local) return;
#pragma unroll
    for (int c0 = 0; c0 < BK * (BN / 16); c0 += NT) {
      const int c = c0 + tid;
      const int r = c / (BN / 16), ch = c % (BN / 16);
      widen16<TI>(cs + (i % STAGES) * C::C_BYTES + r * BN + ch * 16,
                  bs + (i & 1) * BS + r * BLD + ch * 16);
    }
  };

  // Stages 0 .. STAGES - 2 in flight, stage 0 widened before the loop.
  // Iteration i: one barrier, after which stage i + 1 has landed and
  // stage i's widened tile is complete; it refills the buffer stage
  // i - 1 used, widens stage i + 1 into the other buffer, and runs stage
  // i's MMAs (the widening overlaps them), one scale block at a time.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    load(st, st);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  widen(0);

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // one scale block's two k16 steps of MMAs into part
  auto mma_block = [&](const uint16_t* xt, const uint16_t* bt, int sb,
                       float (&part)[MI][NJ][4]) {
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        part[a][j][0] = part[a][j][1] = part[a][j][2] = part[a][j][3] = 0.f;
#pragma unroll
    for (int kk = sb * 2; kk < sb * 2 + 2; ++kk) {
      uint32_t af[MI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(af[mi], xt + (wm * C::WM + mi * 16 + (lane & 15)) * XLD +
                                kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(
            bf, bt + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * BLD +
                    wn * C::WN + np * 16 + ((lane >> 4) << 3));
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma16816<TI>(part[mi][2 * np], af[mi], bf[0], bf[1]);
          mma16816<TI>(part[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  };
  // fold a block in: each of the thread's columns by its scale
  auto fold = [&](const uint16_t* sc, const float (&part)[MI][NJ][4]) {
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj) {
      const int c = wn * C::WN + nj * 8 + (lane & 3) * 2;
      const float2 s01 =
          __half22float2(*reinterpret_cast<const __half2*>(sc + c));
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        acc[mi][nj][0] = fmaf(part[mi][nj][0], s01.x, acc[mi][nj][0]);
        acc[mi][nj][1] = fmaf(part[mi][nj][1], s01.y, acc[mi][nj][1]);
        acc[mi][nj][2] = fmaf(part[mi][nj][2], s01.x, acc[mi][nj][2]);
        acc[mi][nj][3] = fmaf(part[mi][nj][3], s01.y, acc[mi][nj][3]);
      }
    }
  };

  for (int i = 0; i < n_local; ++i) {
    const int st = i % STAGES;
    cp_async_wait<STAGES - 3>();
    __syncthreads();
    load(i + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    widen(i + 1);
    const uint16_t* const xt = xs + st * XS;
    const uint16_t* const bt = bs + (i & 1) * BS;
#pragma unroll
    for (int sb = 0; sb < SB; ++sb) {
      float part[MI][NJ][4];
      mma_block(xt, bt, sb, part);
      fold(ss + (st * SB + sb) * BN, part);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gm = m0 + wm * C::WM + mi * 16 + (lane >> 2) + r * 8;
      if (gm >= M) continue;
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj) {
        const int gn = n0 + wn * C::WN + nj * 8 + (lane & 3) * 2;
        if (work != nullptr)   // this split's partial sums
          store2<float>(work, ((size_t)blockIdx.z * M + gm) * N + gn, gn, N,
                        acc[mi][nj][2 * r], acc[mi][nj][2 * r + 1]);
        else
          store2<TO>(y, (size_t)gm * N + gn, gn, N, acc[mi][nj][2 * r],
                     acc[mi][nj][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tile layout for f32 x: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;
constexpr int FTM = 4;
constexpr int FTN = 4;
constexpr int FNT = (FBM / FTM) * (FBN / FTN);  // 256 threads

template <typename TO>
__global__ void __launch_bounds__(FNT)
q8_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ wq,
              const __half* __restrict__ ws, TO* __restrict__ y, int M,
              int N, int K) {
  __shared__ float As[FBK][FBM + 4];  // activation tile, transposed
  __shared__ float Bs[FBK][FBN + 4];  // dequantized weight tile
  const int tid = threadIdx.x;
  const int tx = tid % (FBN / FTN);
  const int ty = tid / (FBN / FTN);
  const int m0 = blockIdx.y * FBM;
  const int n0 = blockIdx.x * FBN;

  float acc[FTM][FTN];
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
    for (int e = tid; e < FBM * FBK; e += FNT) {
      const int r = e / FBK, c = e % FBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int e = tid; e < FBK * FBN; e += FNT) {
      const int r = e / FBN, c = e % FBN;
      const int gk = k0 + r, gn = n0 + c;
      float v = 0.f;
      if (gk < K && gn < N) {
        v = static_cast<float>(wq[(size_t)gk * N + gn]) *
            __half2float(ws[(size_t)(gk / QBLOCK) * N + gn]);
      }
      Bs[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[FTM], b[FTN];
#pragma unroll
      for (int i = 0; i < FTM; ++i) a[i] = As[kk][ty * FTM + i];
#pragma unroll
      for (int j = 0; j < FTN; ++j) b[j] = Bs[kk][tx * FTN + j];
#pragma unroll
      for (int i = 0; i < FTM; ++i)
#pragma unroll
        for (int j = 0; j < FTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    const int gm = m0 + ty * FTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < FTN; ++j) {
      const int gn = n0 + tx * FTN + j;
      if (gn < N) y[(size_t)gm * N + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// GEMV layout: M <= 16, K split across warps and blocks
// ---------------------------------------------------------------------------

constexpr int GBN = 128;          // columns of a block: 8 lanes x 16
constexpr int GMT = 4;            // rows of x a block computes
constexpr int GMAXW = 4;          // warps of a block, at most
constexpr int GMAX_BLOCKS = 64;   // scale blocks a split, at most: x's
                                  // staging is 64 * 32 float4 = 32 KB

// 16 codes of one row (or fewer, masked) as a 16-byte word
template <bool VEC>
__device__ __forceinline__ int4 load_codes(const int8_t* p, int valid) {
  if (VEC) return valid > 0 ? __ldg(reinterpret_cast<const int4*>(p))
                            : make_int4(0, 0, 0, 0);
  int4 v = make_int4(0, 0, 0, 0);
  int8_t* c = reinterpret_cast<int8_t*>(&v);
#pragma unroll
  for (int e = 0; e < 16; ++e) c[e] = e < valid ? p[e] : 0;
  return v;
}

template <typename TI, typename TO, bool VEC>
__global__ void __launch_bounds__(GMAXW * 32)
q8_gemv_kernel(const TI* __restrict__ x, const int8_t* __restrict__ wq,
               const __half* __restrict__ ws, TO* __restrict__ y,
               float* __restrict__ work, int M, int N, int K, int bps) {
  extern __shared__ float4 xs[];        // xs[k] = x[m0 .. m0 + 3][k]
  __shared__ float red[GMAXW][GMT][GBN];
  const int tid = threadIdx.x;
  const int nw = blockDim.x / 32;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cg = lane & 7;      // 16-column group
  const int quarter = lane >> 3;
  const int n = blockIdx.x * GBN + cg * 16;
  const int valid = min(16, N - n);
  const int m0 = blockIdx.y * GMT;
  const int split = blockIdx.z;
  const int kb0 = split * bps;
  const int kb1 = min(K / QBLOCK, kb0 + bps);
  const int nk = max(0, kb1 - kb0) * QBLOCK;

  // let the split-sum kernel be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  // this lane's 8 rows x 16 codes of scale block kb, 16 bytes a row,
  // and (16-byte loads) its 16 scales
  int4 code[8];
  int4 sraw[2] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  auto fetch = [&](int kb) {
    const int r0 = kb * QBLOCK + quarter * 8;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      code[r] = load_codes<VEC>(wq + (size_t)(r0 + r) * N + n, valid);
    if (VEC && valid > 0) {
      const int4* sp = reinterpret_cast<const int4*>(ws + (size_t)kb * N + n);
      sraw[0] = __ldg(sp);
      sraw[1] = __ldg(sp + 1);
    }
  };
  int kb = kb0 + warp;
  if (kb < kb1) fetch(kb);   // in flight while x is staged

  for (int e = tid; e < nk; e += blockDim.x) {
    const size_t gk = (size_t)kb0 * QBLOCK + e;
    float v[GMT];
#pragma unroll
    for (int i = 0; i < GMT; ++i)
      v[i] = m0 + i < M ? to_f32(x[(size_t)(m0 + i) * K + gk]) : 0.f;
    xs[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  float acc[GMT][16];
#pragma unroll
  for (int i = 0; i < GMT; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  for (; kb < kb1; kb += nw) {
    const int x0 = kb * QBLOCK + quarter * 8 - kb0 * QBLOCK;
    const __half* sc = VEC ? reinterpret_cast<const __half*>(sraw)
                           : ws + (size_t)kb * N + n;
    // two halves of 8 columns keep the partial sums at 32 registers
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float part[GMT][8];
#pragma unroll
      for (int i = 0; i < GMT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 xv = xs[x0 + r];
        const uint32_t w0 = (half ? code[r].z : code[r].x) ^ 0x80808080u;
        const uint32_t w1 = (half ? code[r].w : code[r].y) ^ 0x80808080u;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float w = code_f32(j < 4 ? w0 : w1, j & 3);
          part[0][j] = fmaf(xv.x, w, part[0][j]);
          part[1][j] = fmaf(xv.y, w, part[1][j]);
          part[2][j] = fmaf(xv.z, w, part[2][j]);
          part[3][j] = fmaf(xv.w, w, part[3][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int jj = half * 8 + j;
        const float s = jj < valid ? __half2float(sc[jj]) : 0.f;
#pragma unroll
        for (int i = 0; i < GMT; ++i)
          acc[i][jj] = fmaf(part[i][j], s, acc[i][jj]);
      }
    }
    if (kb + nw < kb1) fetch(kb + nw);
  }

  // the 4 quarters of a column group, then the warps, in a fixed order
#pragma unroll
  for (int i = 0; i < GMT; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 8);
      acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 16);
    }
  if (quarter == 0) {
#pragma unroll
    for (int i = 0; i < GMT; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][i][cg * 16 + j] = acc[i][j];
  }
  __syncthreads();
  for (int e = tid; e < GMT * GBN; e += blockDim.x) {
    const int i = e / GBN, c = e % GBN;
    const int gm = m0 + i, gn = blockIdx.x * GBN + c;
    if (gm >= M || gn >= N) continue;
    float t = 0.f;
    for (int w = 0; w < nw; ++w) t += red[w][i][c];
    if (work != nullptr)
      work[((size_t)split * M + gm) * N + gn] = t;
    else
      y[(size_t)gm * N + gn] = from_f32<TO>(t);
  }
}

// y = the splits' partial sums added in split order. Launched as the
// programmatic dependent of the kernel that wrote them: it may start
// while that kernel runs and waits here until its grid has finished and
// its writes are visible.
template <typename TO>
__global__ void q8_splitk_sum_kernel(const float* __restrict__ work,
                                     TO* __restrict__ y, int mn, int splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= mn) return;
  float t = 0.f;
  for (int s = 0; s < splits; ++s) t += work[(size_t)s * mn + e];
  y[e] = from_f32<TO>(t);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Call {
  const void* x;
  const int8_t* wq;
  const __half* ws;
  void* y;
  float* work;
  int m, n, k, splits;
  bool vec;
  cudaStream_t stream;
};

// y = the sum of the splits' partials in work, launched as the
// programmatic dependent of the kernel that wrote them
template <typename TO>
void launch_split_sum(const Call& c) {
  const int mn = c.m * c.n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((mn + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = c.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, q8_splitk_sum_kernel<TO>,
                     static_cast<const float*>(c.work),
                     static_cast<TO*>(c.y), mn, c.splits);
}

template <typename TI, typename TO, bool VEC>
void launch_gemv(const Call& c) {
  const int nblocks = c.k / QBLOCK;
  const int bps = std::max(1, (nblocks + c.splits - 1) / c.splits);
  const int nw = std::min(GMAXW, bps);
  dim3 grid((c.n + GBN - 1) / GBN, (c.m + GMT - 1) / GMT, c.splits);
  const size_t smem = (size_t)bps * QBLOCK * sizeof(float4);
  q8_gemv_kernel<TI, TO, VEC><<<grid, nw * 32, smem, c.stream>>>(
      static_cast<const TI*>(c.x), c.wq, c.ws, static_cast<TO*>(c.y),
      c.splits > 1 ? c.work : nullptr, c.m, c.n, c.k, bps);
  if (c.splits > 1) launch_split_sum<TO>(c);
}

template <typename TI, typename TO, bool VEC, typename C>
void launch_tile(const Call& c) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      q8_tile_kernel<TI, TO, VEC, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((c.n + C::BN - 1) / C::BN, (c.m + C::BM - 1) / C::BM,
            c.splits);
  q8_tile_kernel<TI, TO, VEC, C><<<grid, C::NT, C::SMEM, c.stream>>>(
      static_cast<const TI*>(c.x), c.wq, c.ws, static_cast<TO*>(c.y), c.m,
      c.n, c.k, c.splits > 1 ? c.work : nullptr);
  if (c.splits > 1) launch_split_sum<TO>(c);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

template <typename TI, typename TO, bool VEC>
void launch_tile_any(const Call& c) {
  const int tiles = ((c.n + 63) / 64) * ((c.m + 63) / 64);
  if (tiles >= 2 * sm_count()) launch_tile<TI, TO, VEC, TileWide>(c);
  else launch_tile<TI, TO, VEC, TileDeep>(c);
}

template <typename TI, typename TO>
void launch(const Call& c) {
  if (c.m <= GEMV_MAX_M) {
    if (c.vec) launch_gemv<TI, TO, true>(c);
    else launch_gemv<TI, TO, false>(c);
    return;
  }
  if constexpr (std::is_same<TI, float>::value) {
    dim3 grid((c.n + FBN - 1) / FBN, (c.m + FBM - 1) / FBM);
    q8_f32_kernel<TO><<<grid, FNT, 0, c.stream>>>(
        static_cast<const float*>(c.x), c.wq, c.ws, static_cast<TO*>(c.y),
        c.m, c.n, c.k);
  } else {
    if (c.vec) launch_tile_any<TI, TO, true>(c);
    else launch_tile_any<TI, TO, false>(c);
  }
}

template <typename TI>
bool launch_out(int out_dtype, const Call& c) {
  switch (out_dtype) {
    case 0: launch<TI, float>(c); return true;
    case 1: launch<TI, __nv_bfloat16>(c); return true;
    case 2: launch<TI, __half>(c); return true;
    default: return false;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (M, K) in in_dtype; wq: (K, N) int8; ws: (K/32, N) float16;
// y: (M, N) in out_dtype. dtype codes: 0 = f32, 1 = bf16, 2 = f16.
// K % 32 == 0. k_splits >= 1 splits K across blocks (the GEMV layout,
// M <= 16: ceil((K/32) / k_splits) <= 64 scale blocks a split; the tile
// layout: whole stages; f32 x above 16 rows: ignored); with k_splits > 1
// work holds k_splits * M * N floats.
extern "C" int q8_matmul(const void* x, const void* wq, const void* ws,
                         void* y, void* work, int m, int n, int k,
                         int k_splits, int in_dtype, int out_dtype,
                         void* stream) {
  if (k % QBLOCK || k_splits < 1 || (k_splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= GEMV_MAX_M &&
      (k / QBLOCK + k_splits - 1) / k_splits > GMAX_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m > GEMV_MAX_M && in_dtype == 0) k_splits = 1;   // the f32 loop
  const bool vec = n % 16 == 0 && aligned16(wq) && aligned16(ws) &&
                   aligned16(x);
  Call c{x, static_cast<const int8_t*>(wq), static_cast<const __half*>(ws),
         y, static_cast<float*>(work), m, n, k, k_splits, vec,
         static_cast<cudaStream_t>(stream)};
  bool ok = false;
  switch (in_dtype) {
    case 0: ok = launch_out<float>(out_dtype, c); break;
    case 1: ok = launch_out<__nv_bfloat16>(out_dtype, c); break;
    case 2: ok = launch_out<__half>(out_dtype, c); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
