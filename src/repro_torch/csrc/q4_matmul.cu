// Q4_0 GEMM y[M,N] = x[M,K] @ dequant(wp[K/2,N], ws[K/32,N]) with f32
// accumulation, for Hopper.
//
// Replaces the TPU kernel q4_matmul_pallas (src/repro/kernels/q4_matmul/
// q4_matmul.py, _q4_matmul_kernel): the weight is stored as two 4-bit
// codes a byte along K (low nibble = even k, +8 bias) with one f16 scale
// per 32 rows, and is unpacked and scaled next to the dot (paper C1), so
// device memory streams 0.5625 bytes per weight. The dequantized weight
// exists only in registers, never in device memory.
//
// Bound on this card: bytes by the roofline, latency in fact. The port
// runs it only for the speculative draft's decode GEMMs, where M is the
// number of serving lanes (1-4): each packed byte feeds 2 * M FMAs, and
// the whole packed weight of a draft GEMM (0.08-0.33 MB) streams in
// 0.03-0.1 us at 3.35 TB/s. What costs is the chain of a launch: the
// first loads, the sums across lanes, warps and CTAs, the store. One
// source, three layouts; the wrapper picks one (kernels/q4_matmul/ops.py,
// plan) and the C entry point checks that it applies:
//
//  * Tensor-core GEMV (M <= 16, bf16 or f16 x on 4-byte aligned rows; the
//    draft's every call): m16n8k16 mma.sync with x as A (all M rows, 0 past
//    M) and the codes as B. A code becomes c - 8 exactly in two
//    instructions a pair (the nibble in the mantissa of 128 or 1024, the
//    bias subtracted), so the products are exact and summed in f32 by the
//    tensor cores, and each 32-row block's sums are scaled once by its f16
//    scales. A CTA owns 16 columns; its warps split the rank's K into runs
//    of 16-k chunks, each lane loading 16 bytes of two packed rows and the
//    x pairs of its fragment straight from device memory (no staging, no
//    barrier before the sums); K is split over a cluster where the column
//    tiles alone leave SMs idle, the sums added as below.
//  * GEMV on the CUDA cores (M <= 16, f32 x, or rows of x not 4-byte
//    aligned): a lane reads 16 bytes of one packed row, 16 neighbouring
//    columns x 2 k, and unpacks the nibbles in registers
//    (each byte placed in the mantissa of 2^23, the bias subtracted: two
//    instructions a code). A warp holds CGW column groups of 16 and
//    32 / CGW lanes along K; a lane takes a contiguous run of packed rows,
//    so it crosses few scale blocks, and scales its f32 partial sums once
//    a 32-row block it touches. A lane loads its own x (up to 4 rows, more
//    as row groups of the grid; lanes on one row share it through L1) and
//    scales beside its w: no shared-memory staging and no barrier before
//    the sums, whose latency (not the bytes) sets the time. Where the
//    column tiles alone leave the SMs idle, K is split across the CTAs of
//    a thread block cluster (up to 8): the lanes of a warp sum by halving
//    (each lane keeps half of its sums a level), the warps through shared
//    memory, and each CTA writes each slice of its sums into the shared
//    memory of the rank that adds that slice (distributed shared memory),
//    which adds them in rank order after the cluster's barrier. One
//    launch, no workspace, no atomics: the order of every sum is fixed.
//  * Row tile (M > 16; no path of the port runs it): a block owns BN = 32
//    output columns and all K for MT = 4 rows of x; its 8 warps split K by
//    32-row scale block, each lane one column; x is staged in shared
//    memory as f32 and the warps' partial sums reduced there.
//
// K must be a multiple of 32; ragged M and N are masked in the loads and
// the stores.

#include "common.cuh"
#include "tensor_core.cuh"
#include <cooperative_groups.h>

// Measurement builds only (kernels/q4_matmul/probe.py times them beside
// the shipped build, Q4_PROBE 0, which is the only one the port loads):
// they take parts out of the GEMVs. 1: no loads and no products (the sums
// across lanes, warps and ranks, the store); 2: the launch alone (each
// CTA stores zeros); 3: the loads without the products.
#ifndef Q4_PROBE
#define Q4_PROBE 0
#endif
#include <stddef.h>
#include <stdint.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int QBLOCK = 32;
constexpr int GEMV_MAX_M = 16;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// element i of y in dtype code dt (0 = f32, 1 = bf16, 2 = f16)
__device__ __forceinline__ void store_from_f32(void* p, int dt, size_t i,
                                               float v) {
  if (dt == 0) static_cast<float*>(p)[i] = v;
  else if (dt == 1) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<__half*>(p)[i] = __float2half(v);
}

// ---------------------------------------------------------------------------
// Row tile: M > 16
// ---------------------------------------------------------------------------

constexpr int BN = 32;        // output columns of a block (one per lane)
constexpr int KG = 8;         // warps splitting K
constexpr int MT = 4;         // rows of x a block computes together
constexpr int KC = 512;       // K chunk of x staged in shared memory
constexpr int NT = BN * KG;   // 256 threads

template <typename TI, typename TO>
__global__ void __launch_bounds__(NT)
q4_rows_kernel(const TI* __restrict__ x, const uint8_t* __restrict__ wp,
                 const __half* __restrict__ ws, TO* __restrict__ y, int M,
                 int N, int K) {
  __shared__ float xs[MT][KC];        // activation chunk, f32
  __shared__ float red[KG][MT][BN];   // per-warp partial sums
  const int tid = threadIdx.x;
  const int lane = tid % BN;
  const int warp = tid / BN;
  const int n = blockIdx.x * BN + lane;
  const int m0 = blockIdx.y * MT;
  const bool col_ok = n < N;

  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = tid; e < MT * KC; e += NT) {
      const int r = e / KC, c = e % KC;
      const int gm = m0 + r;
      xs[r][c] = (gm < M && c < kc) ? to_f32(x[(size_t)gm * K + k0 + c]) : 0.f;
    }
    __syncthreads();
    if (col_ok) {
      for (int blk = warp; blk < kc / QBLOCK; blk += KG) {
        const int gblk = k0 / QBLOCK + blk;
        const uint8_t* col = wp + (size_t)gblk * (QBLOCK / 2) * N + n;
        float part[MT];
#pragma unroll
        for (int i = 0; i < MT; ++i) part[i] = 0.f;
#pragma unroll 4
        for (int r = 0; r < QBLOCK / 2; ++r) {
          const unsigned byte = col[(size_t)r * N];
          const float lo = static_cast<float>(static_cast<int>(byte & 0xfu) - 8);
          const float hi = static_cast<float>(static_cast<int>(byte >> 4) - 8);
          const int c = blk * QBLOCK + 2 * r;
#pragma unroll
          for (int i = 0; i < MT; ++i)
            part[i] = fmaf(xs[i][c + 1], hi, fmaf(xs[i][c], lo, part[i]));
        }
        const float s = __half2float(ws[(size_t)gblk * N + n]);
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i] = fmaf(part[i], s, acc[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) red[warp][i][lane] = acc[i];
  __syncthreads();
  if (tid < MT * BN) {
    const int i = tid / BN;
    const int gm = m0 + i;
    if (gm < M && col_ok) {
      float tot = 0.f;
#pragma unroll
      for (int w = 0; w < KG; ++w) tot += red[w][i][lane];
      y[(size_t)gm * N + n] = from_f32<TO>(tot);
    }
  }
}


template <typename TI, typename TO>
int launch_rows(const void* x, const void* wp, const void* ws, void* y,
                int m, int n, int k, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + MT - 1) / MT);
  q4_rows_kernel<TI, TO><<<grid, NT, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const __half*>(ws), static_cast<TO*>(y), m, n, k);
  return 0;
}

template <typename TI>
int launch_rows_out(int out_dtype, const void* x, const void* wp,
                    const void* ws, void* y, int m, int n, int k,
                    cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch_rows<TI, float>(x, wp, ws, y, m, n, k, s);
    case 1: return launch_rows<TI, __nv_bfloat16>(x, wp, ws, y, m, n, k, s);
    case 2: return launch_rows<TI, __half>(x, wp, ws, y, m, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// GEMV: M <= 16, K split across the CTAs of a cluster
// ---------------------------------------------------------------------------

constexpr int GV_MAX_WARPS = 8;
constexpr float CODE_BIAS = 8388616.f;   // 2^23 + 8

// code q (0-3) of the four in v, one in the low nibble of each byte, as
// f32 c - 8: the byte goes into the mantissa of 2^23, the bias comes off
__device__ __forceinline__ float code(uint32_t v, int q) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650u + q)) -
         CODE_BIAS;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The sums of the KSTEP lanes of a warp that share a column group (lane
// bits log2(CGW) and up): at each level a lane keeps one half of its V
// values, adds its partner's copy of that half and sends the other half;
// once one value is left, the remaining levels add it whole. After
// log2(KSTEP) levels each lane holds max(1, V / KSTEP) totals. The order
// of every sum is fixed.
template <int V, int CGW, int KSTEP>
__device__ __forceinline__ void warp_halve(float* v, int ks) {
  if constexpr (KSTEP > 1) {
    if constexpr (V > 1) {
      constexpr int H = V / 2;
      const bool up = ks & 1;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float send = up ? v[j] : v[j + H];
        const float keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, CGW);
      }
      warp_halve<H, CGW * 2, KSTEP / 2>(v, ks >> 1);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], CGW);
      warp_halve<1, CGW * 2, KSTEP / 2>(v, ks >> 1);
    }
  }
}

// floats of shared memory a GEMV CTA takes: its warps' sums and the slots
// of the sums other ranks send it
__host__ __device__ __forceinline__ int gemv_smem_floats(int mt, int tile,
                                                          int nw, int ranks) {
  return nw * mt * tile + ranks * ((mt * tile + ranks - 1) / ranks);
}

// two neighbouring values of x as f32: one 4- or 8-byte load where x's
// rows are aligned to it
template <typename TX>
__device__ __forceinline__ float2 load_pair(const TX* p, int vec) {
  if (vec) {
    if constexpr (sizeof(TX) == 4) {
      return __ldg(reinterpret_cast<const float2*>(p));
    } else {
      const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
      const TX* t = reinterpret_cast<const TX*>(&u);
      return make_float2(to_f32(t[0]), to_f32(t[1]));
    }
  }
  return make_float2(to_f32(p[0]), to_f32(p[1]));
}

// CTA (rank r of a cluster of gridDim.x, column tile blockIdx.y, rows of x
// [blockIdx.z * MTR, + MTR)): columns [blockIdx.y * TILE, + TILE), packed
// rows [r * rpr, min(K / 2, (r + 1) * rpr)). Lane = (row worker ks,
// column group cgi); worker kw = warp * KSTEP + ks takes a contiguous run
// of rows. A lane loads what it multiplies itself: per packed row 16
// bytes of w and the MTR pairs of x it meets (lanes on one row read the
// same x, so L1 serves all but the first), U rows in flight while the U
// before them are multiplied, and the f16 scales of the first and the
// last 32-row block of its run with its first rows. No barrier comes
// before the sums.
template <typename TX, int MTR, int CGW>
__global__ void __launch_bounds__(GV_MAX_WARPS * 32)
q4_gemv_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ wp,
               const __half* __restrict__ ws, void* __restrict__ y, int y_dt,
               int M, int N, int K, int rpr, int vec_x, int vec_w) {
  constexpr int TILE = CGW * 16;        // columns of a CTA
  constexpr int KSTEP = 32 / CGW;       // lanes of a warp along K
  constexpr int V = MTR * 16;           // sums of a lane
  constexpr int U = MTR == 4 ? 2 : 4;   // rows of wp a lane has in flight
  extern __shared__ float4 gv_raw[];
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt / 32;
  const int lane = tid % 32, warp = tid / 32;
  const int cgi = lane % CGW, ks = lane / CGW;
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int m0 = blockIdx.z * MTR;
  const int n = blockIdx.y * TILE + cgi * 16;   // the lane's first column
  const int valid = min(16, N - n);
  const int p0 = rank * rpr;
  const int nrows = max(0, min(K / 2, p0 + rpr) - p0);
  const int workers = nw * KSTEP;
  const int rpw = (nrows + workers - 1) / workers;
  const int r0 = min(nrows, (warp * KSTEP + ks) * rpw);
  const int r1 = min(nrows, r0 + rpw);

  float* const red = reinterpret_cast<float*>(gv_raw);   // [nw][MTR][TILE]
  float* const recv = red + nw * MTR * TILE;             // [ranks][per]
  cg::cluster_group cluster = cg::this_cluster();
  // a rank writes into the others' shared memory only once they have
  // all started: arrive now, wait before the first such write
  if (ranks > 1) cluster_arrive_relaxed();

  auto load_row = [&](int r) -> uint4 {
    const uint8_t* p = wp + (size_t)(p0 + r) * N + n;
    if (vec_w)
      return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(p))
                       : make_uint4(0, 0, 0, 0);
    uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < valid) wd[i / 4] |= (uint32_t)__ldg(p + i) << (8 * (i % 4));
    return make_uint4(wd[0], wd[1], wd[2], wd[3]);
  };
  // the 16 f16 scales of the lane's columns in 32-row block b (0 past N)
  auto load_scales = [&](uint4 (&sc)[2], int b) {
    const __half* p = ws + (size_t)b * N + n;
    if (vec_w && valid > 0) {
      sc[0] = __ldg(reinterpret_cast<const uint4*>(p));
      sc[1] = __ldg(reinterpret_cast<const uint4*>(p) + 1);
      return;
    }
    uint32_t wd[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      wd[i] = (2 * i < valid ? (uint32_t)__half_as_ushort(p[2 * i]) : 0u) |
              (2 * i + 1 < valid
                   ? (uint32_t)__half_as_ushort(p[2 * i + 1]) << 16 : 0u);
    sc[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    sc[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
  };
  const TX* const xb = x + (size_t)m0 * K + 2 * p0;
  auto fetch = [&](uint4 (&w)[U], float2 (&xv)[U][MTR], int r) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = r + u < r1;
      w[u] = in ? load_row(r + u) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < MTR; ++i)
        xv[u][i] = in && m0 + i < M
            ? load_pair(xb + (size_t)i * K + 2 * (r + u), vec_x)
            : make_float2(0.f, 0.f);
    }
  };

  float acc[V], part[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = part[j] = 0.f;
#if Q4_PROBE == 0 || Q4_PROBE == 3
  uint4 cur[U], nxt[U];
  float2 xc[U][MTR], xn[U][MTR];
  fetch(cur, xc, r0);
  // the scales of the run's first and last blocks; any between are loaded
  // when they are reached (runs of more than 16 rows only)
  const int ba = (p0 + r0) / 16, bb = (p0 + max(r0, r1 - 1)) / 16;
  uint4 sa[2], sb[2];
  if (r1 > r0) {
    load_scales(sa, ba);
    if (bb != ba) load_scales(sb, bb);
  }
  int blk = ba;
  // acc += part * the scales of block blk, once a block a lane touches
  auto flush = [&]() {
    uint4 sc[2];
    if (blk == ba) {
      sc[0] = sa[0];
      sc[1] = sa[1];
    } else if (blk == bb) {
      sc[0] = sb[0];
      sc[1] = sb[1];
    } else {
      load_scales(sc, blk);
    }
    const __half2* h2 = reinterpret_cast<const __half2*>(sc);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float2 s2 = __half22float2(h2[q]);
#pragma unroll
      for (int i = 0; i < MTR; ++i) {
        acc[i * 16 + 2 * q] = fmaf(part[i * 16 + 2 * q], s2.x,
                                   acc[i * 16 + 2 * q]);
        acc[i * 16 + 2 * q + 1] = fmaf(part[i * 16 + 2 * q + 1], s2.y,
                                       acc[i * 16 + 2 * q + 1]);
        part[i * 16 + 2 * q] = part[i * 16 + 2 * q + 1] = 0.f;
      }
    }
  };
  for (int r = r0; r < r1; r += U) {
    fetch(nxt, xn, r + U);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u;
      if (rr >= r1) break;
      const int b = (p0 + rr) / 16;
      if (b != blk) {
        flush();
        blk = b;
      }
#if Q4_PROBE == 3
      part[0] += __uint_as_float(cur[u].x & cur[u].w & 1u) + xc[u][0].x;
#else
      const uint32_t wv[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) {
        const uint32_t lo = wv[w4] & 0x0f0f0f0fu;
        const uint32_t hi = (wv[w4] >> 4) & 0x0f0f0f0fu;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float cl = code(lo, q), ch = code(hi, q);
          const int j = 4 * w4 + q;
#pragma unroll
          for (int i = 0; i < MTR; ++i)
            part[i * 16 + j] =
                fmaf(xc[u][i].y, ch, fmaf(xc[u][i].x, cl, part[i * 16 + j]));
        }
      }
#endif
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[u] = nxt[u];
#pragma unroll
      for (int i = 0; i < MTR; ++i) xc[u][i] = xn[u][i];
    }
  }
  if (r1 > r0) flush();
#else
  (void)fetch;
  (void)load_scales;
#endif
#if Q4_PROBE == 2
  for (int e = tid; e < MTR * TILE; e += nt) {
    const int gm = m0 + e / TILE, gn = blockIdx.y * TILE + e % TILE;
    if (gm < M && gn < N) store_from_f32(y, y_dt, (size_t)gm * N + gn, 0.f);
  }
  if (ranks > 1) cluster_wait();
  return;
#endif

  // the warp's lanes along K, then the warps in order into this CTA's
  // sums; each rank then sends the slice of them that rank q adds to rank
  // q, and after the cluster's barrier adds the slices it received in
  // rank order
  warp_halve<V, CGW, KSTEP>(acc, ks);
  constexpr int KEEP = V >= KSTEP ? V / KSTEP : 1;   // totals of a lane
  int start = 0;
#pragma unroll
  for (int l = 0, h = V / 2; (1 << l) < KSTEP && h > 0; ++l, h /= 2)
    start += ((ks >> l) & 1) * h;
  const int outs = MTR * TILE;
  // where V < KSTEP, KSTEP / V lanes hold each total: the first writes it
  if (V >= KSTEP || ks < V) {
#pragma unroll
    for (int v = 0; v < KEEP; ++v) {
      const int g = start + v;
      red[warp * outs + (g / 16) * TILE + cgi * 16 + g % 16] = acc[v];
    }
  }
  __syncthreads();
  const int per = (outs + ranks - 1) / ranks;   // outputs a rank adds
  if (ranks > 1) cluster_wait();   // every rank has started
  for (int e = tid; e < outs; e += nt) {
    float t = 0.f;
    for (int wi = 0; wi < nw; ++wi) t += red[wi * outs + e];
    if (ranks == 1) {
      const int gm = m0 + e / TILE, gn = blockIdx.y * TILE + e % TILE;
      if (gm < M && gn < N) store_from_f32(y, y_dt, (size_t)gm * N + gn, t);
    } else {
      *cluster.map_shared_rank(recv + rank * per + e % per, e / per) = t;
    }
  }
  if (ranks == 1) return;
  cluster.sync();
  const int e0 = rank * per, e1 = min(outs, e0 + per);
  for (int e = e0 + tid; e < e1; e += nt) {
    const int gm = m0 + e / TILE, gn = blockIdx.y * TILE + e % TILE;
    if (gm >= M || gn >= N) continue;
    float t = 0.f;
    for (int q = 0; q < ranks; ++q) t += recv[q * per + e - e0];
    store_from_f32(y, y_dt, (size_t)gm * N + gn, t);
  }
}

template <typename TX, int MTR, int CGW>
int launch_gemv(const void* x, const void* wp, const void* ws, void* y,
                int y_dt, int m, int n, int k, int warps, int ranks,
                cudaStream_t s) {
  constexpr int TILE = CGW * 16;
  const int rows = k / 2;
  const int rpr = 8 * cdiv(cdiv(rows, ranks), 8);
  if (cdiv(rows, rpr) != ranks) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (size_t)gemv_smem_floats(MTR, TILE, warps, ranks);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, cdiv(n, TILE), cdiv(m, MTR));
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = ranks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  const int vec_x =
      (reinterpret_cast<uintptr_t>(x) % (2 * sizeof(TX))) == 0;
  const int vec_w = aligned16(wp) && aligned16(ws) && n % 16 == 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, q4_gemv_kernel<TX, MTR, CGW>, static_cast<const TX*>(x),
      static_cast<const uint8_t*>(wp), static_cast<const __half*>(ws), y,
      y_dt, m, n, k, rpr, vec_x, vec_w));
}

template <typename TX, int MTR>
int launch_gemv_cgw(const void* x, const void* wp, const void* ws, void* y,
                    int y_dt, int m, int n, int k, int cgw, int warps,
                    int ranks, cudaStream_t s) {
  switch (cgw) {
    case 1: return launch_gemv<TX, MTR, 1>(x, wp, ws, y, y_dt, m, n, k, warps, ranks, s);
    case 2: return launch_gemv<TX, MTR, 2>(x, wp, ws, y, y_dt, m, n, k, warps, ranks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// rows of x a GEMV CTA computes: 1, 2, or 4 (more as row groups)
template <typename TX>
int launch_gemv_any(const void* x, const void* wp, const void* ws, void* y,
                    int y_dt, int m, int n, int k, int cgw, int warps,
                    int ranks, cudaStream_t s) {
  if (m == 1) return launch_gemv_cgw<TX, 1>(x, wp, ws, y, y_dt, m, n, k, cgw, warps, ranks, s);
  if (m == 2) return launch_gemv_cgw<TX, 2>(x, wp, ws, y, y_dt, m, n, k, cgw, warps, ranks, s);
  return launch_gemv_cgw<TX, 4>(x, wp, ws, y, y_dt, m, n, k, cgw, warps, ranks, s);
}


// ---------------------------------------------------------------------------
// Tensor-core GEMV: bf16 or f16 x, M <= 16
// ---------------------------------------------------------------------------

constexpr int MMA_ROWS = 4;   // 16-k chunks of w a warp has in flight

// the 4-bit codes of `byte` as a pair of T (low nibble = even k in the low
// half), c - 8 exactly: each nibble goes into the mantissa of 128 (bf16) or
// 1024 (f16) and 136 or 1032 comes off
template <typename T>
__device__ __forceinline__ uint32_t codes2(uint32_t byte) {
  const uint32_t v = (byte & 0xfu) | ((byte & 0xf0u) << 12);
  uint32_t out;
  if constexpr (std::is_same<T, __half>::value) {
    const uint32_t m = v | 0x64006400u;
    __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&m),
                        __floats2half2_rn(1032.f, 1032.f));
    out = *reinterpret_cast<uint32_t*>(&h);
  } else {
    const uint32_t m = v | 0x43004300u;
    __nv_bfloat162 h = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                               __floats2bfloat162_rn(136.f, 136.f));
    out = *reinterpret_cast<uint32_t*>(&h);
  }
  return out;
}

// CTA (rank r of a cluster of gridDim.x, 16 columns blockIdx.y * 16):
// packed rows [r * rpr, min(K / 2, (r + 1) * rpr)) of all M <= 16 rows of
// x, split over the warps as contiguous runs of 16-k chunks (8 packed
// rows). Per chunk a warp issues m16n8k16 twice (two tiles of 8 columns):
// A is x (rows g and g + 8 of lane (g, t), read as pairs straight from
// device memory, 0 past M), B the chunk's codes: lane (g, t) reads packed
// rows t and t + 4 of the chunk (16 bytes each, shared by the 8 lanes of
// one t) and takes the bytes of columns g and 8 + g, and the f16 scales
// of the chunk's block with them. The f32 products of a 32-row block are
// scaled once by that block's scales.
template <typename TX>
__global__ void __launch_bounds__(GV_MAX_WARPS * 32)
q4_mma_kernel(const TX* __restrict__ x, const uint8_t* __restrict__ wp,
              const __half* __restrict__ ws, void* __restrict__ y, int y_dt,
              int M, int N, int K, int rpr, int vec_w) {
  constexpr int TILE = 16;
  constexpr int U = MMA_ROWS;
  extern __shared__ float4 gv_raw[];
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt / 32;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int n0 = blockIdx.y * TILE;
  const int valid = min(16, N - n0);
  const int p0 = rank * rpr;
  const int nrows = max(0, min(K / 2, p0 + rpr) - p0);
  const int nch = nrows / 8;                    // 16-k chunks of the rank
  const int cpw = (nch + nw - 1) / nw;
  const int c0 = min(nch, warp * cpw), c1 = min(nch, c0 + cpw);
  float* const red = reinterpret_cast<float*>(gv_raw);   // [nw][16][TILE]
  float* const recv = red + nw * 16 * TILE;              // [ranks][per]
  cg::cluster_group cluster = cg::this_cluster();
  if (ranks > 1) cluster_arrive_relaxed();

  auto load_row = [&](int p) -> uint4 {   // 16 columns of packed row p
    const uint8_t* q = wp + (size_t)p * N + n0;
    if (vec_w)
      return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(q))
                       : make_uint4(0, 0, 0, 0);
    uint32_t wd[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < valid) wd[i / 4] |= (uint32_t)__ldg(q + i) << (8 * (i % 4));
    return make_uint4(wd[0], wd[1], wd[2], wd[3]);
  };
  // x[row][k], x[row][k + 1] as one 32-bit pair (0 past M)
  auto load_x = [&](int row, int k) -> uint32_t {
    return row < M ? __ldg(reinterpret_cast<const unsigned*>(
                         x + (size_t)row * K + k))
                   : 0u;
  };
  // the scales of columns (2 t, 2 t + 1) of both 8-column tiles in block b
  auto load_scale = [&](int nt8, int b) -> float2 {
    const int c = n0 + nt8 * 8 + 2 * t;
    const __half* q = ws + (size_t)b * N + c;
    if (vec_w) return __half22float2(*reinterpret_cast<const __half2*>(q));
    return make_float2(c < N ? __half2float(q[0]) : 0.f,
                       c + 1 < N ? __half2float(q[1]) : 0.f);
  };

  float acc[2][4], part[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = part[j][i] = 0.f;
  int blk = (p0 + 8 * c0) / 16;
  float2 cur_sc[2];   // the scales of block blk, loaded with its chunks
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      acc[j][0] = fmaf(part[j][0], cur_sc[j].x, acc[j][0]);
      acc[j][1] = fmaf(part[j][1], cur_sc[j].y, acc[j][1]);
      acc[j][2] = fmaf(part[j][2], cur_sc[j].x, acc[j][2]);
      acc[j][3] = fmaf(part[j][3], cur_sc[j].y, acc[j][3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) part[j][i] = 0.f;
    }
  };
#if Q4_PROBE == 0 || Q4_PROBE == 3
  for (int c = c0; c < c1; c += U) {
    uint4 lo[U], hi[U];      // packed rows t and t + 4 of each chunk
    uint32_t a[U][4];
    float2 sc[U][2];         // the scales of each chunk's block
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = c + u < c1;
      const int p = p0 + 8 * (c + u);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        sc[u][j] = in ? load_scale(j, p / 16) : make_float2(0.f, 0.f);
      lo[u] = in ? load_row(p + t) : make_uint4(0, 0, 0, 0);
      hi[u] = in ? load_row(p + t + 4) : make_uint4(0, 0, 0, 0);
      const int k = 2 * p + 2 * t;
      a[u][0] = in ? load_x(g, k) : 0u;
      a[u][1] = in ? load_x(g + 8, k) : 0u;
      a[u][2] = in ? load_x(g, k + 8) : 0u;
      a[u][3] = in ? load_x(g + 8, k + 8) : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c + u >= c1) break;
      const int b = (p0 + 8 * (c + u)) / 16;
      if (b != blk) {
        flush();
        blk = b;
      }
      cur_sc[0] = sc[u][0];
      cur_sc[1] = sc[u][1];
      // columns g (tile 0) and 8 + g (tile 1) of rows t and t + 4
      const uint32_t b00 = codes2<TX>(__byte_perm(lo[u].x, lo[u].y, g) & 0xffu);
      const uint32_t b01 = codes2<TX>(__byte_perm(hi[u].x, hi[u].y, g) & 0xffu);
      const uint32_t b10 = codes2<TX>(__byte_perm(lo[u].z, lo[u].w, g) & 0xffu);
      const uint32_t b11 = codes2<TX>(__byte_perm(hi[u].z, hi[u].w, g) & 0xffu);
#if Q4_PROBE == 3
      part[0][0] += __uint_as_float((b00 ^ b01 ^ b10 ^ b11 ^ a[u][0] ^
                                     a[u][1] ^ a[u][2] ^ a[u][3]) & 1u);
#else
      mma16816<TX>(part[0], a[u], b00, b01);
      mma16816<TX>(part[1], a[u], b10, b11);
#endif
    }
  }
  if (c1 > c0) flush();
#else
  (void)load_row;
  (void)load_x;
  (void)load_scale;
  (void)flush;
#endif
#if Q4_PROBE == 2
  for (int e = tid; e < M * TILE; e += nt)
    if (n0 + e % TILE < N)
      store_from_f32(y, y_dt, (size_t)(e / TILE) * N + n0 + e % TILE, 0.f);
  if (ranks > 1) cluster_wait();
  return;
#endif

  // the warps in order into this CTA's sums (rows under M), then the
  // ranks as in the GEMV
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = j * 8 + 2 * t;
    red[(warp * 16 + g) * TILE + col] = acc[j][0];
    red[(warp * 16 + g) * TILE + col + 1] = acc[j][1];
    red[(warp * 16 + g + 8) * TILE + col] = acc[j][2];
    red[(warp * 16 + g + 8) * TILE + col + 1] = acc[j][3];
  }
  __syncthreads();
  const int outs = M * TILE;
  const int per = (outs + ranks - 1) / ranks;
  if (ranks > 1) cluster_wait();
  for (int e = tid; e < outs; e += nt) {
    float s = 0.f;
    for (int wi = 0; wi < nw; ++wi) s += red[wi * 16 * TILE + e];
    if (ranks == 1) {
      const int gn = n0 + e % TILE;
      if (gn < N) store_from_f32(y, y_dt, (size_t)(e / TILE) * N + gn, s);
    } else {
      *cluster.map_shared_rank(recv + rank * per + e % per, e / per) = s;
    }
  }
  if (ranks == 1) return;
  cluster.sync();
  const int e0 = rank * per, e1 = min(outs, e0 + per);
  for (int e = e0 + tid; e < e1; e += nt) {
    const int gn = n0 + e % TILE;
    if (gn >= N) continue;
    float s = 0.f;
    for (int q = 0; q < ranks; ++q) s += recv[q * per + e - e0];
    store_from_f32(y, y_dt, (size_t)(e / TILE) * N + gn, s);
  }
}

template <typename TX>
int launch_mma(const void* x, const void* wp, const void* ws, void* y,
               int y_dt, int m, int n, int k, int warps, int ranks,
               cudaStream_t s) {
  constexpr int TILE = 16;
  const int rows = k / 2;
  const int rpr = 8 * cdiv(cdiv(rows, ranks), 8);
  if (cdiv(rows, rpr) != ranks || (reinterpret_cast<uintptr_t>(x) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) *
      ((size_t)warps * 16 * TILE + ranks * cdiv(m * TILE, ranks));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, cdiv(n, TILE), 1);
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = ranks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  const int vec_w = aligned16(wp) && aligned16(ws) && n % 16 == 0;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, q4_mma_kernel<TX>, static_cast<const TX*>(x),
      static_cast<const uint8_t*>(wp), static_cast<const __half*>(ws), y,
      y_dt, m, n, k, rpr, vec_w));
}

}  // namespace

// x: (M, K) in in_dtype; wp: (K/2, N) uint8, row r holding k = 2r (low
// nibble) and 2r + 1 (high nibble), codes + 8; ws: (K/32, N) float16;
// y: (M, N) in out_dtype. dtype codes: 0 = f32, 1 = bf16, 2 = f16.
// K % 32 == 0. layout 0: the row tile (M > 16); layout 1: the CUDA-core
// GEMV (M <= 16) with cgw column groups of 16 a warp (1 or 2); layout 2:
// the tensor-core GEMV (M <= 16, bf16 or f16 x 4-byte aligned). Both
// GEMVs take `warps` warps a CTA (1-8) and `ranks` CTAs a cluster
// splitting K (1-8, each a whole number of 8-row runs of wp: ceil(K / 2 /
// ranks) rounded up to 8 must leave no rank empty). Anything else returns
// cudaErrorInvalidValue.
extern "C" int q4_matmul(const void* x, const void* wp, const void* ws,
                         void* y, int m, int n, int k, int in_dtype,
                         int out_dtype, int layout, int cgw, int warps,
                         int ranks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (k % QBLOCK || m < 1 || n < 1 || out_dtype < 0 || out_dtype > 2)
    return bad;
  int rc = bad;
  if (layout == 0) {
    switch (in_dtype) {
      case 0: rc = launch_rows_out<float>(out_dtype, x, wp, ws, y, m, n, k, s); break;
      case 1: rc = launch_rows_out<__nv_bfloat16>(out_dtype, x, wp, ws, y, m, n, k, s); break;
      case 2: rc = launch_rows_out<__half>(out_dtype, x, wp, ws, y, m, n, k, s); break;
      default: break;
    }
  } else if (layout == 1) {
    if (m > GEMV_MAX_M || warps < 1 || warps > GV_MAX_WARPS || ranks < 1 ||
        ranks > 8)
      return bad;
    switch (in_dtype) {
      case 0: rc = launch_gemv_any<float>(x, wp, ws, y, out_dtype, m, n, k, cgw, warps, ranks, s); break;
      case 1: rc = launch_gemv_any<__nv_bfloat16>(x, wp, ws, y, out_dtype, m, n, k, cgw, warps, ranks, s); break;
      case 2: rc = launch_gemv_any<__half>(x, wp, ws, y, out_dtype, m, n, k, cgw, warps, ranks, s); break;
      default: break;
    }
  } else if (layout == 2) {
    if (m > GEMV_MAX_M || warps < 1 || warps > GV_MAX_WARPS || ranks < 1 ||
        ranks > 8)
      return bad;
    switch (in_dtype) {
      case 1: rc = launch_mma<__nv_bfloat16>(x, wp, ws, y, out_dtype, m, n, k, warps, ranks, s); break;
      case 2: rc = launch_mma<__half>(x, wp, ws, y, out_dtype, m, n, k, warps, ranks, s); break;
      default: break;
    }
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
