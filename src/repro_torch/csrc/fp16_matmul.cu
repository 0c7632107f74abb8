// Dense GEMM y[M,N] = x[M,K] @ w[K,N] with f32 accumulation, for Hopper.
//
// Replaces the TPU kernel fp16_matmul_pallas (src/repro/kernels/
// fp16_matmul/fp16_matmul.py, _fp16_matmul_kernel), which upcasts fp16/
// bf16 tiles to f32 in VMEM right before the MXU dot (paper C1: inline
// FP16->FP32 conversion). x and w are f32, bf16 or f16 of one type, or f32
// x with a bf16 or f16 w, which is widened in registers as it is read:
// the xLSTM head multiplies its f32 activations with the bf16 lm_head as
// it is stored, as the TPU kernel widens both operands in the tile.
//
// Bound on this card: operations at the encoder's shapes (M = 1500
// frames, K and N of 384 and 1536: ~2*M*N*K FLOP over 2*(MK+KN+MN) bytes,
// above the H100's ~295 FLOP/byte bf16 ridge); bytes at decode shapes (M
// = the lanes, 1-4, or the speculative verify's rows, up to 16), where
// the weight plane is read once and each element feeds M multiply-adds.
// One source, three layouts; the wrapper picks one (kernels/fp16_matmul/
// ops.py, plan) and the C entry point checks that it applies:
//
//  * Tile (M > 16, bf16 or f16 x and w, rows 16-byte aligned): wgmma on
//    the tensor cores. One producer warp keeps a ring of ST stages of
//    64-deep x and w tiles in flight with TMA (cp.async.bulk.tensor,
//    128-byte swizzle, completion on a "full" mbarrier); one or two
//    consumer warpgroups run m64nNk16 wgmma on each stage as it lands
//    (f32 accumulators in registers, one wgmma group kept in flight) and
//    release it on an "empty" mbarrier. w is read N-major as it is stored
//    (the wgmma's transposed B). Ragged M, N and K are zero-filled by the
//    copies and masked in the store, which goes through shared memory
//    as 16-byte row chunks. 128x128 tiles of two consumer warpgroups
//    where they number at least one an SM (the encoder's MLP up: 144),
//    64x128 tiles of one where they number half the SMs (N = 384 at 1500
//    rows: 72), else 64x64 (the 32-row prefill), all in one launch
//    without a split of K.
//  * GEMV (M <= 16, any operand pair but f32 x f32): a lane reads 16
//    bytes of one w row (8 bf16 or f16 columns), neighbouring lanes
//    on neighbouring columns; the lanes of a warp sharing columns take
//    neighbouring rows.
//    x is staged once in shared memory as f32 and the sums are kept in
//    f32. Where the column tiles alone leave the SMs idle, K is split
//    across the CTAs of a thread block cluster (up to 8): each CTA adds
//    its warps' partial sums and writes each slice of them into the
//    shared memory of the rank that adds that slice (distributed shared
//    memory); after the cluster's barrier each rank adds its slice in
//    rank order. One launch, no workspace, no atomics: the sum's order
//    is fixed.
//  * Register-tiled FMA loop (f32 x and w at any M, M > 16 with f32 x,
//    or rows that are not 16-byte aligned): f32 FMAs on the CUDA cores,
//    64x64 output tiles, 4x4 accumulators a thread, element loads masked
//    at every edge. f32 x keeps true f32 arithmetic (no TF32): the
//    frontend GEMMs and the xLSTM head at prefill. Each output is one
//    fmaf chain over k in order, so a row's bits do not depend on M: the
//    streaming frontend's few-row products equal the one-shot ones.

#include "common.cuh"
#include "tensor_core.cuh"
#include <cooperative_groups.h>
#include <cuda.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GEMV_MAX_M = 16;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// element i of y in dtype code dt (0 = f32, 1 = bf16, 2 = f16)
__device__ __forceinline__ void store_from_f32(void* p, int dt, size_t i, float v) {
  if (dt == 0) static_cast<float*>(p)[i] = v;
  else if (dt == 1) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else static_cast<__half*>(p)[i] = __float2half(v);
}

// ---------------------------------------------------------------------------
// Tile layout: wgmma, TMA ring, bf16 or f16 operands
// ---------------------------------------------------------------------------

constexpr int BK = 64;   // K a stage: one 128-byte swizzle row of 16-bit values

// BM x BN outputs (BM / 64 consumer warpgroups), ST stages in flight
template <int BM_, int BN_, int ST_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, ST = ST_;
  static constexpr int WG = BM / 64;
  static constexpr int NT = WG * 128 + 32;   // + the producer warp
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the stages (1024-byte aligned: the swizzle atoms), then the barriers
  static constexpr int SMEM = 1024 + ST * STAGE + 2 * ST * 8;
};
// chosen by measurement at the encoder's and the prefill's shapes
// (python -m repro_torch.kernels.fp16_matmul.probe; PERF.md): 128x128
// where those tiles reach the SMs (MLP up), 64x128 where such tiles
// number half the SMs (MLP down, wo), else 64x64 (the 32-row prefill)
using TileWide = Tile<128, 128, 3>;   // 96 KB of stages: 2 an SM
using TileMid = Tile<64, 128, 4>;     // 96 KB: 2 an SM
using TileNarrow = Tile<64, 64, 4>;   // 64 KB: 3 an SM

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// two neighbouring outputs in one store; p aligned to the pair
template <typename TO>
__device__ __forceinline__ void store_pair(TO* p, float v0, float v1) {
  if constexpr (std::is_same<TO, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack2<TO>(v0, v1);
  }
}

template <typename T, typename TO, class C>
__global__ void __launch_bounds__(C::NT)
mm_tile_kernel(const __grid_constant__ CUtensorMap tmx,
               const __grid_constant__ CUtensorMap tmw, TO* __restrict__ y,
               int M, int N, int K) {
  extern __shared__ uint8_t tile_raw[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(tile_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + C::ST * C::STAGE);
  uint64_t* const empty = full + C::ST;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.x * C::BN;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= C::WG * 128) {
    // the producer warp: one thread keeps the ring full
    if (tid == C::WG * 128) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % C::ST;
        if (kb >= C::ST) mbar_wait(&empty[s], ((kb / C::ST) - 1) & 1);
        mbar_expect_tx(&full[s], C::STAGE);
        uint8_t* const a = smem + s * C::STAGE;
        uint8_t* const b = a + C::A_BYTES;
        tma_load_2d(a, &tmx, kb * BK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < C::BN / 64; ++j)
          tma_load_2d(b + j * (BK * 128), &tmw, n0 + 64 * j, kb * BK, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 * wg .. of the tile
  const int wg = tid / 128;
  float acc[C::BN / 2];
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.f;
  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % C::ST;
    mbar_wait(&full[s], (kb / C::ST) & 1);
    const uint8_t* const a = smem + s * C::STAGE + wg * 64 * 128;
    const uint8_t* const b = smem + s * C::STAGE + C::A_BYTES;
    wgmma_fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64k16<T, C::BN>(acc, wgmma_desc(a + 32 * kk, 16),
                             wgmma_desc(b + 2048 * kk, BK * 128));
    wgmma_commit();
    wgmma_fence_operands(acc);
    // the previous stage's MMAs are done: hand its buffers back
    wgmma_wait<1>();
    if (kb > 0 && tid % 128 == 0) mbar_arrive(&empty[(kb - 1) % C::ST]);
  }
  wgmma_wait<0>();
  wgmma_fence_operands(acc);

  // the tile through shared memory (the stages, free once every consumer
  // warpgroup is done with them), then out in 16-byte row chunks
  constexpr int NC = C::WG * 128;
  constexpr int VO = 16 / sizeof(TO);       // outputs a chunk
  constexpr int LD = C::BN + VO;            // padded row, in outputs
  static_assert(C::BM * LD * sizeof(TO) <= C::ST * C::STAGE, "epilogue");
  asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory");
  TO* const out = reinterpret_cast<TO*>(smem);
  const int t = tid % 128;
  const int row = wg * 64 + (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j) {
    const int col = 8 * j + 2 * (t % 4);
    store_pair<TO>(out + row * LD + col, acc[4 * j], acc[4 * j + 1]);
    store_pair<TO>(out + (row + 8) * LD + col, acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory");
  constexpr int CPR = C::BN / VO;           // chunks a row
  for (int c = tid; c < C::BM * CPR; c += NC) {
    const int r = c / CPR, gm = m0 + r;
    const int gn = n0 + (c % CPR) * VO;
    if (gm < M && gn < N)
      *reinterpret_cast<uint4*>(y + (size_t)gm * N + gn) =
          *reinterpret_cast<const uint4*>(out + r * LD + (c % CPR) * VO);
  }
}

// cuTensorMapEncodeTiled of the driver, reached through the runtime so
// the library links no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                            : nullptr;
  }();
  return fn;
}

// a row-major (rows, cols) 16-bit matrix read in boxes of 64 columns by
// box_rows rows, 128-byte swizzled; false if the driver refuses it
bool tensor_map(CUtensorMap* map, const void* base, int dt, int rows,
                int cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map,
            dt == 2 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, typename TO, class C>
int launch_tile(const void* x, const void* w, void* y, int m, int n, int k,
                int dt, cudaStream_t s) {
  CUtensorMap tmx, tmw;
  if (!tensor_map(&tmx, x, dt, m, k, C::BM) || !tensor_map(&tmw, w, dt, k, n, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      mm_tile_kernel<T, TO, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  (void)attr;   // a refusal shows as the launch's error
  dim3 grid((n + C::BN - 1) / C::BN, (m + C::BM - 1) / C::BM);
  mm_tile_kernel<T, TO, C><<<grid, C::NT, C::SMEM, s>>>(
      tmx, tmw, static_cast<TO*>(y), m, n, k);
  return 0;
}

// ---------------------------------------------------------------------------
// GEMV layout: M <= 16, K split across the CTAs of a cluster
// ---------------------------------------------------------------------------

constexpr int GNW = 4;                    // warps a CTA
constexpr int GNT = GNW * 32;
constexpr int GEMV_SMEM = 200 * 1024;     // shared memory a CTA may take

template <typename TW, bool VEC>
__device__ __forceinline__ uint4 load_w(const TW* p, int valid) {
  if (VEC) return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(p))
                            : make_uint4(0, 0, 0, 0);
  uint4 v = make_uint4(0, 0, 0, 0);
  TW* e = reinterpret_cast<TW*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(TW); ++i)
    if (i < valid) e[i] = p[i];
  return v;
}

// the values of a 16-byte word of w as f32
template <typename TW>
__device__ __forceinline__ void widen_word(uint4 v, float* out) {
  constexpr int V = 16 / sizeof(TW);
  const TW* e = reinterpret_cast<const TW*>(&v);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = widen(e[i]);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// x rows [k0, k0 + nk) of the M <= MT rows as f32 in xs[k][MT]: reads
// along K (coalesced), 32 of them in flight a thread
template <typename TX, int MT>
__device__ __forceinline__ void stage_x(const TX* __restrict__ x, float* xs,
                                        int M, int K, int k0, int nk) {
  constexpr int U = MT >= 32 ? 1 : 32 / MT;   // rows of K a batch
  for (int kb = threadIdx.x; kb < nk; kb += U * GNT) {
    float v[MT][U];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kk = kb + u * GNT;
        v[m][u] = m < M && kk < nk ? widen(x[(size_t)m * K + k0 + kk]) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kk = kb + u * GNT;
      if (kk < nk) {
#pragma unroll
        for (int m = 0; m < MT; ++m) xs[kk * MT + m] = v[m][u];
      }
    }
  }
}

// CTA (rank r of a cluster of gridDim.x, column tile blockIdx.y): columns
// [blockIdx.y * tile, + tile) where tile = cgw * V, rows of K [r * kc,
// min(K, (r + 1) * kc)). Lane = (row slice ks, column group cgi): cgw
// column groups of V columns a warp, 32 / cgw rows at a time. The first
// GU rows of w a lane reads are in flight while x is staged, and each
// batch of GU rows while the one before it is multiplied.
template <typename TX, typename TW, int MT, bool VEC>
__global__ void __launch_bounds__(GNT)
mm_gemv_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               void* __restrict__ y, int y_dt, int M, int N, int K, int cgw,
               int kc) {
  constexpr int V = 16 / sizeof(TW);
  constexpr int GU = MT <= 4 ? 8 : 4;   // rows of w a lane has in flight
  extern __shared__ float4 gemv_raw[];
  float* const xs = reinterpret_cast<float*>(gemv_raw);   // [kc][MT]
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cgi = lane % cgw, ks = lane / cgw;
  const int kstep = 32 / cgw;                 // rows a warp takes at once
  const int tile = cgw * V;
  const int n = blockIdx.y * tile + cgi * V;
  const int valid = min(V, N - n);
  const int rank = blockIdx.x, ranks = gridDim.x;
  const int k0 = rank * kc;
  const int nk = max(0, min(K, k0 + kc) - k0);
  cg::cluster_group cluster = cg::this_cluster();
  // a rank writes into the others' shared memory only once they have
  // all started: arrive now, wait before the first such write
  if (ranks > 1) cluster_arrive_relaxed();

  // row k0 + r of this CTA: r = base + u * stride, base = it * GU *
  // stride + warp * kstep + ks
  const int stride = GNW * kstep;
  auto fetch = [&](uint4 (&raw)[GU], int base) {
#pragma unroll
    for (int u = 0; u < GU; ++u) {
      const int r = base + u * stride;
      raw[u] = r < nk ? load_w<TW, VEC>(w + (size_t)(k0 + r) * N + n, valid)
                      : make_uint4(0, 0, 0, 0);
    }
  };
  uint4 cur[GU], nxt[GU];
  int base = warp * kstep + ks;
  fetch(cur, base);
  stage_x<TX, MT>(x, xs, M, K, k0, nk);
  __syncthreads();

  float acc[MT][V];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = 0.f;
  for (; base < nk; base += GU * stride) {
    fetch(nxt, base + GU * stride);
#pragma unroll
    for (int u = 0; u < GU; ++u) {
      const int r = base + u * stride;
      if (r >= nk) break;
      float wv[V];
      widen_word<TW>(cur[u], wv);
      float xv[MT];
      if constexpr (MT % 4 == 0) {
#pragma unroll
        for (int i = 0; i < MT; i += 4) {
          const float4 x4 = *reinterpret_cast<const float4*>(xs + r * MT + i);
          xv[i] = x4.x;
          xv[i + 1] = x4.y;
          xv[i + 2] = x4.z;
          xv[i + 3] = x4.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i) xv[i] = xs[r * MT + i];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
#pragma unroll
    for (int u = 0; u < GU; ++u) cur[u] = nxt[u];
  }

  // the row slices of a warp (lanes with one column group), in a fixed
  // order; both partners of a shuffle form the same sum
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < V; ++j)
      for (int off = cgw; off < 32; off <<= 1)
        acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);

  // the warps in order into this CTA's partial; then each rank sends the
  // slice of it that rank q adds to rank q, and after the cluster's
  // barrier adds the slices it received in rank order
  const int outs = MT * tile;
  const int per = (outs + ranks - 1) / ranks;   // outputs a rank adds
  float* const red = xs;                        // [GNW][MT][tile]
  float* const recv = xs + max(kc * MT, GNW * outs);   // [ranks][per]
  __syncthreads();   // xs is reused
  if (ks == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(red + (warp * MT + i) * tile + cgi * V + j) =
            make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  }
  __syncthreads();
  if (ranks > 1) cluster_wait();   // every rank has started
  for (int e = tid; e < outs; e += GNT) {
    float t = 0.f;
    for (int wi = 0; wi < GNW; ++wi) t += red[wi * outs + e];
    float* dst = recv + rank * per + e % per;
    if (ranks > 1) dst = cluster.map_shared_rank(dst, e / per);
    *dst = t;
  }
  if (ranks > 1) cluster.sync();
  else __syncthreads();
  const int e0 = rank * per, e1 = min(outs, e0 + per);
  for (int e = e0 + tid; e < e1; e += GNT) {
    const int i = e / tile, c = e % tile;
    const int gn = blockIdx.y * tile + c;
    if (i >= M || gn >= N) continue;
    float t = 0.f;
    for (int q = 0; q < ranks; ++q) t += recv[q * per + e - e0];
    store_from_f32(y, y_dt, (size_t)i * N + gn, t);
  }
}

template <typename TX, typename TW, int MT, bool VEC>
int launch_gemv(const void* x, const void* w, void* y, int y_dt, int m,
                int n, int k, int cgw, int ranks, cudaStream_t s) {
  constexpr int V = 16 / sizeof(TW);
  const int tile = cgw * V;
  const int kc = (k + ranks - 1) / ranks;
  const int per = (MT * tile + ranks - 1) / ranks;
  const size_t smem = sizeof(float) *
      ((size_t)max(kc * MT, GNW * MT * tile) + ranks * per);
  if (smem > (size_t)GEMV_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      mm_gemv_kernel<TX, TW, MT, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, GEMV_SMEM);
  (void)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (n + tile - 1) / tile);
  cfg.blockDim = dim3(GNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = ranks;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, mm_gemv_kernel<TX, TW, MT, VEC>, static_cast<const TX*>(x),
      static_cast<const TW*>(w), y, y_dt, m, n, k, cgw, kc));
}

template <typename TX, typename TW, bool VEC>
int launch_gemv_m(const void* x, const void* w, void* y, int y_dt, int m,
                  int n, int k, int cgw, int ranks, cudaStream_t s) {
  if (m <= 1) return launch_gemv<TX, TW, 1, VEC>(x, w, y, y_dt, m, n, k, cgw, ranks, s);
  if (m <= 2) return launch_gemv<TX, TW, 2, VEC>(x, w, y, y_dt, m, n, k, cgw, ranks, s);
  if (m <= 4) return launch_gemv<TX, TW, 4, VEC>(x, w, y, y_dt, m, n, k, cgw, ranks, s);
  if (m <= 8) return launch_gemv<TX, TW, 8, VEC>(x, w, y, y_dt, m, n, k, cgw, ranks, s);
  return launch_gemv<TX, TW, 16, VEC>(x, w, y, y_dt, m, n, k, cgw, ranks, s);
}

template <typename TX, typename TW>
int launch_gemv_any(const void* x, const void* w, void* y, int y_dt, int m,
                    int n, int k, int cgw, int ranks, cudaStream_t s) {
  const bool vec = aligned16(w) && (n * (int)sizeof(TW)) % 16 == 0;
  return vec ? launch_gemv_m<TX, TW, true>(x, w, y, y_dt, m, n, k, cgw, ranks, s)
             : launch_gemv_m<TX, TW, false>(x, w, y, y_dt, m, n, k, cgw, ranks, s);
}

// ---------------------------------------------------------------------------
// Register-tiled FMA loop: f32 x above 16 rows, or unaligned rows
// ---------------------------------------------------------------------------

constexpr int FBM = 64;
constexpr int FBN = 64;
constexpr int FBK = 16;
constexpr int FTM = 4;
constexpr int FTN = 4;
constexpr int FNT = (FBM / FTM) * (FBN / FTN);  // 256 threads

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(FNT)
mm_fma_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              TO* __restrict__ y, int M, int N, int K) {
  __shared__ float As[FBK][FBM + 4];  // A tile, transposed: As[k][m]
  __shared__ float Bs[FBK][FBN + 4];  // B tile: Bs[k][n]
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
      As[c][r] = (gm < M && gk < K) ? widen(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < FBK * FBN; e += FNT) {
      const int r = e / FBN, c = e % FBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? widen(w[(size_t)gk * N + gn]) : 0.f;
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

template <typename TX, typename TW, typename TO>
int launch_fma(const void* x, const void* w, void* y, int m, int n, int k,
               cudaStream_t s) {
  dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
  mm_fma_kernel<TX, TW, TO><<<grid, FNT, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(y),
      m, n, k);
  return 0;
}

template <typename TX, typename TW>
int launch_fma_out(int y_dt, const void* x, const void* w, void* y, int m,
                   int n, int k, cudaStream_t s) {
  switch (y_dt) {
    case 0: return launch_fma<TX, TW, float>(x, w, y, m, n, k, s);
    case 1: return launch_fma<TX, TW, __nv_bfloat16>(x, w, y, m, n, k, s);
    case 2: return launch_fma<TX, TW, __half>(x, w, y, m, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename TO>
int launch_tile_t(int tile, const void* x, const void* w, void* y, int m,
                  int n, int k, int dt, cudaStream_t s) {
  switch (tile) {
    case 0: return launch_tile<T, TO, TileWide>(x, w, y, m, n, k, dt, s);
    case 1: return launch_tile<T, TO, TileMid>(x, w, y, m, n, k, dt, s);
    case 2: return launch_tile<T, TO, TileNarrow>(x, w, y, m, n, k, dt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_tile_out(int tile, int y_dt, const void* x, const void* w, void* y,
                    int m, int n, int k, int dt, cudaStream_t s) {
  switch (y_dt) {
    case 0: return launch_tile_t<T, float>(tile, x, w, y, m, n, k, dt, s);
    case 1: return launch_tile_t<T, __nv_bfloat16>(tile, x, w, y, m, n, k, dt, s);
    case 2: return launch_tile_t<T, __half>(tile, x, w, y, m, n, k, dt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x: (M, K) in x_dtype; w: (K, N) in w_dtype; y: (M, N) in y_dtype;
// dtype codes 0 = f32, 1 = bf16, 2 = f16; w_dtype == x_dtype, or x f32
// with a bf16 or f16 w. layout (the wrapper's plan): 0 = the FMA loop;
// 1 = the wgmma tile, p0 = 0, 1, 2 for 128x128, 64x128, 64x64 (bf16 or
// f16 x and w, M > 16, K and N multiples of 8 and at least 64, x, w and
// y 16-byte aligned); 2 = the GEMV (M <= 16, w bf16 or f16), p0 = column
// groups of 16 bytes a warp (1, 2, 4, ..., 32), p1 = CTAs a cluster
// splitting K (1-8).
extern "C" int fp16_matmul(const void* x, const void* w, void* y, int m,
                           int n, int k, int x_dtype, int w_dtype,
                           int y_dtype, int layout, int p0, int p1,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype < 0 || x_dtype > 2 || w_dtype < 0 || w_dtype > 2 ||
      y_dtype < 0 || y_dtype > 2 || (w_dtype != x_dtype && x_dtype != 0) ||
      m < 1 || n < 1 || k < 1)
    return bad;
  int rc = bad;
  if (layout == 1) {
    const bool ok = x_dtype == w_dtype && x_dtype != 0 && m > GEMV_MAX_M &&
                    k % 8 == 0 && n % 8 == 0 && k >= 64 && n >= 64 &&
                    aligned16(x) && aligned16(w) && aligned16(y) &&
                    p0 >= 0 && p0 <= 2;
    if (!ok) return bad;
    rc = x_dtype == 1
             ? launch_tile_out<__nv_bfloat16>(p0, y_dtype, x, w, y, m, n, k, 1, s)
             : launch_tile_out<__half>(p0, y_dtype, x, w, y, m, n, k, 2, s);
  } else if (layout == 2) {
    if (m > GEMV_MAX_M || p0 < 1 || p0 > 32 || (p0 & (p0 - 1)) || p1 < 1 ||
        p1 > 8)
      return bad;
    switch (x_dtype * 3 + w_dtype) {
      case 1: rc = launch_gemv_any<float, __nv_bfloat16>(x, w, y, y_dtype, m, n, k, p0, p1, s); break;
      case 2: rc = launch_gemv_any<float, __half>(x, w, y, y_dtype, m, n, k, p0, p1, s); break;
      case 4: rc = launch_gemv_any<__nv_bfloat16, __nv_bfloat16>(x, w, y, y_dtype, m, n, k, p0, p1, s); break;
      case 8: rc = launch_gemv_any<__half, __half>(x, w, y, y_dtype, m, n, k, p0, p1, s); break;
    }
  } else if (layout == 0) {
    switch (x_dtype * 3 + w_dtype) {
      case 0: rc = launch_fma_out<float, float>(y_dtype, x, w, y, m, n, k, s); break;
      case 1: rc = launch_fma_out<float, __nv_bfloat16>(y_dtype, x, w, y, m, n, k, s); break;
      case 2: rc = launch_fma_out<float, __half>(y_dtype, x, w, y, m, n, k, s); break;
      case 4: rc = launch_fma_out<__nv_bfloat16, __nv_bfloat16>(y_dtype, x, w, y, m, n, k, s); break;
      case 8: rc = launch_fma_out<__half, __half>(y_dtype, x, w, y, m, n, k, s); break;
    }
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
