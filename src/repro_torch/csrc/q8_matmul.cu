// Q8_0 GEMM y[M,N] = x[M,K] @ (wq[K,N] * ws[K/32,N]) with f32
// accumulation, for Hopper.
//
// Replaces the TPU kernel q8_matmul_pallas (src/repro/kernels/q8_matmul/
// q8_matmul.py, _q8_matmul_kernel), which dequantizes each int8 tile with
// its per-32-row f16 scales in VMEM right before the MXU dot (paper C1),
// so device memory streams ~1.06 bytes per weight instead of 2.
//
// Bound on this card: at decode shapes (M = the serving lanes) the work
// is bytes: the int8 code plane and the f16 scale plane are read once
// and each weight feeds only M FMAs. At encoder shapes (M=1500) it is
// operations. Design: the weight tile is dequantized while it is staged
// from device memory into shared memory (code * scale in f32), so the
// dequantized plane exists only in shared memory and is never written
// to device memory; the product itself is the fp16_matmul kernel's
// register-tiled f32 FMA loop (64x64 tiles, 4x4 accumulators a thread).
// Ragged M, N and K are masked in the loads and the store.

#include "common.cuh"
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 32;
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads

template <typename TI, typename TO>
__global__ void __launch_bounds__(NT)
q8_matmul_kernel(const TI* __restrict__ x, const int8_t* __restrict__ wq,
                 const __half* __restrict__ ws, TO* __restrict__ y, int M,
                 int N, int K) {
  __shared__ float As[BK][BM + 4];  // activation tile, transposed
  __shared__ float Bs[BK][BN + 4];  // dequantized weight tile
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int r = e / BN, c = e % BN;
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
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) y[(size_t)gm * N + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename TI, typename TO>
void launch(const void* x, const void* wq, const void* ws, void* y, int m,
            int n, int k, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  q8_matmul_kernel<TI, TO><<<grid, NT, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const int8_t*>(wq),
      static_cast<const __half*>(ws), static_cast<TO*>(y), m, n, k);
}

template <typename TI>
bool launch_out(int out_dtype, const void* x, const void* wq, const void* ws,
                void* y, int m, int n, int k, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: launch<TI, float>(x, wq, ws, y, m, n, k, stream); return true;
    case 1: launch<TI, __nv_bfloat16>(x, wq, ws, y, m, n, k, stream); return true;
    case 2: launch<TI, __half>(x, wq, ws, y, m, n, k, stream); return true;
    default: return false;
  }
}

}  // namespace

// x: (M, K) in in_dtype; wq: (K, N) int8; ws: (K/32, N) float16;
// y: (M, N) in out_dtype. dtype codes: 0 = f32, 1 = bf16, 2 = f16.
extern "C" int q8_matmul(const void* x, const void* wq, const void* ws,
                         void* y, int m, int n, int k, int in_dtype,
                         int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (in_dtype) {
    case 0: ok = launch_out<float>(out_dtype, x, wq, ws, y, m, n, k, s); break;
    case 1: ok = launch_out<__nv_bfloat16>(out_dtype, x, wq, ws, y, m, n, k, s); break;
    case 2: ok = launch_out<__half>(out_dtype, x, wq, ws, y, m, n, k, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
