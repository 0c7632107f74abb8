// Dense GEMM y[M,N] = x[M,K] @ w[K,N] with f32 accumulation, for Hopper.
//
// Replaces the TPU kernel fp16_matmul_pallas (src/repro/kernels/
// fp16_matmul/fp16_matmul.py, _fp16_matmul_kernel), which upcasts fp16/
// bf16 tiles to f32 in VMEM right before the MXU dot (paper C1: inline
// FP16->FP32 conversion). Here each tile is converted to f32 as it is
// staged into shared memory and the products run as f32 FMAs on the CUDA
// cores. f32 inputs therefore get true f32 arithmetic (no TF32).
//
// Bound on this card: at the encoder shapes (M=1500 frames, K=384/1536,
// N=384/1536) the work is operations (~2*M*N*K FLOP over 2*(MK+KN+MN)
// bytes, ~200-600 FLOP/byte, above the H100's ~295 FLOP/byte bf16
// ridge); at decode shapes (M = a few lanes) it is bytes (the weight
// plane is read once). Design against the operations bound: 64x64 output
// tiles, each of the 256 threads keeps a 4x4 block of accumulators in
// registers, so every f32 read from shared memory feeds 4 FMAs. Ragged
// M, N and K are masked in the tile loads (zero fill) and the store, so
// the host never pads and no residual tail runs outside the kernel. The
// tensor cores (mma/wgmma) are left for a later, faster version.

#include "common.cuh"
#include <stddef.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads

template <typename TI, typename TO>
__global__ void __launch_bounds__(NT)
fp16_matmul_kernel(const TI* __restrict__ x, const TI* __restrict__ w,
                   TO* __restrict__ y, int M, int N, int K) {
  __shared__ float As[BK][BM + 4];  // A tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN + 4];  // B tile: Bs[k][n]
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
      Bs[r][c] = (gk < K && gn < N) ? to_f32(w[(size_t)gk * N + gn]) : 0.f;
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
void launch(const void* x, const void* w, void* y, int m, int n, int k,
            cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  fp16_matmul_kernel<TI, TO><<<grid, NT, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const TI*>(w),
      static_cast<TO*>(y), m, n, k);
}

template <typename TI>
bool launch_out(int out_dtype, const void* x, const void* w, void* y,
                int m, int n, int k, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: launch<TI, float>(x, w, y, m, n, k, stream); return true;
    case 1: launch<TI, __nv_bfloat16>(x, w, y, m, n, k, stream); return true;
    case 2: launch<TI, __half>(x, w, y, m, n, k, stream); return true;
    default: return false;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16.
extern "C" int fp16_matmul(const void* x, const void* w, void* y, int m,
                           int n, int k, int in_dtype, int out_dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (in_dtype) {
    case 0: ok = launch_out<float>(out_dtype, x, w, y, m, n, k, s); break;
    case 1: ok = launch_out<__nv_bfloat16>(out_dtype, x, w, y, m, n, k, s); break;
    case 2: ok = launch_out<__half>(out_dtype, x, w, y, m, n, k, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
