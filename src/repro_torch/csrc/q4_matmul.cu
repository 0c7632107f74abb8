// Q4_0 GEMM y[M,N] = x[M,K] @ dequant(wp[K/2,N], ws[K/32,N]) with f32
// accumulation, for Hopper.
//
// Replaces the TPU kernel q4_matmul_pallas (src/repro/kernels/q4_matmul/
// q4_matmul.py, _q4_matmul_kernel): the weight is stored as two 4-bit
// codes a byte along K (low nibble = even k, +8 bias) with one f16 scale
// per 32 rows, and is unpacked and scaled next to the dot (paper C1), so
// device memory streams 0.5625 bytes per weight.
//
// Bound on this card: bytes. The port runs it only for the speculative
// draft's decode GEMMs, where M is the number of serving lanes (1-4):
// each packed byte feeds 2 * M FMAs, far below the ~300 operations per
// byte at which the H100 stops being bound by its memory. Design: a
// GEMV-shaped layout instead of a 64x64 output tile, which would waste
// 94-98 % of its FMAs at M <= 4. A block owns BN = 32 output columns and
// all rows of an M tile of MT = 4; its 8 warps split K (warp w takes the
// 32-row scale blocks w, w + 8, ...), each lane of a warp one column, so
// a warp reads 32 neighbouring bytes of a packed row. The activation
// chunk is staged once per block in shared memory as f32; the nibbles
// are unpacked, biased and multiplied in registers, and the scale is
// applied once per 32-row block to the partial sums. The dequantized
// weight exists only in registers, never in device memory. The 8
// warps' partial sums are reduced in shared memory. K must be a multiple
// of 32; ragged M and N are masked in the loads and the store.

#include "common.cuh"
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int QBLOCK = 32;
constexpr int BN = 32;        // output columns of a block (one per lane)
constexpr int KG = 8;         // warps splitting K
constexpr int MT = 4;         // rows of x a block computes together
constexpr int KC = 512;       // K chunk of x staged in shared memory
constexpr int NT = BN * KG;   // 256 threads

template <typename TI, typename TO>
__global__ void __launch_bounds__(NT)
q4_matmul_kernel(const TI* __restrict__ x, const uint8_t* __restrict__ wp,
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
void launch(const void* x, const void* wp, const void* ws, void* y, int m,
            int n, int k, cudaStream_t stream) {
  dim3 grid((n + BN - 1) / BN, (m + MT - 1) / MT);
  q4_matmul_kernel<TI, TO><<<grid, NT, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<const uint8_t*>(wp),
      static_cast<const __half*>(ws), static_cast<TO*>(y), m, n, k);
}

template <typename TI>
bool launch_out(int out_dtype, const void* x, const void* wp, const void* ws,
                void* y, int m, int n, int k, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: launch<TI, float>(x, wp, ws, y, m, n, k, stream); return true;
    case 1: launch<TI, __nv_bfloat16>(x, wp, ws, y, m, n, k, stream); return true;
    case 2: launch<TI, __half>(x, wp, ws, y, m, n, k, stream); return true;
    default: return false;
  }
}

}  // namespace

// x: (M, K) in in_dtype; wp: (K/2, N) uint8, row r holding k = 2r (low
// nibble) and 2r + 1 (high nibble), codes + 8; ws: (K/32, N) float16;
// y: (M, N) in out_dtype. dtype codes: 0 = f32, 1 = bf16, 2 = f16.
// K % 32 == 0.
extern "C" int q4_matmul(const void* x, const void* wp, const void* ws,
                         void* y, int m, int n, int k, int in_dtype,
                         int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k % QBLOCK) return static_cast<int>(cudaErrorInvalidValue);
  bool ok = false;
  switch (in_dtype) {
    case 0: ok = launch_out<float>(out_dtype, x, wp, ws, y, m, n, k, s); break;
    case 1: ok = launch_out<__nv_bfloat16>(out_dtype, x, wp, ws, y, m, n, k, s); break;
    case 2: ok = launch_out<__half>(out_dtype, x, wp, ws, y, m, n, k, s); break;
    default: break;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
