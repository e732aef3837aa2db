// Tiled f32-accumulate matrix product C = A @ B (sm_90a).
//
// Replaces: src/repro/kernels/matmul.py, matmul (body _matmul_kernel): a
// blocked (M,K)@(K,N) product with an f32 accumulator kept across K,
// ragged edges padded, and the result cast to out_dtype.
//
// What bounds it on an H100: on the main path (the streaming cascade-space
// evaluator, (128, I) @ (I, A) with I = 512 eval frames and A = 1805
// configured models) one call is 0.24 GFLOP against ~4.9 MB of operands:
// ~3.5 us of f32 FFMA at 67 TFLOP/s vs ~1.5 us of memory at 3.35 TB/s, so
// operations bound. The inputs there are 0/1 indicator matrices, so the
// f32 sums are exact integer counts.
//
// Design: a classic shared-memory SGEMM. A block owns a 64x64 output tile
// and walks K in steps of 16; A and B tiles are staged in shared memory
// (converted to f32 at load, bf16 or f32 in), and each of the 256 threads
// keeps a 4x4 register block of f32 accumulators. Rows and columns handled
// by one thread are 16 apart, so shared-memory reads are conflict-free and
// the final stores are coalesced. Ragged edges are masked (zeros loaded,
// stores skipped). Full f32 FFMA: the general contract is f32-exact, so no
// TF32; a bf16/fp8/int8 tensor-core path for the 0/1 inputs is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define BM 64
#define BN 64
#define BK 16
#define THREADS 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
              TOut* __restrict__ Cm, int M, int N, int K) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, kk = e % BK;
      const int gm = row0 + m, gk = k0 + kk;
      As[kk][m] = (gm < M && gk < K) ? to_f32(A[(long long)gm * K + gk]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, n = e % BN;
      const int gk = k0 + kk, gn = col0 + n;
      Bs[kk][n] = (gk < K && gn < N) ? to_f32(B[(long long)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = row0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = col0 + tx + 16 * j;
      if (gn < N) store(Cm + (long long)gm * N + gn, acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut>
static void launch(const void* a, const void* b, void* c, int M, int N, int K,
                   cudaStream_t st) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<TIn, TOut><<<grid, THREADS, 0, st>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), M, N, K);
}

// a (M,K), b (K,N), c (M,N), all row-major and contiguous. in_bf16 /
// out_bf16 select bf16 instead of f32 storage. Returns cudaGetLastError().
extern "C" int repro_matmul(const void* a, const void* b, void* c, int M,
                            int N, int K, int in_bf16, int out_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, st);
  else if (in_bf16)
    launch<__nv_bfloat16, float>(a, b, c, M, N, K, st);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(a, b, c, M, N, K, st);
  else
    launch<float, float>(a, b, c, M, N, K, st);
  return (int)cudaGetLastError();
}
