// Mamba-2 SSD chunk scan with the state carried on chip (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan (body _ssd_kernel): per
// (batch, head) stream and per chunk,
//   y     = (C B^T ⊙ exp(segsum(dt a))) (x dt)  +  exp(cumsum(dt a)) ⊙ C state^T
//   state = state exp(sum(dt a)) + (x dt ⊙ exp(decay to chunk end))^T B,
// with the (P, N) state entering each chunk. Unlike the Pallas kernel it
// also writes the final state (B, H, P, N), which prefill hands to the
// decode cache (models/ssm.ssd_chunked returns it too).
//
// What bounds it on an H100: at the serving path's shape (x (8, 512, 64,
// 64) bf16, N 64) the least work is the state update and the output
// contraction, 4 B S H P N = 4.3 GFLOP of f32 FFMA (~64 us at 67 TFLOP/s),
// against ~110 MB of bytes (x, y in f32, B, C, dt, the final state: ~33 us
// at 3.35 TB/s), so operations bound.
//
// Design: the TPU's sequential chunk grid axis becomes a loop inside one
// block per (batch, head) stream (8 * 64 = 512 blocks at the path's shape),
// and the (P, N) f32 state stays in shared memory across the loop. A
// 256-token f32 chunk tile (256 x 256 decay/score matrix, 256 KB) does not
// fit the 227 KB a block may hold, so the kernel runs on its own 64-token
// chunk (the result does not depend on the chunk length; only f32 rounding
// moves). Per chunk: x dt, B and C are staged in shared memory as f32 (B
// and C are read by batch index; the heads share them, nothing is copied);
// one thread forms the running cumsum of dt a (64 adds); then three
// register-blocked products (each thread owns a 4 x 4 output block of a
// 64 x 64 tile, rows and columns 16 apart): G = C B^T masked to the lower
// triangle BEFORE exp (the upper triangle's positive exponents overflow),
// y = G (x dt) + exp(cum) ⊙ C state^T written straight to y, and the state
// update. Row strides are padded by one float so that the column reads of
// B, C, G and the state hit distinct banks. All arithmetic is f32; x, B, C
// arrive as bf16 or f32, dt and a as f32, y is f32. Ragged tails (S not a
// multiple of 64) are zero-filled. Tensor cores (the three products are
// small GEMMs) and overlapping the next chunk's loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CHUNK 64
#define THREADS 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// out(r, c, sum_k a1(r, k) b1(k, c) + sum_k a2(r, k) b2(k, c)) for r < R,
// c < C. The 256 threads form a 16 x 16 grid; each owns a 4 x 4 block of
// every 64 x 64 output tile (rows ty + 16 i, columns tx + 16 j).
template <typename FA1, typename FB1, typename FA2, typename FB2,
          typename FO>
__device__ __forceinline__ void block_mm2(int R, int C, int K1, FA1 a1,
                                          FB1 b1, int K2, FA2 a2, FB2 b2,
                                          FO out) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int r0 = 0; r0 < R; r0 += 64) {
    for (int c0 = 0; c0 < C; c0 += 64) {
      int rr[4], cc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * i;
        rr[i] = r < R ? r : 0;  // clamped: reads stay inside the tiles
        cc[i] = c < C ? c : 0;
      }
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < K1; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a1(rr[i], k);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b1(k, cc[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      for (int k = 0; k < K2; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a2(rr[i], k);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b2(k, cc[j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          if (r < R && c < C) out(r, c, acc[i][j]);
        }
      }
    }
  }
}

// Shared-memory floats the kernel needs for head width P and state N.
static long long smem_floats(int P, int N) {
  const long long np = N + 1;
  return 3LL * CHUNK + (long long)CHUNK * P + 2LL * CHUNK * np +
         (long long)CHUNK * (CHUNK + 1) + (long long)P * np;
}

// One block per (batch, head) stream. x (B, S, H, P); dt (B, S, H); a (H,);
// bm, cm (B, S, N); y (B, S, H, P) f32; fin (B, H, P, N) f32.
template <typename TX>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const TX* __restrict__ bm,
                const TX* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ fin, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int NP = N + 1, GP = CHUNK + 1;
  float* cum = smem;              // CHUNK: running sum of dt a
  float* ecum = cum + CHUNK;      // CHUNK: exp(cum)
  float* wend = ecum + CHUNK;     // CHUNK: exp(cum_last - cum)
  float* xdt = wend + CHUNK;      // CHUNK x P
  float* bs = xdt + CHUNK * P;    // CHUNK x NP
  float* cs = bs + CHUNK * NP;    // CHUNK x NP
  float* g = cs + CHUNK * NP;     // CHUNK x GP
  float* st = g + CHUNK * GP;     // P x NP: the state, kept across chunks

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const float ah = a[h];
  for (int e = tid; e < P * N; e += THREADS) st[(e / N) * NP + e % N] = 0.f;

  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    const int tc = min(CHUNK, S - t0);
    for (int e = tid; e < CHUNK * P; e += THREADS) {
      const int t = e / P, p = e % P;
      float v = 0.f;
      if (t < tc) {
        const long long row = (long long)b * S + t0 + t;
        v = to_f32(x[(row * H + h) * P + p]) * dt[row * H + h];
      }
      xdt[e] = v;
    }
    for (int e = tid; e < CHUNK * N; e += THREADS) {
      const int t = e / N, n = e % N;
      float vb = 0.f, vc = 0.f;
      if (t < tc) {
        const long long off = ((long long)b * S + t0 + t) * N + n;
        vb = to_f32(bm[off]);
        vc = to_f32(cm[off]);
      }
      bs[t * NP + n] = vb;
      cs[t * NP + n] = vc;
    }
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < CHUNK; ++t) {
        if (t < tc) run += dt[((long long)b * S + t0 + t) * H + h] * ah;
        cum[t] = run;
      }
    }
    __syncthreads();
    const float last = cum[CHUNK - 1];
    for (int t = tid; t < CHUNK; t += THREADS) {
      ecum[t] = expf(cum[t]);
      wend[t] = expf(last - cum[t]);
    }
    // G = (C B^T) ⊙ exp(cum_i - cum_j), lower triangle only
    block_mm2(
        CHUNK, CHUNK, N, [&](int i, int n) { return cs[i * NP + n]; },
        [&](int n, int j) { return bs[j * NP + n]; }, 0,
        [&](int, int) { return 0.f; }, [&](int, int) { return 0.f; },
        [&](int i, int j, float v) {
          g[i * GP + j] = (j <= i) ? v * expf(cum[i] - cum[j]) : 0.f;
        });
    __syncthreads();
    // y = G (x dt) + exp(cum_i) C_i . state_p  (the state entering the chunk)
    block_mm2(
        tc, P, CHUNK, [&](int i, int j) { return g[i * GP + j]; },
        [&](int j, int p) { return xdt[j * P + p]; }, N,
        [&](int i, int n) { return cs[i * NP + n] * ecum[i]; },
        [&](int n, int p) { return st[p * NP + n]; },
        [&](int i, int p, float v) {
          y[(((long long)b * S + t0 + i) * H + h) * P + p] = v;
        });
    __syncthreads();
    // state = state exp(cum_last) + sum_t (x dt)_t exp(cum_last - cum_t) B_t
    const float dec = expf(last);
    block_mm2(
        P, N, CHUNK, [&](int p, int t) { return xdt[t * P + p] * wend[t]; },
        [&](int t, int n) { return bs[t * NP + n]; }, 0,
        [&](int, int) { return 0.f; }, [&](int, int) { return 0.f; },
        [&](int p, int n, float v) {
          st[p * NP + n] = st[p * NP + n] * dec + v;
        });
    __syncthreads();
  }
  for (int e = tid; e < P * N; e += THREADS)
    fin[((long long)bh * P + e / N) * N + e % N] = st[(e / N) * NP + e % N];
}

template <typename TX>
static int launch(const void* x, const void* dt, const void* a,
                  const void* bm, const void* cm, void* y, void* fin, int B,
                  int S, int H, int P, int N, cudaStream_t st) {
  // above the 227 KB a block may use (P x N past 128 x 128) this fails
  const long long bytes = smem_floats(P, N) * (long long)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<TX><<<B * H, THREADS, bytes, st>>>(static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(a), static_cast<const TX*>(bm), static_cast<const TX*>(cm), static_cast<float*>(y), static_cast<float*>(fin), S, H, P, N);
  return (int)cudaGetLastError();
}

// All tensors contiguous. x, bm, cm are bf16 when x_bf16 != 0, else f32;
// dt and a are f32; y and fin are f32. Returns a CUDA error code (0 = ok).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* fin, int B, int S, int H, int P, int N,
                              int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, fin, B, S, H, P, N,
                                 st);
  return launch<float>(x, dt, a, bm, cm, y, fin, B, S, H, P, N, st);
}
