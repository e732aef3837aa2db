// Tiled f32-accumulate matrix product C = A @ B (sm_90a).
//
// Replaces: src/repro/kernels/matmul.py, matmul (body _matmul_kernel): a
// blocked (M,K)@(K,N) product with an f32 accumulator kept across K,
// ragged edges padded, and the result cast to out_dtype.
//
// What bounds it on an H100: on the main path (the streaming cascade-space
// evaluator) the products are (128, 512) @ (512, 1805), three per chunk,
// and (128, 512) @ (512, 361), one per chunk, f32 on 0/1 indicator
// matrices (so every f32 sum is an exact integer count, in any order). The
// larger is 0.24 GFLOP against ~4.9 MB of operands: ~3.5 us of f32 FFMA at
// 67 TFLOP/s vs ~1.5 us of memory at 3.35 TB/s, so operations bound; the
// smaller is 5x less of both. At such sizes what costs is an idle SM and
// latency: one 64x64 tile per block of the first version covered 58 of
// 132 SMs at N = 1805 and 12 at N = 361, each block waited on its loads
// between two barriers, and N = 1805 rows of B are not 16-byte aligned.
//
// Design:
// - The tile is chosen per shape by kernels/bindings.matmul_plan (Python)
//   and passed in: 64x64, 32x64 or 32x32 outputs per block, the largest
//   that can reach one block per SM; K is cut into the fewest `split`
//   contiguous chunks of `k_chunk` (a multiple of BK) that reach 132
//   blocks (3 at N = 1805: 174 blocks; 6 at N = 361 with 32x64: 144).
//   Block z writes its partial sums to slice z of an f32 workspace, and a
//   second kernel adds the slices in the fixed order z = 0, 1, ... and
//   casts. No atomics, so the result is the same from run to run.
// - Inside a block, two groups of threads split each BK-deep step between
//   them (2 warps per scheduler instead of 1), and add their partial tiles
//   through shared memory in group order at the end.
// - Loads are pipelined: a ring of STAGES shared-memory buffers filled by
//   cp.async, one barrier per K step, so steps t+1 and t+2 are in flight
//   while step t is computed. f32 operands take 16-byte copies: A's rows at
//   K % 4 == 0, and every B row from the 16-byte boundary at or before its
//   start, the row's offset (0..3 floats) added when it is read back
//   (4-byte copies, one instruction per float, held the loads back).
//   Each thread's chunk addresses are computed once and advance by a
//   stride per step. Partial chunks on the ragged edge zero-fill. bf16
//   operands are widened to f32 through registers.
// - Each thread keeps a TM x TN register block (8x4 at 64x64, else 4x4):
//   A (m, k) read as float4 runs along k, a quarter warp sharing its rows
//   (a broadcast); B read one float per column, consecutive threads on
//   consecutive columns (conflict-free whatever the row offset).
// - Full f32 FFMA: the general contract is f32-exact, so no TF32.
//
// Later work: on a large square product (chip_smoke.py's probe) the inner
// loop stays well below cuBLAS's SIMT SGEMM rate, and that, not the grid,
// is what keeps it behind torch.matmul at the evaluator's shapes. Beyond that, the
// evaluator's operands are exact 0/1 indicators, so a bf16 or int8
// tensor-core path (mma.sync, then wgmma) would stay exact at up to 30x the
// FFMA rate; the bf16-input variants would take the same path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BK 32
#define STAGES 3

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, of which `bytes` (0..16) are read and the rest
// zero-filled; src must be a valid, 16-byte aligned address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct MMParams {
  const void* a;
  const void* b;
  void* c;       // (M, N) out when split == 1
  float* ws;     // (split, M, N) partial sums when split > 1
  int M, N, K, k_chunk;
  int vec_a;     // A's rows are 16-byte aligned: 16-byte copies
  int vec_b;     // B is 16-byte aligned: 16-byte copies from each row's
                 // aligned start, the row's offset (0..3) kept aside
};

// A BM x BN output tile per block of KG groups of threads; each thread a
// TM x TN register block: rows ty*TM.., columns tx + TX*j. Group g takes
// k-steps g*GK.. of every BK-deep stage; the groups' partial tiles are
// added in group order at the end. A is kept (m, k) and read as float4
// runs along k (a quarter warp shares its rows: a broadcast); B (k, n) is
// read one float per column, consecutive threads on consecutive columns:
// conflict-free, and the stores coalesce the same way.
template <int BM, int BN, int TM, int TN, int KG>
struct Tile {
  static constexpr int TX = BN / TN, TG = (BM / TM) * TX;
  static constexpr int THREADS = KG * TG, GK = BK / KG;
  static constexpr int AS = BK + 4;   // A row stride in smem, 16 B aligned
  static constexpr int BS = BN + 4;   // B row stride: room for the offset
  static constexpr int BC = BN / 4 + 1;   // 16-byte chunks per B row
  static constexpr int STAGE = BM * AS + BK * BS;   // floats
  static constexpr int SMEM = STAGES * STAGE * 4;   // bytes
  static_assert(TX >= 8 && THREADS <= 256 && GK % 4 == 0, "tile");
  static_assert(KG * BM * BN <= STAGES * STAGE, "reduction scratch");
};

template <int BM, int BN, int TM, int TN, int KG, bool VEC, typename TIn,
          typename TOut>
__global__ void __launch_bounds__(Tile<BM, BN, TM, TN, KG>::THREADS)
matmul_kernel(const MMParams p) {
  typedef Tile<BM, BN, TM, TN, KG> L;
  constexpr int THREADS = L::THREADS;
  extern __shared__ __align__(16) float smem[];
  auto As = [&](int st) { return smem + st * L::STAGE; };
  auto Bs = [&](int st) { return As(st) + BM * L::AS; };
  const int tid = threadIdx.x, g = KG == 1 ? 0 : tid / L::TG;
  const int tx = tid % L::TG % L::TX, ty = tid % L::TG / L::TX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int M = p.M, N = p.N, K = p.K;
  const int kbeg = blockIdx.z * p.k_chunk;
  const int kend = min(K, kbeg + p.k_chunk);
  const int nsteps = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;
  const TIn* A = static_cast<const TIn*>(p.a);
  const TIn* B = static_cast<const TIn*>(p.b);
  // offset of B's row k0 + kk + q within its first 16-byte chunk (0
  // unless vec_b): k0 and kk are multiples of 4, so it depends on q only
  int shift[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) shift[q] = VEC ? (q * N + col0) & 3 : 0;

  // The fast path (f32, both operands 16-byte aligned): each thread owns
  // fixed 16-byte chunks of every stage, NA of A's and NB of B's; their
  // addresses at step 0 are computed once and advance by BK columns of A
  // and BK rows of B per step. Chunks past an edge copy 0 bytes (zeros).
  constexpr int CA = BM * (BK / 4), NA = (CA + THREADS - 1) / THREADS;
  constexpr int CB = BK * L::BC, NB = (CB + THREADS - 1) / THREADS;
  const float* a_src[VEC ? NA : 1];
  long long b_at[VEC ? NB : 1];
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = tid + i * THREADS, r = e / (BK / 4);
      const bool ok = e < CA && row0 + r < M;
      a_src[i] = reinterpret_cast<const float*>(A) +
                 (ok ? (long long)(row0 + r) * K + kbeg + e % (BK / 4) * 4
                     : 0);
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int e = tid + i * THREADS, kk = e / L::BC;
      b_at[i] = (((long long)(kbeg + kk) * N + col0) & ~3LL) +
                4 * (e % L::BC);
    }
  }
  const long long b_total = (long long)K * N, b_step = (long long)BK * N;

  // stage `st` <- K step `t` of this block's chunk; zeros past the edges
  auto load = [&](int st, int t) {
    const int k0 = kbeg + t * BK;
    float* as = As(st);
    float* bs = Bs(st);
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int e = tid + i * THREADS, r = e / (BK / 4);
        const int c = e % (BK / 4) * 4;
        const int n = (e < CA && row0 + r < M) ? max(0, min(4, kend - k0 - c))
                                               : 0;
        if (e < CA)
          cp_async16(as + r * L::AS + c,
                     n ? a_src[i] + t * BK : reinterpret_cast<const float*>(A),
                     n * 4);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int e = tid + i * THREADS, kk = e / L::BC;
        const long long at = b_at[i] + t * b_step;
        const int n = (e < CB && k0 + kk < kend)
                          ? (int)max(0LL, min(4LL, b_total - at)) : 0;
        if (e < CB)
          cp_async16(bs + kk * L::BS + 4 * (e % L::BC),
                     reinterpret_cast<const float*>(B) + (n ? at : 0), n * 4);
      }
    } else if constexpr (sizeof(TIn) == 4) {   // 4-byte copies
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int gm = row0 + r, gk = k0 + c;
        const bool in = gm < M && gk < kend;
        cp_async4(as + r * L::AS + c, in ? A + (long long)gm * K + gk : A,
                  in);
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gn = col0 + c;
        const bool in = gk < kend && gn < N;
        cp_async4(bs + kk * L::BS + c, in ? B + (long long)gk * N + gn : B,
                  in);
      }
    } else {   // bf16: widened to f32 through registers
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int gm = row0 + r, gk = k0 + c;
        as[r * L::AS + c] = (gm < M && gk < kend)
                                ? to_f32(A[(long long)gm * K + gk]) : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gn = col0 + c;
        bs[kk * L::BS + c] = (gk < kend && gn < N)
                                 ? to_f32(B[(long long)gk * N + gn]) : 0.f;
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  int st_use = 0, st_load = STAGES - 1;   // ring slots of steps t, t+S-1
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<STAGES - 2>();   // step t has landed (this thread's part)
    __syncthreads();               // ... everyone's; step t-1 is consumed
    if (t + STAGES - 1 < nsteps) load(st_load, t + STAGES - 1);
    st_load = st_load == STAGES - 1 ? 0 : st_load + 1;
    cp_async_commit();             // possibly empty: keeps the group count
    const int st = st_use;
    st_use = st_use == STAGES - 1 ? 0 : st_use + 1;
    const float* as = As(st) + ty * TM * L::AS + g * L::GK;
    const float* bs = Bs(st) + tx + g * L::GK * L::BS;
#pragma unroll
    for (int kk = 0; kk < L::GK; kk += 4) {
      float4 a4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(as + i * L::AS + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* brow = bs + (kk + q) * L::BS + shift[q];
        float b[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = brow[L::TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q == 0 ? a4[i].x : q == 1 ? a4[i].y
                         : q == 2 ? a4[i].z : a4[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
  }

  // the groups' partial tiles -> smem, added in group order
  cp_async_wait<0>();
  __syncthreads();
  float* red = smem + g * BM * BN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      red[(ty * TM + i) * BN + tx + L::TX * j] = acc[i][j];
  __syncthreads();
  TOut* C = static_cast<TOut*>(p.c);
  float* W = p.ws + (long long)blockIdx.z * M * N;
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int gm = row0 + e / BN, gn = col0 + e % BN;
    if (gm >= M || gn >= N) continue;
    float v = smem[e];
#pragma unroll
    for (int k = 1; k < KG; ++k) v += smem[k * BM * BN + e];
    if (gridDim.z == 1)
      store(C + (long long)gm * N + gn, v);
    else
      W[(long long)gm * N + gn] = v;
  }
}

// out[i] = ws[0][i] + ws[1][i] + ... in that order, cast to TOut
template <typename TOut>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ ws, TOut* __restrict__ out,
                     long long n, int split) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = ws[i];
  for (int z = 1; z < split; ++z) s += ws[(long long)z * n + i];
  store(out + i, s);
}

template <int BM, int BN, int TM, int TN, int KG, bool VEC, typename TIn,
          typename TOut>
static cudaError_t launch_kernel(const MMParams& p, dim3 grid,
                                 cudaStream_t st) {
  typedef Tile<BM, BN, TM, TN, KG> L;
  if (L::SMEM > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        matmul_kernel<BM, BN, TM, TN, KG, VEC, TIn, TOut>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
  }
  matmul_kernel<BM, BN, TM, TN, KG, VEC, TIn, TOut>
      <<<grid, L::THREADS, L::SMEM, st>>>(p);
  return cudaGetLastError();
}

template <int BM, int BN, int TM, int TN, int KG, typename TIn, typename TOut>
static int launch(const MMParams& p, int split, cudaStream_t st) {
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, split);
  cudaError_t err;
  if constexpr (sizeof(TIn) == 4) {
    err = p.vec_a && p.vec_b
              ? launch_kernel<BM, BN, TM, TN, KG, true, TIn, TOut>(p, grid, st)
              : launch_kernel<BM, BN, TM, TN, KG, false, TIn, TOut>(p, grid,
                                                                   st);
  } else {
    err = launch_kernel<BM, BN, TM, TN, KG, false, TIn, TOut>(p, grid, st);
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long n = (long long)p.M * p.N;
  splitk_reduce_kernel<TOut><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      p.ws, static_cast<TOut*>(p.c), n, split);
  return (int)cudaGetLastError();
}

// the (bm, bn) tiles bindings.matmul_plan may choose, with their register
// blocks and K groups (two K groups: 256 threads, 128 at 32x32)
template <typename TIn, typename TOut>
static int by_tile(const MMParams& p, int bm, int bn, int split,
                   cudaStream_t st) {
  if (bm == 64 && bn == 64)
    return launch<64, 64, 8, 4, 2, TIn, TOut>(p, split, st);
  if (bm == 32 && bn == 64)
    return launch<32, 64, 4, 4, 2, TIn, TOut>(p, split, st);
  if (bm == 32 && bn == 32)
    return launch<32, 32, 4, 4, 2, TIn, TOut>(p, split, st);
  return (int)cudaErrorInvalidValue;
}

// a (M,K), b (K,N), c (M,N), all row-major and contiguous; in_bf16 /
// out_bf16 select bf16 instead of f32 storage. (bm, bn) is the output tile
// per block; K is cut into `split` chunks of k_chunk (a multiple of BK,
// split * k_chunk >= K), reduced through ws ((split, M, N) f32; unused and
// may be null when split == 1). Returns a CUDA error code (0 = ok).
extern "C" int repro_matmul(const void* a, const void* b, void* c, void* ws,
                            int M, int N, int K, int in_bf16, int out_bf16,
                            int bm, int bn, int split, int k_chunk,
                            void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || split < 1 || k_chunk < 0 ||
      k_chunk % BK || (long long)split * k_chunk < K || split > 65535 ||
      (split > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  auto al16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  MMParams p{a, b, c, static_cast<float*>(ws), M, N, K, k_chunk,
             !in_bf16 && K % 4 == 0 && al16(a), !in_bf16 && al16(b)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16)
    return by_tile<__nv_bfloat16, __nv_bfloat16>(p, bm, bn, split, st);
  if (in_bf16) return by_tile<__nv_bfloat16, float>(p, bm, bn, split, st);
  if (out_bf16) return by_tile<float, __nv_bfloat16>(p, bm, bn, split, st);
  return by_tile<float, float>(p, bm, bn, split, st);
}
