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
// What bounds it on an H100: bytes. At the serving path's shape (x (8, 512,
// 64, 64) bf16, N 64) the kernel must move ~111 MB (x, B, C, dt in, y in
// f32 and the final state out): ~33 us at 3.35 TB/s. Its least work is
// 4 B S H P N = 4.3 GFLOP (the state update and the output contraction);
// issued with every f32 factor split in two (see below), plus C B^T and
// the diagonal terms, about 2.5 times that: ~11 us at the bf16
// tensor-core peak.
//
// bf16 design (ssd_tc_kernel, the serving path's; P <= 64, N <= 128, both
// multiples of 8):
// - One block per (batch, group of HB heads); the wrapper picks HB
//   (bindings.ssd_heads_per_block: 4 at zamba2's shape, 128 blocks on 132
//   SMs). The heads share B and C (n_groups = 1), so C B^T is formed once
//   per (batch, chunk) for the group; only the decay mask and dt differ per
//   head. Each head has 4 warps; warp w owns token rows 16w.. of y and
//   state rows p = 16w.. of the (P, N) state.
// - The TPU's sequential chunk axis is a loop over 64-token chunks inside
//   the block (the result does not depend on the chunk length beyond f32
//   rounding). x, B, C (bf16) and dt (f32) of chunk c+1 are copied into
//   the other half of a double buffer with cp.async while chunk c is
//   computed. Rows are padded by 16 bytes so every ldmatrix is
//   conflict-free.
// - The running sum of dt a over a chunk is one warp's shuffle scan.
// - All products run on mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//   x, B and C enter as they are (exact bf16). The f32 factors are split
//   into a bf16 high part and a bf16 low part, v = hi + lo to ~2^-17
//   relative, and each enters as two products:
//     C B^T                                  B, C as they are;
//     y_diag = (G ⊙ dt_j) x, G = C B^T ⊙ exp(cum_i - cum_j), j <= i
//                                            G dt split, x as it is;
//     y_off  = exp(cum_i) ⊙ (C state^T)      state split, C as it is;
//     state  = state exp(cum_last) + (x ⊙ dt exp(cum_last - cum))^T B
//                                            x dt wend split, B as it is.
//   The upper triangle of G is selected to 0 before its exponent is used
//   (its positive exponents overflow). Sums are f32 throughout.
// - The state stays in f32 registers (the update's accumulators) across
//   the chunk loop; its hi/lo split goes to shared memory once per chunk
//   for the next chunk's y_off. y is written once, f32, from registers.
//
// f32 design (ssd_ffma_kernel; the reference tests' f32 inputs, and any
// shape the bf16 kernel does not take): one block of 256 threads per
// (batch, head) stream, x dt, B and C staged in shared memory as f32, the
// same 64-token chunks and warp scan, and three register-blocked f32 FFMA
// products (each thread owns a 4 x 4 output block of a 64 x 64 tile).
// f32 means f32 here: the tolerance rules out TF32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CHUNK 64
#define LOG2E 1.4426950408889634f

// Inclusive running sum over a 64-token chunk held two tokens a lane
// (tokens 2 lane and 2 lane + 1): five shuffle steps over the pair sums.
__device__ __forceinline__ void chunk_cumsum(float& v0, float& v1) {
  const int lane = threadIdx.x % 32;
  float s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += u;
  }
  float before = __shfl_up_sync(0xffffffffu, s, 1);
  if (lane == 0) before = 0.f;
  v0 += before;
  v1 = s;
}

// ------------------------------------------------------------- bf16 path --
namespace tc {
typedef __nv_bfloat16 bf;
constexpr int PP = 64;             // head width the tiles are laid out for
constexpr int RSP = PP + 8;        // x row stride (elements): 16-byte pad
constexpr int RCB = CHUNK + 8;     // C B^T row stride (floats)
constexpr int CB_ITEMS = 10;       // 16 x 16 blocks of C B^T's lower half

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared; a copy outside the operand reads 0 bytes and
// zero-fills (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// both halves of hi + lo ⊗ b: the two products of a split factor
__device__ __forceinline__ void mma2(float (&c)[4], const unsigned (&hi)[4],
                                     const unsigned (&lo)[4], unsigned b0,
                                     unsigned b1) {
  mma(c, hi, b0, b1);
  mma(c, lo, b0, b1);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ unsigned as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}
// (v0, v1) -> bf16 pairs hi and lo with v = hi + lo (the first value in
// the low half)
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}
// a bf16 pair of x, times (s0, s1) in f32, split
__device__ __forceinline__ void scale_split(unsigned xpair, float s0,
                                            float s1, unsigned& hi,
                                            unsigned& lo) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xpair));
  split2(v.x * s0, v.y * s1, hi, lo);
}

// Shared memory of one block, in bytes, for NN and HB heads.
__host__ __device__ constexpr int smem_bytes(int nn, int hb) {
  return 2 * (2 * hb * CHUNK * RSP          // x, double-buffered
              + 2 * 2 * CHUNK * (nn + 8)    // B and C, double-buffered
              + 2 * hb * PP * (nn + 8))     // the state's hi and lo
         + 4 * (CHUNK * RCB                 // C B^T
                + 2 * hb * CHUNK            // dt, double-buffered
                + 3 * hb * CHUNK            // cum (base 2), exp(cum), dt wend
                + 4 * hb);                  // exp(cum_last)
}

template <int NN>
__global__ void __launch_bounds__(NN == 64 ? 512 : 256, 1)
ssd_tc_kernel(const bf* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const bf* __restrict__ bm,
              const bf* __restrict__ cm, float* __restrict__ y,
              float* __restrict__ fin, int S, int H, int P, int N) {
  constexpr int RSN = NN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int HB = blockDim.x / 128;
  bf* xs = reinterpret_cast<bf*>(smem);           // [2][HB][CHUNK][RSP]
  bf* bs = xs + 2 * HB * CHUNK * RSP;             // [2][CHUNK][RSN]
  bf* cs = bs + 2 * CHUNK * RSN;                  // [2][CHUNK][RSN]
  bf* sth = cs + 2 * CHUNK * RSN;                 // [HB][PP][RSN]
  bf* stl = sth + HB * PP * RSN;                  // [HB][PP][RSN]
  float* cb = reinterpret_cast<float*>(stl + HB * PP * RSN);  // [CHUNK][RCB]
  float* dts = cb + CHUNK * RCB;                  // [2][HB][CHUNK]
  float* cum2 = dts + 2 * HB * CHUNK;             // [HB][CHUNK]
  float* ecum = cum2 + HB * CHUNK;                // [HB][CHUNK]
  float* sw = ecum + HB * CHUNK;                  // [HB][CHUNK]
  float* dec = sw + HB * CHUNK;                   // [HB]

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, mat = lane / 8;
  const int hl = warp / 4, wi = warp % 4;         // head in group, warp in head
  const int groups = H / HB;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * HB;
  const int nc = (S + CHUNK - 1) / CHUNK;

  auto load = [&](int buf, int t0) {
    const int tc = min(CHUNK, S - t0);
    constexpr int XQ = PP / 8, NQ = NN / 8;      // 16-byte pieces a row
    for (int e = tid; e < HB * CHUNK * XQ; e += nthr) {
      const int q = e % XQ, r = (e / XQ) % CHUNK, hh = e / (XQ * CHUNK);
      const bool in = r < tc && q * 8 < P;
      const long long row = (long long)b * S + t0 + (in ? r : 0);
      cp_async16(xs + ((buf * HB + hh) * CHUNK + r) * RSP + q * 8,
                 x + (row * H + h0 + hh) * P + (in ? q * 8 : 0), in);
    }
    for (int e = tid; e < CHUNK * NQ; e += nthr) {
      const int q = e % NQ, r = e / NQ;
      const bool in = r < tc && q * 8 < N;
      const long long off =
          ((long long)b * S + t0 + (in ? r : 0)) * N + (in ? q * 8 : 0);
      cp_async16(bs + (buf * CHUNK + r) * RSN + q * 8, bm + off, in);
      cp_async16(cs + (buf * CHUNK + r) * RSN + q * 8, cm + off, in);
    }
    for (int e = tid; e < HB * CHUNK; e += nthr) {
      const int hh = e % HB, r = e / HB;
      const bool in = r < tc;
      cp_async4(dts + (buf * HB + hh) * CHUNK + r,
                dt + ((long long)b * S + t0 + (in ? r : 0)) * H + h0 + hh,
                in);
    }
  };

  float st[NN / 8][4];   // state rows p = 16 wi + lane/4 (+8), all n
#pragma unroll
  for (int n = 0; n < NN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
  const float ah = __ldg(a + h0 + hl);
  load(0, 0);
  cp_async_commit();

  for (int c = 0; c < nc; ++c) {
    const int buf = c & 1, t0 = c * CHUNK, tc = min(CHUNK, S - t0);
    cp_async_wait_all();
    __syncthreads();   // chunk c has landed; chunk c-1's buffers are free
    if (c + 1 < nc) {
      load(buf ^ 1, t0 + CHUNK);
      cp_async_commit();
    }
    const bf* bsb = bs + buf * CHUNK * RSN;
    const bf* csb = cs + buf * CHUNK * RSN;
    const bf* xsb = xs + (buf * HB + hl) * CHUNK * RSP;
    const float* dtb = dts + (buf * HB + hl) * CHUNK;

    // ---- C B^T, the blocks on and below the diagonal, once for the group
    for (int item = warp; item < CB_ITEMS; item += nthr / 32) {
      int mt = 0;
      while ((mt + 1) * (mt + 2) / 2 <= item) ++mt;
      const int np = item - mt * (mt + 1) / 2;   // 16 columns, np <= mt
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < NN / 16; ++ks) {
        unsigned af[4], bfr[4];
        ldsm_x4(af, csb + (mt * 16 + lane % 16) * RSN + ks * 16 +
                        (lane / 16) * 8);
        ldsm_x4(bfr, bsb + (np * 16 + (mat / 2) * 8 + lane % 8) * RSN +
                         ks * 16 + (mat % 2) * 8);
        mma(acc[0], af, bfr[0], bfr[1]);
        mma(acc[1], af, bfr[2], bfr[3]);
      }
      const int row = mt * 16 + lane / 4;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int col = np * 16 + q * 8 + (lane % 4) * 2;
        *reinterpret_cast<float2*>(cb + row * RCB + col) =
            make_float2(acc[q][0], acc[q][1]);
        *reinterpret_cast<float2*>(cb + (row + 8) * RCB + col) =
            make_float2(acc[q][2], acc[q][3]);
      }
    }
    // ---- one warp per head: the running sum of dt a over the chunk
    if (wi == 0) {
      const float d0 = dtb[2 * lane], d1 = dtb[2 * lane + 1];
      float c0 = d0 * ah, c1 = d1 * ah;
      chunk_cumsum(c0, c1);
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      float* hc = cum2 + hl * CHUNK;
      float* he = ecum + hl * CHUNK;
      float* hw = sw + hl * CHUNK;
      hc[2 * lane] = c0 * LOG2E;
      hc[2 * lane + 1] = c1 * LOG2E;
      he[2 * lane] = expf(c0);
      he[2 * lane + 1] = expf(c1);
      hw[2 * lane] = d0 * expf(last - c0);
      hw[2 * lane + 1] = d1 * expf(last - c1);
      if (lane == 0) dec[hl] = expf(last);
    }
    __syncthreads();

    // ---- y for token rows 16 wi.. of head hl
    const int r0 = wi * 16;
    const int i0 = r0 + lane / 4, i1 = i0 + 8;
    float acc[PP / 8][4];
#pragma unroll
    for (int n = 0; n < PP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if (c > 0) {   // y_off = exp(cum_i) C_i . state (entering the chunk)
      const bf* sh = sth + hl * PP * RSN;
      const bf* sl = stl + hl * PP * RSN;
#pragma unroll
      for (int ks = 0; ks < NN / 16; ++ks) {
        unsigned af[4];
        ldsm_x4(af, csb + (r0 + lane % 16) * RSN + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int pt = 0; pt < PP / 8; pt += 2) {
          unsigned bh[4], bl[4];
          const int off = (pt * 8 + (mat / 2) * 8 + lane % 8) * RSN +
                          ks * 16 + (mat % 2) * 8;
          ldsm_x4(bh, sh + off);
          ldsm_x4(bl, sl + off);
          mma(acc[pt], af, bh[0], bh[1]);
          mma(acc[pt + 1], af, bh[2], bh[3]);
          mma(acc[pt], af, bl[0], bl[1]);
          mma(acc[pt + 1], af, bl[2], bl[3]);
        }
      }
      const float e0 = ecum[hl * CHUNK + i0], e1 = ecum[hl * CHUNK + i1];
#pragma unroll
      for (int pt = 0; pt < PP / 8; ++pt) {
        acc[pt][0] *= e0;
        acc[pt][1] *= e0;
        acc[pt][2] *= e1;
        acc[pt][3] *= e1;
      }
    }
    {   // y_diag = (G ⊙ dt_j) x over the token blocks j <= the warp's rows
      const float* hc = cum2 + hl * CHUNK;
      const float ci[2] = {hc[i0], hc[i1]};
      for (int ks = 0; ks <= wi; ++ks) {
        unsigned gh[4], gl[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = ks * 16 + half * 8 + (lane % 4) * 2;
          const float cj0 = hc[j], cj1 = hc[j + 1];
          const float dj0 = dtb[j], dj1 = dtb[j + 1];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = rr ? i1 : i0;
            const float2 v =
                *reinterpret_cast<const float2*>(cb + i * RCB + j);
            const float g0 = j <= i ? v.x * ex2(ci[rr] - cj0) * dj0 : 0.f;
            const float g1 = j + 1 <= i ? v.y * ex2(ci[rr] - cj1) * dj1 : 0.f;
            split2(g0, g1, gh[half * 2 + rr], gl[half * 2 + rr]);
          }
        }
#pragma unroll
        for (int pt = 0; pt < PP / 8; pt += 2) {
          unsigned xf[4];
          ldsm_x4_t(xf, xsb + (ks * 16 + (mat % 2) * 8 + lane % 8) * RSP +
                            pt * 8 + (mat / 2) * 8);
          mma2(acc[pt], gh, gl, xf[0], xf[1]);
          mma2(acc[pt + 1], gh, gl, xf[2], xf[3]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = rr ? i1 : i0;
      if (i >= tc) continue;
      float* yrow = y + (((long long)b * S + t0 + i) * H + h0 + hl) * P;
#pragma unroll
      for (int pt = 0; pt < PP / 8; ++pt) {
        const int p = pt * 8 + (lane % 4) * 2;
        if (p < P)
          *reinterpret_cast<float2*>(yrow + p) =
              make_float2(acc[pt][2 * rr], acc[pt][2 * rr + 1]);
      }
    }

    // ---- state rows p = 16 wi..: state exp(cum_last) + (x dt wend)^T B
    {
      const float dc = dec[hl];
#pragma unroll
      for (int n = 0; n < NN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] *= dc;
      const float* hw = sw + hl * CHUNK;
#pragma unroll
      for (int ks = 0; ks < CHUNK / 16; ++ks) {
        unsigned xa[4], ahi[4], alo[4];   // x^T: rows p, columns t
        ldsm_x4_t(xa, xsb + (ks * 16 + (mat / 2) * 8 + lane % 8) * RSP + r0 +
                          (mat % 2) * 8);
        const int t = ks * 16 + (lane % 4) * 2;
        const float s0 = hw[t], s1 = hw[t + 1], s8 = hw[t + 8],
                    s9 = hw[t + 9];
        scale_split(xa[0], s0, s1, ahi[0], alo[0]);
        scale_split(xa[1], s0, s1, ahi[1], alo[1]);
        scale_split(xa[2], s8, s9, ahi[2], alo[2]);
        scale_split(xa[3], s8, s9, ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < NN / 8; n += 2) {
          unsigned bfr[4];
          ldsm_x4_t(bfr, bsb + (ks * 16 + (mat % 2) * 8 + lane % 8) * RSN +
                             n * 8 + (mat / 2) * 8);
          mma2(st[n], ahi, alo, bfr[0], bfr[1]);
          mma2(st[n + 1], ahi, alo, bfr[2], bfr[3]);
        }
      }
    }
    if (c + 1 < nc) {
      __syncthreads();   // every warp is done reading the entering state
      bf* sh = sth + hl * PP * RSN;
      bf* sl = stl + hl * PP * RSN;
      const int p = r0 + lane / 4;
#pragma unroll
      for (int n = 0; n < NN / 8; ++n) {
        const int col = n * 8 + (lane % 4) * 2;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          unsigned hi, lo;
          split2(st[n][2 * rr], st[n][2 * rr + 1], hi, lo);
          *reinterpret_cast<unsigned*>(sh + (p + 8 * rr) * RSN + col) = hi;
          *reinterpret_cast<unsigned*>(sl + (p + 8 * rr) * RSN + col) = lo;
        }
      }
    }
  }
  const int p = wi * 16 + lane / 4;
  float* fo = fin + (long long)(b * H + h0 + hl) * P * N;
#pragma unroll
  for (int n = 0; n < NN / 8; ++n) {
    const int col = n * 8 + (lane % 4) * 2;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      if (p + 8 * rr < P && col < N)
        *reinterpret_cast<float2*>(fo + (long long)(p + 8 * rr) * N + col) =
            make_float2(st[n][2 * rr], st[n][2 * rr + 1]);
  }
}

template <int NN>
static int launch(const void* x, const void* dt, const void* a,
                  const void* bm, const void* cm, void* y, void* fin, int B,
                  int S, int H, int P, int N, int hb, cudaStream_t st) {
  const int bytes = smem_bytes(NN, hb);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_kernel<NN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_tc_kernel<NN><<<B * (H / hb), 128 * hb, bytes, st>>>(
      static_cast<const bf*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf*>(bm),
      static_cast<const bf*>(cm), static_cast<float*>(y),
      static_cast<float*>(fin), S, H, P, N);
  return (int)cudaGetLastError();
}
}  // namespace tc

// -------------------------------------------------------------- f32 path --
namespace fp32 {
constexpr int THREADS = 256;

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
ssd_ffma_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
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
    if (tid < 32) {
      const int t = 2 * tid;
      const long long row = (long long)b * S + t0 + t;
      float c0 = t < tc ? dt[row * H + h] * ah : 0.f;
      float c1 = t + 1 < tc ? dt[(row + 1) * H + h] * ah : 0.f;
      chunk_cumsum(c0, c1);
      cum[t] = c0;
      cum[t + 1] = c1;
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
      ssd_ffma_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_ffma_kernel<TX><<<B * H, THREADS, bytes, st>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const TX*>(bm),
      static_cast<const TX*>(cm), static_cast<float*>(y),
      static_cast<float*>(fin), S, H, P, N);
  return (int)cudaGetLastError();
}
}  // namespace fp32

// All tensors contiguous. x, bm, cm are bf16 when x_bf16 != 0, else f32;
// dt and a are f32; y and fin are f32. heads_per_block > 0 takes the
// tensor-core kernel with that many heads a block (bf16 only; it must
// divide H, with P <= 64, N <= 128, both multiples of 8, and x, bm, cm
// 16-byte aligned: bindings.ssd_heads_per_block decides); 0 takes the f32
// FFMA kernel. Returns a CUDA error code (0 = ok).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, void* y,
                              void* fin, int B, int S, int H, int P, int N,
                              int x_bf16, int heads_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hb = heads_per_block;
  if (hb > 0) {
    const bool aligned = ((uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm) %
                             16 == 0;
    if (!x_bf16 || H % hb || P > tc::PP || P % 8 || N % 8 || N > 128 ||
        hb > (N <= 64 ? 4 : 2) || !aligned)
      return (int)cudaErrorInvalidValue;
    if (N <= 64)
      return tc::launch<64>(x, dt, a, bm, cm, y, fin, B, S, H, P, N, hb, st);
    return tc::launch<128>(x, dt, a, bm, cm, y, fin, B, S, H, P, N, hb, st);
  }
  if (x_bf16)
    return fp32::launch<__nv_bfloat16>(x, dt, a, bm, cm, y, fin, B, S, H, P,
                                       N, st);
  return fp32::launch<float>(x, dt, a, bm, cm, y, fin, B, S, H, P, N, st);
}
