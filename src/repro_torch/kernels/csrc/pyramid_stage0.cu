// Fused pyramid + stage-0 CNN for one chunk of raw frames (sm_90a).
//
// Replaces: src/repro/kernels/image_transform.py, fused_pyramid_stage0
// (body _pyramid_stage0_kernel, helpers _pool and _conv3x3_relu_pool).
//
// Computes, per image: the progressive box-filter pyramid of plan_pyramid
// (each level pooled from its source level, mean = sum / (f*f)), written
// straight to the level outputs; the 3xC color projection of the stage-0
// level; L x [conv3x3-SAME + bias, ReLU, maxpool2 (VALID, floor)]; NHWC
// flatten; dense + ReLU; output dot; sigmoid. Weights are f32, or int8 with
// one f32 scale per tensor, dequantized at use ((float)q * scale, the same
// f32 product the reference's dequantize_cnn forms).
//
// What bounds it on an H100: for 256 frames of 224 px the base read alone is
// 154 MB (~46 us at 3.35 TB/s). A cheap stage-0 (1 conv layer at 28 px) is
// bytes bound; a 56 px rgb 2x32 stage-0 is ~5.3 GFLOP of f32 FFMA (~79 us
// at 67 TFLOP/s) and narrowly operations bound; the deep 224 px 4-layer
// stage-0s (~100 GFLOP per chunk) are clearly operations bound.
//
// Design: four launches on the caller's stream, one wrapper call.
// 1. ps0_pool_kernel, the pyramid: one block of 512 threads an SM, each
//    taking images blockIdx.x, + gridDim.x, ... tile by tile. Tiles go
//    through a ring of RING shared-memory slots that the copy engine fills
//    (one bulk copy a tile row, completion on the slot's mbarrier, issued
//    by one thread as soon as the block is done with a slot), so RING - 1
//    tiles, the next image's too, are in flight while one is pooled. When
//    the levels form a chain 2, 4, 8 times smaller than the base (the query
//    path's {112, 56, 28} and {112, 28} at 224 px), a tile is a strip of 16
//    full rows and each lane reads 8 pixels of one row (16-byte loads; the
//    rows are padded so they do not conflict) and forms every level of its
//    8 x 8 block in registers, the rows meeting through shuffles: the 28 px
//    level comes from the 112 px values, with no barrier and no second
//    pass. Any other plan pools in shared memory, level by level, each from
//    its source level's part. Levels are written as they are formed.
// 2. ps0_cnn_kernel, one block of 512 threads an image, two to an SM: the
//    color projection of the stage-0 level (L2-resident: just written) into
//    a global scratch (two ping-pong buffers per image), then each conv
//    layer: a work item is one pooled pixel x 4 output channels, its 4x4
//    input patch loaded once per input channel and shared by the four
//    pooling windows, each tap's 4 weights in one 16-byte load, the
//    pre-pool outputs never leaving registers. When every layer's input and
//    weights fit PS0_CNN_STAGE floats, each layer reads them from shared
//    memory (a deep light CNN is bound by the latency of its loads). The
//    flat activations stay in the scratch.
// 3. ps0_dense_kernel: the dense layer for the whole chunk, (B x flat) @
//    (flat x dense_n), as a tiled product (64 x 64 outputs a block, 4 x 4 a
//    thread, the next k step's tiles loaded while this one's are used),
//    split along flat into k_chunk pieces (bindings.ps0_dense_plan) so that
//    the weights are read once per 64 images, not once per image. Partial
//    sums go to a workspace.
// 4. ps0_head_kernel: each image's partials added in chunk order (no
//    atomics: the same sums on every run), then bias, ReLU, the output dot
//    and the sigmoid.
// On an H100 the CNN ran no faster inside the pooling kernel (one block an
// SM, each image's CNN after its pooling) than in its own (PERF.md,
// Findings).
// Arithmetic is f32 FFMA, not TF32 tensor cores: parity with the reference
// is f32. Pooling sums use explicit round-to-nearest adds in the plain
// version's order, so levels on dyadic pixels equal it bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_STEPS 8
#define MAX_CONV 8
#define THREADS 512
#define RING 4          // tile slots: RING - 1 tiles in flight
#define DT 64           // dense tile: DT images x DT units a block
#define DBK 32          // dense k step (k_chunk is a multiple)
#define HEAD_T 64       // head: threads an image
#define HEAD_IMG 4      // head: images a block

struct PS0Params {
  const float* img;              // (B, H, H, 3)
  float* scores;                 // (B,)
  float* scratch;                // (B, 2, scratch_stride)
  float* part;                   // (dense_split, B, dense_n) partial sums
  float* step_out[MAX_STEPS];    // (B, res, res, 3) per pooling step
  const void* conv_w[MAX_CONV];  // (3, 3, cin, cout) HWIO, f32 or int8
  const float* conv_b[MAX_CONV]; // (cout,)
  const void* dense_w;           // (flat, dense_n)
  const float* dense_b;          // (dense_n,)
  const void* out_w;             // (dense_n, 1)
  const float* out_b;            // (1,)
  long long scratch_stride;      // floats per ping-pong buffer per image
  int B, H, n_steps, s0_step, s0_res, C, n_conv, dense_n;
  int tile_h, tile_w, vec4;      // base tile; 1: 16-byte loads are aligned
  int tile_row, tile_stride;     // floats per tile row / ring slot (x 4)
  int chain;                     // levels 2, 4, 8 x smaller: bits 0, 1, 2
                                 // (a chain in registers), or 0
  int smem_bytes;                // RING slots + every level's tile
  int grid;                      // blocks of ps0_pool_kernel
  int flat, flat_buf;            // dense inputs: length, scratch buffer
  int dense_vec4;                // 1: flat and dense_w rows 16-byte aligned
  int cnn_stage;                 // 0, or floats of shared memory in which
                                 // each conv layer's input and weights fit
  int dense_split, dense_k_chunk;
  int step_res[MAX_STEPS];
  int step_src[MAX_STEPS];       // -1 = the base image, else an earlier step
  int level_off[MAX_STEPS];      // float offset of its tile after the ring
  int conv_cout[MAX_CONV];
  float cw[9];                   // (3, C) color projection, row-major
  float conv_scale[MAX_CONV];
  float dense_scale, out_scale;
};

// Weight loads: f32 as stored, or int8 dequantized at use. ``four`` reads
// 4 consecutive output channels (16-byte / 4-byte aligned: the wrapper
// checks the base pointers, and the index is a multiple of 4).
template <typename W>
struct WLoad;

template <>
struct WLoad<float> {
  static __device__ __forceinline__ float one(const void* p, long long i,
                                              float) {
    return __ldg(static_cast<const float*>(p) + i);
  }
  static __device__ __forceinline__ float4 four(const void* p, long long i,
                                                float) {
    return __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + i));
  }
};

template <>
struct WLoad<int8_t> {
  static __device__ __forceinline__ float one(const void* p, long long i,
                                              float s) {
    return __fmul_rn((float)__ldg(static_cast<const signed char*>(p) + i), s);
  }
  static __device__ __forceinline__ float4 four(const void* p, long long i,
                                                float s) {
    const char4 q = __ldg(reinterpret_cast<const char4*>(
        static_cast<const signed char*>(p) + i));
    return make_float4(__fmul_rn((float)q.x, s), __fmul_rn((float)q.y, s),
                       __fmul_rn((float)q.z, s), __fmul_rn((float)q.w, s));
  }
};

// Weights already dequantized to f32 in shared memory (cnn_image's
// staging): plain loads.
struct Staged {};
template <>
struct WLoad<Staged> {
  static __device__ __forceinline__ float one(const void* p, long long i,
                                              float) {
    return static_cast<const float*>(p)[i];
  }
  static __device__ __forceinline__ float4 four(const void* p, long long i,
                                                float) {
    return *reinterpret_cast<const float4*>(static_cast<const float*>(p) +
                                            i);
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// the one arrival of a phase, which also expects ``bytes`` of copies
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the copy engine, counted on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One conv3x3-SAME + bias, ReLU, maxpool2 layer: (h, h, cin) -> (h/2, h/2,
// cout). A work item is one pooled pixel x CPT consecutive output channels.
// Its four pooling windows (2x2 conv outputs) read one 4x4 input patch per
// input channel: the 16 patch values are loaded once and each 3x3 tap's
// CPT weights once, feeding 4 x CPT accumulators that stay in registers.
// Zero padding (SAME) enters as 0 for patch cells outside the image.
template <typename W, int CPT>
__device__ __forceinline__ void conv_layer(const float* in, float* out,
                                           int h, int cin, int cout,
                                           const void* wl, float ws,
                                           const float* bias) {
  const int ho = h / 2;
  const int groups = cout / CPT;
  for (int idx = threadIdx.x; idx < ho * ho * groups; idx += THREADS) {
    const int co = (idx % groups) * CPT;
    const int pix = idx / groups;
    const int qx = pix % ho;
    const int qy = pix / ho;
    const int y0 = 2 * qy - 1, x0 = 2 * qx - 1;   // patch origin
    float acc[4][CPT];                           // [window dy*2+dx][channel]
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[w][c] = 0.f;
    for (int ci = 0; ci < cin; ++ci) {
      float patch[4][4];
#pragma unroll
      for (int py = 0; py < 4; ++py) {
        const int iy = y0 + py;
#pragma unroll
        for (int px = 0; px < 4; ++px) {
          const int ix = x0 + px;
          patch[py][px] = (iy >= 0 && iy < h && ix >= 0 && ix < h)
                              ? in[((long long)iy * h + ix) * cin + ci]
                              : 0.f;
        }
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const long long wi =
              ((long long)(ky * 3 + kx) * cin + ci) * cout + co;
          float wv[CPT];
          if constexpr (CPT == 4) {
            const float4 w = WLoad<W>::four(wl, wi, ws);
            wv[0] = w.x; wv[1] = w.y; wv[2] = w.z; wv[3] = w.w;
          } else {
            wv[0] = WLoad<W>::one(wl, wi, ws);
          }
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
#pragma unroll
              for (int c = 0; c < CPT; ++c)
                acc[dy * 2 + dx][c] = fmaf(patch[dy + ky][dx + kx], wv[c],
                                           acc[dy * 2 + dx][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float b = __ldg(bias + co + c);
      // max over the window of relu(v) = max(0, max v)
      const float m = fmaxf(fmaxf(acc[0][c] + b, acc[1][c] + b),
                            fmaxf(acc[2][c] + b, acc[3][c] + b));
      out[(long long)pix * cout + co + c] = fmaxf(m, 0.f);
    }
  }
}

// Level-F pixels [x, x + 8 / F) of level row y, from registers, in 16-,
// 8- or 4-byte stores as the address allows.
template <int F>
__device__ __forceinline__ void store_level(float* level, int res, int y,
                                            int x, const float (&v)[24]) {
  constexpr int N = 24 / F;
  float* o = level + ((long long)y * res + x) * 3;
  if (N % 4 == 0 && (uintptr_t)o % 16 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(o + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if (N % 2 == 0 && (uintptr_t)o % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      *reinterpret_cast<float2*>(o + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) o[k] = v[k];
  }
}

// One step of a pyramid chain in registers. Lane l holds 8 / FS pixels of
// level-FS row j = l / G (FS base rows a level row) when j % FS == 0; it
// forms 8 / FD pixels of level-FD row j / FD (FD = FS f) from f level-FS
// rows, the lanes FS G apart below it: each mean of an f x f window, its
// sum in the plain version's order (rows, then pixels) with
// round-to-nearest adds, times 1 / f^2 (a power of two: exact).
template <int FS, int FD, int G>
__device__ __forceinline__ void chain_step(const float (&src)[24],
                                           float (&dst)[24]) {
  constexpr int f = FD / FS, NS = 8 / FS * 3, ND = 8 / FD;
  float acc[ND * 3];
#pragma unroll
  for (int k = 0; k < ND * 3; ++k) acc[k] = 0.f;
#pragma unroll
  for (int fy = 0; fy < f; ++fy) {
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float v = fy ? __shfl_down_sync(0xffffffffu, src[k], fy * FS * G)
                         : src[k];
      const int px = k / 3, c = k % 3;   // source pixel of window px / f
      acc[(px / f) * 3 + c] = __fadd_rn(acc[(px / f) * 3 + c], v);
    }
  }
  constexpr float inv = 1.f / (f * f);
#pragma unroll
  for (int k = 0; k < ND * 3; ++k) dst[k] = __fmul_rn(acc[k], inv);
}

// The levels of the base tile at (y0, x0) of image b when they form a
// power-of-two chain (MASK: bit 0, 1, 2 for the levels 2, 4, 8 times smaller than the
// base, each pooled from the one before): in registers, no barrier. Lane l
// of a warp reads 8 pixels of base row l / G of a band of U rows (16-byte
// shared loads; the row stride is padded so they do not conflict) and the
// chain's rows meet through shuffles. Level-F outputs leave from the lanes
// that hold them, in 16-, 8- or 4-byte stores.
template <int MASK>
__device__ __forceinline__ void pool_chain(const PS0Params& p,
                                           const float* tile, long long b,
                                           int y0, int x0) {
  constexpr int U = MASK & 4 ? 8 : MASK & 2 ? 4 : 2;
  constexpr int G = 32 / U;                   // 8-pixel columns a warp
  const int lane = threadIdx.x % 32, j = lane / G, g = lane % G;
  const int cols = p.tile_w / 8, per_band = (cols + G - 1) / G;
  const int items = (p.tile_h / U) * per_band;
  const int H = p.H;
  for (int it = threadIdx.x / 32; it < items; it += THREADS / 32) {
    const int band = it / per_band, col = (it % per_band) * G + g;
    const bool on = col < cols;
    float lv0[24], lv1[24], lv2[24], lv3[24];
    const float* r = tile + (band * U + j) * p.tile_row + col * 24;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float4 q = on ? reinterpret_cast<const float4*>(r)[k]
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      lv0[4 * k] = q.x; lv0[4 * k + 1] = q.y;
      lv0[4 * k + 2] = q.z; lv0[4 * k + 3] = q.w;
    }
    // each level from the finest one so far; lanes j % F == 0 hold a row
    const int ybase = y0 + band * U + j, xbase = x0 + col * 8;
    const bool out = on && j % 2 == 0;   // refined per level below
    int step = 0;
    if (MASK & 1) {
      chain_step<1, 2, G>(lv0, lv1);
      if (out)
        store_level<2>(p.step_out[step] + b * (H / 2) * (H / 2) * 3, H / 2,
                       ybase / 2, xbase / 2, lv1);
      ++step;
    }
    if (MASK & 2) {
      if (MASK & 1) chain_step<2, 4, G>(lv1, lv2);
      else chain_step<1, 4, G>(lv0, lv2);
      if (out && j % 4 == 0)
        store_level<4>(p.step_out[step] + b * (H / 4) * (H / 4) * 3, H / 4,
                       ybase / 4, xbase / 4, lv2);
      ++step;
    }
    if (MASK & 4) {
      if (MASK & 2) chain_step<4, 8, G>(lv2, lv3);
      else if (MASK & 1) chain_step<2, 8, G>(lv1, lv3);
      else chain_step<1, 8, G>(lv0, lv3);
      if (out && j % 8 == 0)
        store_level<8>(p.step_out[step] + b * (H / 8) * (H / 8) * 3, H / 8,
                       ybase / 8, xbase / 8, lv3);
    }
  }
}

// Any other plan: one level's part of a tile at a time, dh x dw pixels,
// each the mean of an f x f window of its source part (row stride srs
// floats), kept in shared memory for the levels pooled from it and
// written to ``out`` (row stride ostride floats) as it is formed. Sums in
// the plain version's order with round-to-nearest adds.
__device__ __forceinline__ void pool_level(const float* S, int srs, float* D,
                                           int dh, int dw, int f,
                                           float* out, int ostride) {
  const float area = (float)(f * f);
  for (int q = threadIdx.x; q < dh * dw; q += THREADS) {
    const int py = q / dw, px = q - py * dw;
    const float* s = S + py * f * srs + px * f * 3;
    float v[3] = {0.f, 0.f, 0.f};
    for (int fy = 0; fy < f; ++fy)
      for (int fx = 0; fx < f; ++fx)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          v[c] = __fadd_rn(v[c], s[fy * srs + fx * 3 + c]);
    float* o = out + py * ostride + px * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float m = __fdiv_rn(v[c], area);
      D[q * 3 + c] = m;
      o[c] = m;
    }
  }
}

// Every level's part of the base tile at (y0, x0) of image b, in the
// order of the plan.
__device__ __forceinline__ void pool_tile(const PS0Params& p,
                                          const float* tile, float* lv,
                                          long long b, int y0, int x0) {
  const int H = p.H, TH = p.tile_h, TW = p.tile_w;
  switch (p.chain) {
    case 1: pool_chain<1>(p, tile, b, y0, x0); return;
    case 2: pool_chain<2>(p, tile, b, y0, x0); return;
    case 3: pool_chain<3>(p, tile, b, y0, x0); return;
    case 4: pool_chain<4>(p, tile, b, y0, x0); return;
    case 5: pool_chain<5>(p, tile, b, y0, x0); return;
    case 6: pool_chain<6>(p, tile, b, y0, x0); return;
    case 7: pool_chain<7>(p, tile, b, y0, x0); return;
  }
  for (int l = 0; l < p.n_steps; ++l) {
    const int src = p.step_src[l];
    const int sr = src < 0 ? H : p.step_res[src];
    const int res = p.step_res[l], f = sr / res, fac = H / res;
    const int srs = src < 0 ? p.tile_row : TW / (H / sr) * 3;
    const float* S = src < 0 ? tile : lv + p.level_off[src];
    float* out = p.step_out[l] + ((b * res + y0 / fac) * res + x0 / fac) * 3;
    pool_level(S, srs, lv + p.level_off[l], TH / fac, TW / fac, f, out,
               res * 3);
    __syncthreads();
  }
}

// The stage-0 CNN of image b: the color projection of its level into
// scratch 0, then each conv layer from one ping-pong buffer into the
// other; the flat activations end in buffer flat_buf (n_conv % 2). With
// STAGED (``stage``: cnn_stage floats of shared memory, sized by the
// wrapper when every layer fits) each layer first copies its input and its weights,
// dequantized, there: a conv work item then reads on chip, which matters
// for the latency of deep light CNNs (16 input channels x 25 loads a
// work item per layer). The sums are the same. Ends on a barrier.
template <typename W, bool STAGED>
__device__ __forceinline__ void cnn_image(const PS0Params& p, long long b,
                                          float* stage) {
  const int H = p.H, s0 = p.s0_res, C = p.C;
  const float* L = p.s0_step < 0
                       ? p.img + b * H * H * 3
                       : p.step_out[p.s0_step] + b * s0 * s0 * 3;
  float* buf0 = p.scratch + b * 2 * p.scratch_stride;
  float* buf1 = buf0 + p.scratch_stride;
  for (int idx = threadIdx.x; idx < s0 * s0 * C; idx += THREADS) {
    const int c = idx % C;
    const float* px = L + (long long)(idx / C) * 3;
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(px[0], p.cw[c]),
                                        __fmul_rn(px[1], p.cw[C + c])),
                              __fmul_rn(px[2], p.cw[2 * C + c]));
    buf0[idx] = v;
  }
  __syncthreads();
  const float* in = buf0;
  float* outb = buf1;
  int h = s0, cin = C;
  for (int l = 0; l < p.n_conv; ++l) {
    const int cout = p.conv_cout[l];
    if (STAGED) {
      const int n_in = (h * h * cin + 3) / 4 * 4, n_w = 9 * cin * cout;
      for (int i = threadIdx.x; i < h * h * cin; i += THREADS)
        stage[i] = in[i];
      for (int i = threadIdx.x; i < n_w; i += THREADS)
        stage[n_in + i] = WLoad<W>::one(p.conv_w[l], i, p.conv_scale[l]);
      __syncthreads();
      if (cout % 4 == 0)
        conv_layer<Staged, 4>(stage, outb, h, cin, cout, stage + n_in, 1.f,
                               p.conv_b[l]);
      else
        conv_layer<Staged, 1>(stage, outb, h, cin, cout, stage + n_in, 1.f,
                               p.conv_b[l]);
    } else if (cout % 4 == 0) {
      conv_layer<W, 4>(in, outb, h, cin, cout, p.conv_w[l], p.conv_scale[l],
                       p.conv_b[l]);
    } else {
      conv_layer<W, 1>(in, outb, h, cin, cout, p.conv_w[l], p.conv_scale[l],
                       p.conv_b[l]);
    }
    __syncthreads();
    const float* tmp = in;
    in = outb;
    outb = const_cast<float*>(tmp);
    h /= 2;
    cin = cout;
  }
}

// The pyramid: block k pools images k, k + grid, ..., tile by tile. With
// 16-byte aligned rows (vec4) the tiles stream through a ring of RING
// shared-memory slots: thread 0 has the copy engine fill a slot (one bulk
// copy a tile row, completion counted on the slot's mbarrier) as soon as
// the block is done with it, so RING - 1 tiles (the next image's too) are
// in flight while one is pooled. Otherwise each tile is loaded by the
// block's threads in turn.
__global__ void __launch_bounds__(THREADS, 1)
ps0_pool_kernel(const __grid_constant__ PS0Params p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) unsigned long long full[RING];
  float* lv = sm + RING * p.tile_stride;
  const int H = p.H, TH = p.tile_h, TW = p.tile_w;
  const int tiles_x = H / TW, per_image = (H / TH) * tiles_x;
  const int n_img = (p.B - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int total = n_img * per_image;   // tiles this block pools, in order
  const int tid = threadIdx.x;
  auto fill = [&](int slot, int k) {   // thread 0: this block's tile k
    if (k >= total) return;
    const long long img = blockIdx.x + (long long)(k / per_image) * gridDim.x;
    const int t = k % per_image;
    const float* src = p.img + (img * H + (t / tiles_x) * TH) * H * 3 +
                       (t % tiles_x) * TW * 3;
    float* dst = sm + slot * p.tile_stride;
    mbar_expect_tx(&full[slot], (unsigned)(TH * TW * 12));
    for (int r = 0; r < TH; ++r)
      bulk_copy(dst + r * p.tile_row, src + (long long)r * H * 3,
                (unsigned)(TW * 12), &full[slot]);
  };
  if (p.vec4) {
    if (tid == 0) {
      for (int k = 0; k < RING; ++k) mbar_init(&full[k]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int k = 0; k < RING; ++k) fill(k, k);
  }
  for (int k = 0; k < total; ++k) {
    const int slot = k % RING, t = k % per_image;
    const long long img = blockIdx.x + (long long)(k / per_image) * gridDim.x;
    const int y0 = (t / tiles_x) * TH, x0 = (t % tiles_x) * TW;
    float* tile = sm + slot * p.tile_stride;
    if (p.vec4) {
      mbar_wait(&full[slot], (unsigned)(k / RING) & 1u);
    } else {
      const float* src = p.img + (img * H + y0) * H * 3 + x0 * 3;
      for (int i = tid; i < TH * TW * 3; i += THREADS) {
        const int r = i / (TW * 3), c = i - r * TW * 3;
        tile[r * p.tile_row + c] = src[(long long)r * H * 3 + c];
      }
      __syncthreads();
    }
    pool_tile(p, tile, lv, img, y0, x0);
    __syncthreads();   // the block is done with the slot (and the levels)
    if (p.vec4 && tid == 0) fill(slot, k + RING);
  }
}

// The stage-0 CNN of image blockIdx.x. At most 64 registers a thread, so
// two 512-thread blocks share an SM.
template <typename W, bool STAGED>
__global__ void __launch_bounds__(THREADS, 2)
ps0_cnn_kernel(const __grid_constant__ PS0Params p) {
  extern __shared__ __align__(16) float stage[];   // cnn_stage floats
  cnn_image<W, STAGED>(p, blockIdx.x, stage);
}

// partial[z][m][n] = sum over k in chunk z of flat[m][k] dense_w[k][n]:
// DT x DT outputs a block, each of 256 threads owning a 4 x 4 block (rows
// 4 ty.., columns 4 tx..) read as one 16-byte load of each operand per k;
// k ascending in steps of DBK, the next step's tiles loaded into registers
// while this step's are used. The flat rows and dense_w rows are read 16
// bytes at a time when VEC (the wrapper's alignment check), else one
// value at a time.
template <typename W, bool VEC>
__global__ void __launch_bounds__(256)
ps0_dense_kernel(const __grid_constant__ PS0Params p) {
  constexpr int AS = DT + 4;          // row stride of the flat^T tile
  __shared__ __align__(16) float as[2][DBK][AS];
  __shared__ __align__(16) float ws[2][DBK][DT];
  const int B = p.B, D = p.dense_n;
  const int m0 = blockIdx.x * DT, n0 = blockIdx.y * DT;
  const long long k_begin = (long long)blockIdx.z * p.dense_k_chunk;
  const long long k_end = min(k_begin + p.dense_k_chunk, (long long)p.flat);
  const float* A = p.scratch + (long long)p.flat_buf * p.scratch_stride;
  const long long lda = 2 * p.scratch_stride;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // a step's tiles: DT x DBK of flat (8 values a thread), DBK x DT of
  // dense_w (8 a thread)
  float ra[8], rw[8];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + 256 * u;
      if (VEC) {
        const int m = e / (DBK / 4), kq = e % (DBK / 4);
        const long long gk = k0 + 4 * kq;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m0 + m < B && gk < k_end)   // k_end - gk is a multiple of 4
          v = __ldg(reinterpret_cast<const float4*>(
              A + (long long)(m0 + m) * lda + gk));
        ra[4 * u] = v.x; ra[4 * u + 1] = v.y;
        ra[4 * u + 2] = v.z; ra[4 * u + 3] = v.w;
        const int kk = e / (DT / 4), nq = e % (DT / 4);
        const long long gkk = k0 + kk;
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gkk < k_end && n0 + 4 * nq < D)
          w = WLoad<W>::four(p.dense_w, gkk * D + n0 + 4 * nq, p.dense_scale);
        rw[4 * u] = w.x; rw[4 * u + 1] = w.y;
        rw[4 * u + 2] = w.z; rw[4 * u + 3] = w.w;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int ee = e * 4 + v;
          const int m = ee / DBK, k = ee % DBK;
          const long long gk = k0 + k;
          ra[4 * u + v] = (m0 + m < B && gk < k_end)
                              ? A[(long long)(m0 + m) * lda + gk] : 0.f;
          const int kk = ee / DT, n = ee % DT;
          const long long gkk = k0 + kk;
          rw[4 * u + v] = (gkk < k_end && n0 + n < D)
                              ? WLoad<W>::one(p.dense_w, gkk * D + n0 + n,
                                              p.dense_scale)
                              : 0.f;
        }
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + 256 * u;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int ee = e * 4 + v;   // the same element order as fetch
        if (VEC) {
          as[buf][4 * (e % (DBK / 4)) + v][e / (DBK / 4)] = ra[4 * u + v];
          ws[buf][e / (DT / 4)][4 * (e % (DT / 4)) + v] = rw[4 * u + v];
        } else {
          as[buf][ee % DBK][ee / DBK] = ra[4 * u + v];
          ws[buf][ee / DT][ee % DT] = rw[4 * u + v];
        }
      }
    }
  };
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  int buf = 0;
  if (k_begin < k_end) {
    fetch(k_begin);
    stash(0);
  }
  __syncthreads();
  for (long long k0 = k_begin; k0 < k_end; k0 += DBK) {
    const bool more = k0 + DBK < k_end;
    if (more) fetch(k0 + DBK);   // in flight while this step computes
#pragma unroll 8
    for (int k = 0; k < DBK; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[buf][k][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&ws[buf][k][4 * tx]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);   // the other buffer was last read a step ago
    __syncthreads();
    buf ^= 1;
  }
  float* out = p.part + (long long)blockIdx.z * B * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (m < B && n < D) out[(long long)m * D + n] = acc[i][j];
    }
  }
}

// HEAD_T threads per image, HEAD_IMG images a block: thread j forms hidden
// units j, j + HEAD_T, ... = relu(sum_z partial[z][b][unit] + bias), z
// ascending, and their terms of the logit; the block adds the terms in a
// fixed tree order; score = sigmoid(logit + out_b).
template <typename W>
__global__ void __launch_bounds__(HEAD_T * HEAD_IMG)
ps0_head_kernel(const __grid_constant__ PS0Params p) {
  __shared__ float red[HEAD_IMG][HEAD_T];
  const int il = threadIdx.x / HEAD_T, j0 = threadIdx.x % HEAD_T;
  const int b = blockIdx.x * HEAD_IMG + il;
  const int D = p.dense_n;
  float t = 0.f;
  if (b < p.B) {
    for (int j = j0; j < D; j += HEAD_T) {
      const float* pz = p.part + (long long)b * D + j;
      float acc = 0.f;
#pragma unroll 8
      for (int z = 0; z < p.dense_split; ++z)
        acc += pz[(long long)z * p.B * D];
      const float hid = fmaxf(acc + __ldg(p.dense_b + j), 0.f);
      t = fmaf(hid, WLoad<W>::one(p.out_w, j, p.out_scale), t);
    }
  }
  red[il][j0] = t;
  __syncthreads();
#pragma unroll
  for (int w = HEAD_T / 2; w > 0; w /= 2) {
    if (j0 < w) red[il][j0] += red[il][j0 + w];
    __syncthreads();
  }
  if (j0 == 0 && b < p.B)
    p.scores[b] = 1.f / (1.f + expf(-(red[il][0] + __ldg(p.out_b))));
}

template <typename W>
static int launch(const PS0Params* p, cudaStream_t st) {
  if (p->smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ps0_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        p->smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  if (p->n_steps)
    ps0_pool_kernel<<<p->grid, THREADS, p->smem_bytes, st>>>(*p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (p->cnn_stage)
    ps0_cnn_kernel<W, true><<<p->B, THREADS, p->cnn_stage * 4, st>>>(*p);
  else
    ps0_cnn_kernel<W, false><<<p->B, THREADS, 0, st>>>(*p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p->B + DT - 1) / DT, (p->dense_n + DT - 1) / DT,
                  p->dense_split);
  if (p->dense_vec4)
    ps0_dense_kernel<W, true><<<grid, 256, 0, st>>>(*p);
  else
    ps0_dense_kernel<W, false><<<grid, 256, 0, st>>>(*p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ps0_head_kernel<W><<<(p->B + HEAD_IMG - 1) / HEAD_IMG, HEAD_T * HEAD_IMG,
                       0, st>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int repro_ps0_params_size() { return (int)sizeof(PS0Params); }

// The three launches of one chunk on ``stream``; returns the first CUDA
// error (0 = ok).
extern "C" int repro_pyramid_stage0(const PS0Params* p, int int8_weights,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->dense_k_chunk % DBK || p->dense_split < 1 || p->grid < 1)
    return (int)cudaErrorInvalidValue;
  return int8_weights ? launch<int8_t>(p, st) : launch<float>(p, st);
}
