// Fused representation transforms of raw frames (sm_90a).
//
// Replaces: src/repro/kernels/image_transform.py, fused_transform (body
// _transform_kernel) and fused_pyramid_transform (body _pyramid_kernel,
// helper _pool).
//
// Computes, per image: the box-filter levels of plan_pyramid (each level
// pooled from its source level, mean = sum / (f*f)), then for every output
// (res, cw) the 3 x C channel projection of its level and (x - mean) *
// inv_std. fused_transform is the one-output case of the tile code below.
//
// What bounds it on an H100: bytes. For 256 frames of 224 px the base read
// is 154 MB and the 20 outputs of the query path's representation space
// (28..224 px x 5 colors) write 478 MB: ~0.19 ms at 3.35 TB/s, against
// ~0.3 GFLOP of adds and products (~5 us of f32 FFMA). Writes are 76% of
// the bytes, and 75% of them are the base's own outputs.
//
// Two designs. The Pallas kernel holds a whole frame (602 KB at 224 px)
// in VMEM; a block has at most 227 KB of shared memory.
//
// Strips (fused_pyramid_strip_kernel), for the plans the query path runs:
// levels 2, 4 and 8 times smaller than the base, each pooled from the one
// before (a chain), base a multiple of 16, frames 16-byte aligned. One
// block of 512 threads an SM walks over (image, strip of 16 full rows)
// work items blockIdx.x, + gridDim.x, ... A ring of shared-memory slots
// is filled by the copy engine (one cp.async.bulk a row, completion on the
// slot's mbarrier, issued by one thread as soon as the block is done with
// a slot), so the next strips are in flight while one is pooled and
// written. Each lane reads 8 pixels of one row and forms every level of
// its 8 x 8 block in registers, the rows meeting through shuffles (the
// stage-0 pooling kernel's chain, csrc/pyramid_stage0.cu); it leaves the
// raw levels in a small double-buffered shared area, whose outputs are
// written in the next work item's pass, after the block's one barrier.
// Every output value is written once, from shared memory, in a layout
// where neighbouring lanes write neighbouring 16 bytes (st.global.cs: the
// outputs are far larger than L2 and never read here): an identity (rgb)
// output is a copy, 16 bytes read and written a thread; a unit-column
// output (r, g, b) a select; any other takes 4 pixels a thread, three
// products and two adds a value (gray). The units of all of an item's
// outputs, the base's and the previous item's levels', are dealt out over
// the block as one sequence (a write plan built once a block): written
// level by level, the small levels' few units left most threads idle and
// the stores latency-bound. What is left is the memory's rate for this
// mix of reads and writes: the pooling and the refills overlap with the
// stores in flight.
//
// Tiles (fused_pyramid_transform_kernel, fused_transform_kernel), for
// every other plan and for fused_transform: one block of 256 threads owns
// one tile of tile_h x tile_w base pixels of one image, where both sides
// are multiples of every pooling factor from the base (the wrapper picks
// them; at 224 px a tile is a strip of 8 full rows, one contiguous 21 KB
// span). The tile is staged once into shared memory, every level's part
// of it is pooled there from its source level, and each output's part is
// projected and written straight to device memory.
//
// Both read the base once and write each output element once. Sums use
// explicit round-to-nearest adds and products (no FMA contraction), each
// window's in the plain version's order (rows, then pixels), so outputs on
// dyadic pixels equal the plain version's bit for bit, and the two designs
// give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define IT_MAX_OUTPUTS 32
#define IT_MAX_LEVELS 16
#define THREADS 256         // a tile block
#define STRIP_THREADS 512   // a strip block
#define STRIP_ROWS 16       // base rows a strip
#define MAX_RING 4          // strip slots: at most MAX_RING - 1 in flight

// ITParams.out_kind: how an output's (3, C) matrix projects
#define KIND_PRODUCTS 0     // three products a value (gray, any matrix)
#define KIND_IDENTITY 1     // (3, 3) identity: a copy
#define KIND_CHANNEL 2      // (3, 1) unit column k: kind 2 + k, a select

struct ITParams {
  const float* img;                  // (B, H, H, 3)
  float* out[IT_MAX_OUTPUTS];        // (B, res, res, C) per output
  int B, H, tile_h, tile_w;          // tiles: sides in base pixels
  int vec4;                          // tiles: 1 if 16-byte loads are aligned
  int smem_bytes;                    // tiles: base tile + every level's
  int n_levels;
  int level_res[IT_MAX_LEVELS];
  int level_src[IT_MAX_LEVELS];      // -1 = the base, else an earlier level
  int level_off[IT_MAX_LEVELS];      // tiles: float offset of its tile
  int n_out;
  int out_level[IT_MAX_OUTPUTS];     // -1 = the base, else a level
  int out_ch[IT_MAX_OUTPUTS];        // C: 1 or 3
  float out_cw[9 * IT_MAX_OUTPUTS];  // (3, C) per output, row-major
  float mean, inv_std;
  // The strip plan, which fused_pyramid_transform takes when chain != 0.
  // Last, so that the tile kernel reads the same few parameter lines.
  int chain;                         // levels 2, 4, 8 x smaller: bits 0,
                                     // 1, 2; or 0 (no strip plan)
  int ring;                          // ring slots
  int tile_row;                      // floats a slot row (padded)
  int lv_stride;                     // floats a level buffer
  int grid;                          // persistent blocks
  int out_kind[IT_MAX_OUTPUTS];      // KIND_*
};

// ---------------------------------------------------------------- tiles

// One output's part of the tile: src holds th x tw RGB pixels; writes
// th x tw x C values at (oy, ox) of the (res, res, C) image ``out``.
template <int C>
__device__ __forceinline__ void project(const float* src, float* out,
                                        int th, int tw, int res, int oy,
                                        int ox, const float* cw, float mean,
                                        float inv_std) {
  float w[3][C];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int c = 0; c < C; ++c) w[k][c] = cw[k * C + c];
  for (int pix = threadIdx.x; pix < th * tw; pix += THREADS) {
    const float* v = src + pix * 3;
    const float r = v[0], g = v[1], b = v[2];
    float* o = out + ((long long)(oy + pix / tw) * res + ox + pix % tw) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float x = __fadd_rn(__fadd_rn(__fmul_rn(r, w[0][c]),
                                          __fmul_rn(g, w[1][c])),
                                __fmul_rn(b, w[2][c]));
      o[c] = __fmul_rn(__fsub_rn(x, mean), inv_std);
    }
  }
}

__device__ __forceinline__ void transform_tile(const ITParams& p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int H = p.H, TH = p.tile_h, TW = p.tile_w;
  const int tiles_x = H / TW;
  const int per_image = (H / TH) * tiles_x;
  const long long b = blockIdx.x / per_image;
  const int t = blockIdx.x % per_image;
  const int y0 = (t / tiles_x) * TH, x0 = (t % tiles_x) * TW;
  const float* img = p.img + b * H * H * 3;

  // ---- stage the base tile: TH rows of TW * 3 contiguous floats
  const int row = TW * 3;
  if (p.vec4) {
    const int row4 = row / 4;
    for (int i = threadIdx.x; i < TH * row4; i += THREADS) {
      const float4* g = reinterpret_cast<const float4*>(
          img + ((long long)(y0 + i / row4) * H + x0) * 3);
      smem4[i] = __ldg(g + i % row4);
    }
  } else {
    for (int i = threadIdx.x; i < TH * row; i += THREADS)
      sm[i] = __ldg(img + ((long long)(y0 + i / row) * H + x0) * 3 +
                    i % row);
  }
  __syncthreads();

  // ---- pool each level's tile from its source level's tile
  for (int l = 0; l < p.n_levels; ++l) {
    const int src = p.level_src[l];
    const int sr = src < 0 ? H : p.level_res[src];
    const int f = sr / p.level_res[l];
    const int sw = TW / (H / sr);                 // source tile width
    const int fac = H / p.level_res[l];
    const int dw = TW / fac, n = (TH / fac) * dw * 3;
    const float* S = sm + (src < 0 ? 0 : p.level_off[src]);
    float* D = sm + p.level_off[l];
    const float area = (float)(f * f);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int c = i % 3, px = (i / 3) % dw, py = i / (3 * dw);
      float sum = 0.f;
      for (int fy = 0; fy < f; ++fy) {
        const float* r = S + ((py * f + fy) * sw + px * f) * 3 + c;
        for (int fx = 0; fx < f; ++fx) sum = __fadd_rn(sum, r[fx * 3]);
      }
      D[i] = __fdiv_rn(sum, area);
    }
    __syncthreads();
  }

  // ---- project and normalize each output's part of the tile
  for (int o = 0; o < p.n_out; ++o) {
    const int l = p.out_level[o];
    const int res = l < 0 ? H : p.level_res[l];
    const int fac = H / res;
    const float* S = sm + (l < 0 ? 0 : p.level_off[l]);
    float* out = p.out[o] + b * res * res * p.out_ch[o];
    const float* cw = p.out_cw + 9 * o;
    const int th = TH / fac, tw = TW / fac, oy = y0 / fac, ox = x0 / fac;
    if (p.out_ch[o] == 1)
      project<1>(S, out, th, tw, res, oy, ox, cw, p.mean, p.inv_std);
    else
      project<3>(S, out, th, tw, res, oy, ox, cw, p.mean, p.inv_std);
  }
}

// Two entry points over the same tile code, so that a profile tells them
// apart: the wrappers launch this one for fused_transform...
__global__ void __launch_bounds__(THREADS)
fused_transform_kernel(const __grid_constant__ ITParams p) {
  transform_tile(p);
}

// ...and this one for fused_pyramid_transform's plans that are no chain.
__global__ void __launch_bounds__(THREADS)
fused_pyramid_transform_kernel(const __grid_constant__ ITParams p) {
  transform_tile(p);
}

// ---------------------------------------------------------------- strips

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

// One step of a pyramid chain in registers (as in csrc/pyramid_stage0.cu).
// Lane l holds 8 / FS pixels of level-FS row j = l / G (FS base rows a
// level row) when j % FS == 0; it forms 8 / FD pixels of level-FD row
// j / FD (FD = FS f) from f level-FS rows, the lanes FS G apart below it:
// each mean of an f x f window, its sum in the plain version's order
// (rows, then pixels) with round-to-nearest adds, times 1 / f^2 (a power
// of two: exact).
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

// A lane's 8 / F level-F pixels into its level buffer, 16, 8 or 4 bytes at
// a time (the offset is a multiple of 24 / F floats).
template <int F>
__device__ __forceinline__ void put_level(float* d, const float (&v)[24]) {
  constexpr int N = 24 / F;
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(d + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2)
      *reinterpret_cast<float2*>(d + k) = make_float2(v[k], v[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = v[k];
  }
}

// The chain's levels of one strip (MASK: bit 0, 1, 2 for the levels 2, 4,
// 8 times smaller than the base), in registers, into the level buffer
// ``lv`` (level l's rows at lv_off[l], unpadded). Lane l of a warp
// reads 8 pixels of base row l / G of a band of U rows (16-byte shared
// loads; slot rows are padded by 4 floats, so the rows of a load do not
// share banks).
template <int MASK>
__device__ __forceinline__ void pool_strip(const ITParams& p,
                                           const float* tile, float* lv,
                                           const int* lv_off) {
  constexpr int U = MASK & 4 ? 8 : MASK & 2 ? 4 : 2;
  constexpr int G = 32 / U;                   // 8-pixel columns a warp
  const int lane = threadIdx.x % 32, j = lane / G, g = lane % G;
  const int H = p.H, cols = H / 8, per_band = (cols + G - 1) / G;
  const int items = (STRIP_ROWS / U) * per_band;
  for (int it = threadIdx.x / 32; it < items; it += STRIP_THREADS / 32) {
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
    const int y = band * U + j;       // the lane's row of the strip
    int step = 0;
    if (MASK & 1) {
      chain_step<1, 2, G>(lv0, lv1);
      if (on && j % 2 == 0)
        put_level<2>(lv + lv_off[step] + (y / 2 * (H / 2) + col * 4) * 3,
                     lv1);
      ++step;
    }
    if (MASK & 2) {
      if (MASK & 1) chain_step<2, 4, G>(lv1, lv2);
      else chain_step<1, 4, G>(lv0, lv2);
      if (on && j % 4 == 0)
        put_level<4>(lv + lv_off[step] + (y / 4 * (H / 4) + col * 2) * 3,
                     lv2);
      ++step;
    }
    if (MASK & 4) {
      if (MASK & 2) chain_step<4, 8, G>(lv2, lv3);
      else if (MASK & 1) chain_step<2, 8, G>(lv1, lv3);
      else chain_step<1, 8, G>(lv0, lv3);
      if (on && j % 8 == 0)
        put_level<8>(lv + lv_off[step] + (y / 8 * (H / 8) + col) * 3,
                     lv3);
    }
  }
}

__device__ __forceinline__ float norm(float x, float mean, float inv_std) {
  return __fmul_rn(__fsub_rn(x, mean), inv_std);
}

// The write plan of one block, built once in shared memory: each work
// item's outputs as a sequence of segments, first the base's (from the
// item's slot), then every level's (from the previous item's level
// buffer), in plan order. A segment is one identity output (a copy:
// 16 bytes a unit) or all the other outputs of a level (a group: 4
// pixels, 48 bytes read, a unit; 16 bytes written per C per output).
struct WritePlan {
  int n_seg, n_base;                        // segments; the base's first
  int seg_level[IT_MAX_OUTPUTS + IT_MAX_LEVELS + 1];   // -1: the base
  int seg_out[IT_MAX_OUTPUTS + IT_MAX_LEVELS + 1];     // copy: o; group: -1
  int seg_units[IT_MAX_OUTPUTS + IT_MAX_LEVELS + 1];
  int grp_begin[IT_MAX_LEVELS + 1], grp_end[IT_MAX_LEVELS + 1];  // level + 1
  int grp_out[IT_MAX_OUTPUTS];              // group members by level
  int lv_off[IT_MAX_LEVELS];                // each level's part of a buffer
};

// Thread 0: the write plan of p.
__device__ void build_plan(const ITParams& p, WritePlan& w) {
  int n_seg = 0, n_grp = 0;
  for (int l = -1; l < p.n_levels; ++l) {
    const int res = l < 0 ? p.H : p.level_res[l];
    const int n = STRIP_ROWS / (p.H / res) * res * 3;   // floats a strip
    if (l >= 0) {
      w.lv_off[l] = l == 0 ? 0 : w.lv_off[l - 1] +
          STRIP_ROWS / (p.H / p.level_res[l - 1]) * p.level_res[l - 1] * 3;
    }
    w.grp_begin[l + 1] = n_grp;
    for (int o = 0; o < p.n_out; ++o) {
      if (p.out_level[o] != l) continue;
      if (p.out_kind[o] == KIND_IDENTITY) {
        w.seg_level[n_seg] = l;
        w.seg_out[n_seg] = o;
        w.seg_units[n_seg++] = n / 4;
      } else {
        w.grp_out[n_grp++] = o;
      }
    }
    w.grp_end[l + 1] = n_grp;
    if (w.grp_end[l + 1] > w.grp_begin[l + 1]) {
      w.seg_level[n_seg] = l;
      w.seg_out[n_seg] = -1;
      w.seg_units[n_seg++] = n / 12;
    }
    if (l < 0) w.n_base = n_seg;
  }
  w.n_seg = n_seg;
}

// Segments [s0, s1) of the write plan: the base's outputs of work item
// ``it`` from ``tile``, the levels' of item ``lv_it`` from the level
// buffer ``lv``. Units are dealt out over the block as one sequence (thread
// t takes units t, t + STRIP_THREADS, ... across segment boundaries), so
// every thread has work until the last unit; lane t of a warp writes the
// 16 bytes after lane t - 1's, with the streaming hint (written once,
// never read here).
__device__ __forceinline__ void write_outputs(const ITParams& p,
                                              const WritePlan& w, int s0,
                                              int s1, const float* tile,
                                              long long it, const float* lv,
                                              long long lv_it) {
  const int strips = p.H / STRIP_ROWS;
  const float mean = p.mean, inv = p.inv_std;
  int u = threadIdx.x, first = 0;   // this thread's next unit; a segment's
  for (int s = s0; s < s1; ++s) {
    const int units = w.seg_units[s];
    if (u >= first + units) {
      first += units;
      continue;
    }
    const int l = w.seg_level[s];
    const int res = l < 0 ? p.H : p.level_res[l], fac = p.H / res;
    const int rowlen = res * 3, stride = l < 0 ? p.tile_row : rowlen;
    const float* S = l < 0 ? tile : lv + w.lv_off[l];
    const long long item = l < 0 ? it : lv_it;
    // the strip's first pixel in image item / strips's level
    const long long px0 = item / strips * res * res +
                          (long long)((int)(item % strips) * STRIP_ROWS /
                                      fac) * res;
    const int o = w.seg_out[s];
    if (o >= 0) {   // a copy, 4 floats a unit
      float4* out = reinterpret_cast<float4*>(p.out[o] + px0 * 3);
      for (; u < first + units; u += STRIP_THREADS) {
        const int f = 4 * (u - first), r = f / rowlen;
        float4 v = *reinterpret_cast<const float4*>(S + r * stride + f -
                                                    r * rowlen);
        v.x = norm(v.x, mean, inv); v.y = norm(v.y, mean, inv);
        v.z = norm(v.z, mean, inv); v.w = norm(v.w, mean, inv);
        __stcs(out + (u - first), v);
      }
    } else {        // a group, 4 pixels of one row a unit
      const int g0 = w.grp_begin[l + 1], g1 = w.grp_end[l + 1];
      for (; u < first + units; u += STRIP_THREADS) {
        const int q = u - first, f = 12 * q, r = f / rowlen;
        const float4* src =
            reinterpret_cast<const float4*>(S + r * stride + f - r * rowlen);
        const float4 a = src[0], c = src[1], d = src[2];
        const float R[4] = {a.x, a.w, c.z, d.y}, Gr[4] = {a.y, c.x, c.w, d.z},
                    B[4] = {a.z, c.y, d.x, d.w};
        for (int g = g0; g < g1; ++g) {
          const int oo = w.grp_out[g], kind = p.out_kind[oo];
          const int C = p.out_ch[oo];
          float4* out =
              reinterpret_cast<float4*>(p.out[oo] + (px0 + 4 * q) * C);
          const float* cw = p.out_cw + 9 * oo;
          auto proj = [&](int m, int ch) {   // pixel m, channel ch of C
            return norm(__fadd_rn(__fadd_rn(__fmul_rn(R[m], cw[ch]),
                                            __fmul_rn(Gr[m], cw[C + ch])),
                                  __fmul_rn(B[m], cw[2 * C + ch])),
                        mean, inv);
          };
          if (kind >= KIND_CHANNEL) {
            const int k = kind - KIND_CHANNEL;
            float v[4];
#pragma unroll
            for (int m = 0; m < 4; ++m)
              v[m] = norm(k == 0 ? R[m] : k == 1 ? Gr[m] : B[m], mean, inv);
            __stcs(out, make_float4(v[0], v[1], v[2], v[3]));
          } else if (C == 1) {
            __stcs(out, make_float4(proj(0, 0), proj(1, 0), proj(2, 0),
                                    proj(3, 0)));
          } else {
            __stcs(out, make_float4(proj(0, 0), proj(0, 1), proj(0, 2),
                                    proj(1, 0)));
            __stcs(out + 1, make_float4(proj(1, 1), proj(1, 2), proj(2, 0),
                                        proj(2, 1)));
            __stcs(out + 2, make_float4(proj(2, 2), proj(3, 0), proj(3, 1),
                                        proj(3, 2)));
          }
        }
      }
    }
    first += units;
  }
}

// Block k takes work items k, k + grid, ...; item i is strip i % (H / 16)
// of image i / (H / 16), which starts 16 H 3 i floats into the frames.
// Per item: wait for its slot, pool its levels into level buffer i % 2,
// write the base's outputs from the slot and the previous item's level
// outputs from the other buffer (one sequence of units), one barrier (the
// slot and that buffer are free), then thread 0 refills the slot with the
// item ``ring`` ahead.
__global__ void __launch_bounds__(STRIP_THREADS, 1)
fused_pyramid_strip_kernel(const __grid_constant__ ITParams p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) unsigned long long full[MAX_RING];
  __shared__ WritePlan w;
  const int H = p.H, ring = p.ring, slot_floats = STRIP_ROWS * p.tile_row;
  float* lvb = sm + ring * slot_floats;
  const long long items = (long long)p.B * (H / STRIP_ROWS);
  const int total = (int)((items - blockIdx.x + gridDim.x - 1) / gridDim.x);
  auto item = [&](int k) { return blockIdx.x + (long long)k * gridDim.x; };
  auto fill = [&](int slot, int k) {   // thread 0: this block's item k
    if (k >= total) return;
    const float* src = p.img + item(k) * STRIP_ROWS * H * 3;
    float* dst = sm + slot * slot_floats;
    mbar_expect_tx(&full[slot], (unsigned)(STRIP_ROWS * H * 12));
    for (int r = 0; r < STRIP_ROWS; ++r)
      bulk_copy(dst + r * p.tile_row, src + (long long)r * H * 3,
                (unsigned)(H * 12), &full[slot]);
  };
  if (threadIdx.x == 0) {
    for (int k = 0; k < ring; ++k) mbar_init(&full[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < ring; ++k) fill(k, k);
    build_plan(p, w);
  }
  __syncthreads();
  for (int k = 0; k < total; ++k) {
    const int slot = k % ring;
    const float* tile = sm + slot * slot_floats;
    float* lv = lvb + (k & 1) * p.lv_stride;
    mbar_wait(&full[slot], (unsigned)(k / ring) & 1u);
    switch (p.chain) {
      case 1: pool_strip<1>(p, tile, lv, w.lv_off); break;
      case 2: pool_strip<2>(p, tile, lv, w.lv_off); break;
      case 3: pool_strip<3>(p, tile, lv, w.lv_off); break;
      case 4: pool_strip<4>(p, tile, lv, w.lv_off); break;
      case 5: pool_strip<5>(p, tile, lv, w.lv_off); break;
      case 6: pool_strip<6>(p, tile, lv, w.lv_off); break;
      case 7: pool_strip<7>(p, tile, lv, w.lv_off); break;
    }
    write_outputs(p, w, 0, k > 0 ? w.n_seg : w.n_base, tile, item(k),
                  lvb + ((k - 1) & 1) * p.lv_stride, item(k - 1));
    __syncthreads();   // the block is done with the slot and that buffer
    if (threadIdx.x == 0) fill(slot, k + ring);
  }
  if (total > 0)
    write_outputs(p, w, w.n_base, w.n_seg, nullptr, 0,
                  lvb + ((total - 1) & 1) * p.lv_stride, item(total - 1));
}

// ---------------------------------------------------------------- launch

extern "C" int repro_it_params_size() { return (int)sizeof(ITParams); }

// Above 48 KB a kernel needs cudaFuncSetAttribute before its launch: done
// once per kernel, device and larger size, not on every launch.
static cudaError_t allow_smem(int which, const void* fn, int bytes) {
  static std::atomic<int> allowed[3][64];
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && allowed[which][dev].load() >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 64) allowed[which][dev].store(bytes);
  return e;
}

static int launch(const ITParams* p, bool pyramid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->B < 1 || p->H < 1 || p->n_out < 1 || p->n_out > IT_MAX_OUTPUTS ||
      p->n_levels < 0 || p->n_levels > IT_MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  if (pyramid && p->chain) {
    if (p->ring < 2 || p->ring > MAX_RING || p->grid < 1 ||
        p->H % STRIP_ROWS)
      return (int)cudaErrorInvalidValue;
    const int smem =
        4 * (p->ring * STRIP_ROWS * p->tile_row + 2 * p->lv_stride);
    const cudaError_t e =
        allow_smem(2, (const void*)fused_pyramid_strip_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    fused_pyramid_strip_kernel<<<p->grid, STRIP_THREADS, smem, st>>>(*p);
    return (int)cudaGetLastError();
  }
  if (p->tile_h < 1 || p->tile_w < 1 || p->H % p->tile_h || p->H % p->tile_w)
    return (int)cudaErrorInvalidValue;
  const void* fn = pyramid ? (const void*)fused_pyramid_transform_kernel
                           : (const void*)fused_transform_kernel;
  const cudaError_t e = allow_smem(pyramid, fn, p->smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles =
      (unsigned)((long long)(p->H / p->tile_h) * (p->H / p->tile_w) * p->B);
  if (pyramid)
    fused_pyramid_transform_kernel<<<tiles, THREADS, p->smem_bytes, st>>>(*p);
  else
    fused_transform_kernel<<<tiles, THREADS, p->smem_bytes, st>>>(*p);
  return (int)cudaGetLastError();
}

// On ``stream``; return cudaGetLastError() (0 = ok). fused_transform: one
// tile block per (image, tile).
extern "C" int repro_fused_transform(const ITParams* p, void* stream) {
  return launch(p, false, stream);
}

// The strip kernel when ``chain`` is set (its plan beside the tile plan),
// else the tile kernel.
extern "C" int repro_fused_pyramid_transform(const ITParams* p,
                                             void* stream) {
  return launch(p, true, stream);
}
