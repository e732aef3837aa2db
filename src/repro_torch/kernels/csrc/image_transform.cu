// Fused representation transforms of raw frames (sm_90a).
//
// Replaces: src/repro/kernels/image_transform.py, fused_transform (body
// _transform_kernel) and fused_pyramid_transform (body _pyramid_kernel,
// helper _pool).
//
// Computes, per image: the box-filter levels of plan_pyramid (each level
// pooled from its source level, mean = sum / (f*f)), then for every output
// (res, cw) the 3 x C channel projection of its level and (x - mean) *
// inv_std. fused_transform is the one-output case of the same code.
//
// What bounds it on an H100: bytes. For 256 frames of 224 px the base read
// is 154 MB and the 20 outputs of the query path's representation space
// (28..224 px x 5 colors) write 478 MB: ~0.19 ms at 3.35 TB/s, against
// ~0.3 GFLOP of adds and products (~5 us of f32 FFMA).
//
// Design: the Pallas kernel holds a whole frame (602 KB at 224 px) in
// VMEM; a block has at most 227 KB of shared memory. So one block of 256
// threads owns one tile of tile_h x tile_w base pixels of one image, where
// both sides are multiples of every pooling factor from the base (the
// wrapper picks them; at 224 px a tile is a strip of 8 full rows, one
// contiguous 21 KB span). The tile is staged once into shared memory with
// 16-byte loads, every level's part of it is pooled there from its source
// level, and each output's part is projected and written straight to
// device memory. The base is read once; each output element is written
// once. Sums use explicit round-to-nearest adds and products (no FMA
// contraction), in the order of the stage-0 kernel's pooling, so outputs
// on dyadic pixels equal the plain version's bit for bit.
#include <cuda_runtime.h>

#define IT_MAX_OUTPUTS 32
#define IT_MAX_LEVELS 16
#define THREADS 256

struct ITParams {
  const float* img;                  // (B, H, H, 3)
  float* out[IT_MAX_OUTPUTS];        // (B, res, res, C) per output
  int B, H, tile_h, tile_w;          // tile sides in base pixels
  int vec4;                          // 1: 16-byte loads are aligned
  int smem_bytes;                    // base tile + every level's tile
  int n_levels;
  int level_res[IT_MAX_LEVELS];
  int level_src[IT_MAX_LEVELS];      // -1 = the base, else an earlier level
  int level_off[IT_MAX_LEVELS];      // float offset of its tile in smem
  int n_out;
  int out_level[IT_MAX_OUTPUTS];     // -1 = the base, else a level
  int out_ch[IT_MAX_OUTPUTS];        // C: 1 or 3
  float out_cw[9 * IT_MAX_OUTPUTS];  // (3, C) per output, row-major
  float mean, inv_std;
};

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

// ...and this one for fused_pyramid_transform.
__global__ void __launch_bounds__(THREADS)
fused_pyramid_transform_kernel(const __grid_constant__ ITParams p) {
  transform_tile(p);
}

extern "C" int repro_it_params_size() { return (int)sizeof(ITParams); }

static int launch(const ITParams* p, bool pyramid, void* stream) {
  const void* fn = pyramid ? (const void*)fused_pyramid_transform_kernel
                           : (const void*)fused_transform_kernel;
  if (p->smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, p->smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned tiles =
      (unsigned)((long long)(p->H / p->tile_h) * (p->H / p->tile_w) * p->B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pyramid)
    fused_pyramid_transform_kernel<<<tiles, THREADS, p->smem_bytes, st>>>(*p);
  else
    fused_transform_kernel<<<tiles, THREADS, p->smem_bytes, st>>>(*p);
  return (int)cudaGetLastError();
}

// One block per (image, tile) on ``stream``; return cudaGetLastError().
extern "C" int repro_fused_transform(const ITParams* p, void* stream) {
  return launch(p, false, stream);
}

extern "C" int repro_fused_pyramid_transform(const ITParams* p,
                                             void* stream) {
  return launch(p, true, stream);
}
