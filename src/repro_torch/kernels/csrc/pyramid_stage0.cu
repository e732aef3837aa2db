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
// Design: one block of 512 threads per image, one launch per chunk, phases
// separated by __syncthreads(); at most 64 registers a thread so that two
// blocks share an SM. The base is read once (only the first pooling step
// reads it) and never staged whole: 602 KB per 224 px frame is far above
// the 227 KB of shared memory a block can hold. The halving steps issue the
// loads of four outputs before any store, to keep more bytes in flight.
// Activations live in a global scratch (two ping-pong buffers per image)
// that the wrapper allocates. A conv work item is one pooled pixel x 4
// output channels: its 4x4 input patch is loaded once per input channel and
// shared by the four pooling windows, and each tap's 4 weights arrive in
// one 16-byte load, so the pre-pool outputs never leave registers. The
// dense loop keeps four partial sums so four L2 loads are in flight.
// Arithmetic is f32 FFMA, not TF32 tensor cores: parity with the reference
// is f32. The dense weights (up to ~100 MB for a 1-layer 224 px model) are
// read through L2, never staged. Keeping activations on chip is left to a
// later kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_STEPS 8
#define MAX_CONV 8
#define THREADS 512

struct PS0Params {
  const float* img;              // (B, H, H, 3)
  float* scores;                 // (B,)
  float* scratch;                // (B, 2, scratch_stride)
  float* step_out[MAX_STEPS];    // (B, res, res, 3) per pooling step
  const void* conv_w[MAX_CONV];  // (3, 3, cin, cout) HWIO, f32 or int8
  const float* conv_b[MAX_CONV]; // (cout,)
  const void* dense_w;           // (flat, dense_n)
  const float* dense_b;          // (dense_n,)
  const void* out_w;             // (dense_n, 1)
  const float* out_b;            // (1,)
  long long scratch_stride;      // floats per ping-pong buffer per image
  int B, H, n_steps, s0_step, s0_res, C, n_conv, dense_n;
  int step_res[MAX_STEPS];
  int step_src[MAX_STEPS];       // -1 = the base image, else an earlier step
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

// at most 64 registers a thread, so two 512-thread blocks share an SM
template <typename W>
__global__ void __launch_bounds__(THREADS, 2)
pyramid_stage0_kernel(const PS0Params p) {
  __shared__ float red[THREADS];
  __shared__ float hid[THREADS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const long long H = p.H;
  const float* base = p.img + (long long)b * H * H * 3;

  // ---- phase 1: progressive pooling, each level from its source level
  for (int s = 0; s < p.n_steps; ++s) {
    const int r = p.step_res[s];
    const int src = p.step_src[s];
    const int sr = src < 0 ? p.H : p.step_res[src];
    const float* S = src < 0 ? base
                             : p.step_out[src] + (long long)b * sr * sr * 3;
    float* out = p.step_out[s] + (long long)b * r * r * 3;
    const int f = sr / r;
    const float area = (float)(f * f);
    if (f == 2) {
      // the usual halving step: a thread issues the 16 loads of four
      // outputs before any store (a store could alias a later load, so the
      // compiler would not hoist them itself) — more bytes in flight
      const int n = r * r * 3;
      for (int i0 = tid; i0 < n; i0 += 4 * THREADS) {
        float v[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = i0 + u * THREADS;
          if (idx < n) {
            const int c = idx % 3;
            const int px = (idx / 3) % r;
            const int py = idx / (3 * r);
            const float* r0 = S + ((long long)(2 * py) * sr + 2 * px) * 3 + c;
            const float* r1 = r0 + (long long)sr * 3;
            v[u][0] = r0[0];
            v[u][1] = r0[3];
            v[u][2] = r1[0];
            v[u][3] = r1[3];
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int idx = i0 + u * THREADS;
          if (idx < n)
            out[idx] = __fdiv_rn(
                __fadd_rn(__fadd_rn(__fadd_rn(v[u][0], v[u][1]), v[u][2]),
                          v[u][3]),
                area);
        }
      }
    } else {
      for (int idx = tid; idx < r * r * 3; idx += THREADS) {
        const int c = idx % 3;
        const int px = (idx / 3) % r;
        const int py = idx / (3 * r);
        float sum = 0.f;
        for (int fy = 0; fy < f; ++fy) {
          const float* row =
              S + ((long long)(py * f + fy) * sr + px * f) * 3 + c;
          for (int fx = 0; fx < f; ++fx) sum = __fadd_rn(sum, row[fx * 3]);
        }
        out[idx] = __fdiv_rn(sum, area);
      }
    }
    __syncthreads();
  }

  // ---- phase 2: color projection of the stage-0 level into scratch 0
  const int s0 = p.s0_res;
  const int C = p.C;
  const float* L = p.s0_step < 0
                       ? base
                       : p.step_out[p.s0_step] + (long long)b * s0 * s0 * 3;
  float* buf0 = p.scratch + (long long)b * 2 * p.scratch_stride;
  float* buf1 = buf0 + p.scratch_stride;
  for (int idx = tid; idx < s0 * s0 * C; idx += THREADS) {
    const int c = idx % C;
    const float* px = L + (long long)(idx / C) * 3;
    const float v = __fadd_rn(__fadd_rn(__fmul_rn(px[0], p.cw[c]),
                                        __fmul_rn(px[1], p.cw[C + c])),
                              __fmul_rn(px[2], p.cw[2 * C + c]));
    buf0[idx] = v;
  }
  __syncthreads();

  // ---- phase 3: conv3x3-SAME + bias, ReLU, maxpool2 per layer
  const float* in = buf0;
  float* outb = buf1;
  int h = s0, cin = C;
  for (int l = 0; l < p.n_conv; ++l) {
    const int cout = p.conv_cout[l];
    if (cout % 4 == 0)
      conv_layer<W, 4>(in, outb, h, cin, cout, p.conv_w[l], p.conv_scale[l],
                       p.conv_b[l]);
    else
      conv_layer<W, 1>(in, outb, h, cin, cout, p.conv_w[l], p.conv_scale[l],
                       p.conv_b[l]);
    __syncthreads();
    const float* t = in;
    in = outb;
    outb = const_cast<float*>(t);
    h /= 2;
    cin = cout;
  }

  // ---- phase 4: dense + ReLU over the NHWC flatten, output dot, sigmoid
  const long long n_flat = (long long)h * h * cin;
  const int D = p.dense_n;
  const int G = THREADS / D;
  const int j = tid % D;
  const int g = tid / D;
  float part = 0.f;
  if (g < G) {
    // four independent partial sums keep four weight loads in flight
    float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
    long long i = g;
    for (; i + 3 * G < n_flat; i += 4 * G) {
      p0 = fmaf(in[i], WLoad<W>::one(p.dense_w, i * D + j, p.dense_scale), p0);
      p1 = fmaf(in[i + G],
                WLoad<W>::one(p.dense_w, (i + G) * D + j, p.dense_scale), p1);
      p2 = fmaf(in[i + 2 * G],
                WLoad<W>::one(p.dense_w, (i + 2 * G) * D + j, p.dense_scale),
                p2);
      p3 = fmaf(in[i + 3 * G],
                WLoad<W>::one(p.dense_w, (i + 3 * G) * D + j, p.dense_scale),
                p3);
    }
    for (; i < n_flat; i += G)
      p0 = fmaf(in[i], WLoad<W>::one(p.dense_w, i * D + j, p.dense_scale), p0);
    part = (p0 + p1) + (p2 + p3);
  }
  red[tid] = part;
  __syncthreads();
  if (tid < D) {
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += red[gg * D + tid];
    hid[tid] = fmaxf(acc + __ldg(p.dense_b + tid), 0.f);
  }
  __syncthreads();
  if (tid == 0) {
    float logit = 0.f;
    for (int jj = 0; jj < D; ++jj)
      logit = fmaf(hid[jj], WLoad<W>::one(p.out_w, jj, p.out_scale), logit);
    logit += __ldg(p.out_b);
    p.scores[b] = 1.f / (1.f + expf(-logit));
  }
}

extern "C" int repro_ps0_params_size() { return (int)sizeof(PS0Params); }

// Launches one block per image on ``stream``; returns cudaGetLastError().
extern "C" int repro_pyramid_stage0(const PS0Params* p, int int8_weights,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8_weights)
    pyramid_stage0_kernel<int8_t><<<p->B, THREADS, 0, st>>>(*p);
  else
    pyramid_stage0_kernel<float><<<p->B, THREADS, 0, st>>>(*p);
  return (int)cudaGetLastError();
}
