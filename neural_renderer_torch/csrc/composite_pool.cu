// The rasterizer's output pass for Hopper (sm_90a): composite over the
// background, vertical flip and 2x2 mean pool of rgb, alpha and depth, from
// the forward's maps straight to the outputs of rasterize_rgbad.
//
// Not a TPU kernel: the JAX package does this in XLA (neural_renderer_tpu/
// rasterize/api.py:84-88, and the composite in its core).  In plain torch
// the chain (rasterize/composite_pool.composite_pool_plain) makes three
// full-size rgb maps for the composite, flips each output into another and
// pools them with torch's reduction kernel, which gives each output pixel
// four threads and a shuffle tree: ~12x over the bytes the pass needs.  It
// serves renders through which no gradient flows: the backward's K5 reads
// the full-resolution composited map, which this pass never writes.
//
// Inputs: cover [bs, is, is] int32 (a pixel is covered where >= 0), rgb
// uncomposited, as planes [bs, 3, is, is] (batch stride rgb_bstride) or
// interleaved [bs, is, is, 3] (texture.sample_textures' layout), depth
// [bs, is, is], the background on the device ([3]: bg_bstride 0; [bs, 3]:
// 3).  Outputs, contiguous: rgb [bs, 3, H, W], alpha and depth [bs, H, W],
// with H = W = is / 2 pooled and is otherwise.  Output row Y reads raster
// rows is-1-2Y and is-2-2Y pooled (is-1-Y otherwise).  Unrequested outputs
// are neither read nor written (the cover is read for rgb or alpha).
//
// Bits: equal to the plain version's.  Composite: c * m + (1 - m) * bg with
// m = 0 or 1, each product and sum rounded alone (the _rn intrinsics are
// never contracted).  Pool: torch's CUDA mean over dims (-3, -1) of the
// flipped map viewed as [.., H, 2, W, 2] adds each of the four values onto
// the reduction's identity 0 (so -0 becomes +0), sums them as
// (a + c) + (b + d), where a, b are the left and right pixel of raster row
// is-1-2Y and c, d those of row is-2-2Y (the vertical pairs first), and
// multiplies by 0.25.  That order was found on an H100 (torch 2.11), with
// values over 48 binades, against rows first, (a + b) + (c + d), and the
// chains ((a + b) + c) + d and ((a + c) + b) + d: it alone matched, for
// channel planes and channel-last maps alike, from bs 1 at 66^2 to bs 64 at
// 1024^2.  Alpha sums 0/1 values and is exact in any order.
// chip_smoke.py holds the kernel to the plain version bit for bit.
//
// What bounds it: the bytes.  Pooled with every output drawn it reads 20
// bytes a raster pixel (cover 4, rgb 12, depth 4) and writes 20 an output
// pixel: 1.68 GB, 0.50 ms at 3.35 TB/s for 64 views on a 1024^2 raster.
// Design: a thread owns four adjacent output pixels of a row.  Pooled it
// reads eight raster columns of both rows of each plane as 16-byte loads,
// neighbouring threads on neighbouring addresses, and writes one 16-byte
// store per output plane; every raster element is read once and nothing
// goes through shared memory (0.537 ms for those 1.68 GB on an H100 80GB
// HBM3 at 700 W, 93% of the bound).  Planes whose rows or pointers do not
// allow 16-byte accesses, and interleaved rgb, take a thread per output
// pixel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct PassArgs {
  const int* cover;
  const float* rgb;
  const float* depth;
  const float* bg;
  float* out_rgb;
  float* out_alpha;
  float* out_depth;
  long long rgb_bstride;  // elements between batch elements of rgb
  int bg_bstride;         // 0 for one color, 3 for one per batch element
  int bs, is, H, W;
  int rgb_interleaved;
};

__device__ __forceinline__ float coverage(int id) {
  return id >= 0 ? 1.0f : 0.0f;
}

__device__ __forceinline__ float composite(float c, float m, float bg) {
  return __fadd_rn(__fmul_rn(c, m), __fmul_rn(__fsub_rn(1.0f, m), bg));
}

// torch's mean of a 2x2 window: a, b the left and right pixel of the first
// row, c, d of the second
__device__ __forceinline__ float pool(float a, float b, float c, float d) {
  const float ac = __fadd_rn(__fadd_rn(0.0f, a), __fadd_rn(0.0f, c));
  const float bd = __fadd_rn(__fadd_rn(0.0f, b), __fadd_rn(0.0f, d));
  return __fmul_rn(__fadd_rn(ac, bd), 0.25f);
}

// N consecutive values (N a multiple of 4) from a 16-byte aligned address
template <int N>
__device__ __forceinline__ void load(const float* p, float (&v)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + k));
    v[k] = x.x; v[k + 1] = x.y; v[k + 2] = x.z; v[k + 3] = x.w;
  }
}

// the coverage of N consecutive pixels, as load
template <int N>
__device__ __forceinline__ void load_cover(const int* p, float (&m)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p + k));
    m[k] = coverage(x.x); m[k + 1] = coverage(x.y);
    m[k + 2] = coverage(x.z); m[k + 3] = coverage(x.w);
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// the four outputs of raster rows x0 (is-1-2Y) and x1 (the row above)
// pooled, of row x0 alone otherwise
template <bool kPool, int N>
__device__ __forceinline__ void reduce4(const float (&x0)[N],
                                        const float (&x1)[N],
                                        float (&out)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (kPool)
      out[j] = pool(x0[2 * j], x0[2 * j + 1], x1[2 * j], x1[2 * j + 1]);
    else
      out[j] = x0[j];
  }
}

// Planes with 16-byte rows: a thread per four adjacent output pixels.
template <bool kPool>
__device__ __forceinline__ void quads(const PassArgs& a) {
  constexpr int kCols = kPool ? 8 : 4;    // raster columns a row of a thread
  const int per_row = a.W / 4;
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)a.bs * a.H * per_row) return;
  const int q = (int)(t % per_row);
  const long long row = t / per_row;
  const int Y = (int)(row % a.H);
  const int b = (int)(row / a.H);
  const long long plane = (long long)a.is * a.is;
  // the first raster row's first column, and the same column a row above
  const long long p0 =
      (long long)(a.is - 1 - (kPool ? 2 * Y : Y)) * a.is + kCols * q;
  const long long p1 = p0 - a.is;
  const long long opl = (long long)a.H * a.W;
  const long long o = (long long)Y * a.W + 4 * q;   // within a plane

  float m0[kCols], m1[kCols], x0[kCols], x1[kCols], out[4];
  if (a.out_rgb || a.out_alpha) {
    load_cover(a.cover + b * plane + p0, m0);
    if constexpr (kPool) load_cover(a.cover + b * plane + p1, m1);
  }
  if (a.out_alpha) {
    reduce4<kPool>(m0, m1, out);
    store4(a.out_alpha + b * opl + o, out);
  }
  if (a.out_rgb) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float bg = a.bg[b * a.bg_bstride + c];
      const float* src = a.rgb + b * a.rgb_bstride + c * plane;
      load(src + p0, x0);
      if constexpr (kPool) load(src + p1, x1);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        x0[k] = composite(x0[k], m0[k], bg);
        if constexpr (kPool) x1[k] = composite(x1[k], m1[k], bg);
      }
      reduce4<kPool>(x0, x1, out);
      store4(a.out_rgb + (b * 3LL + c) * opl + o, out);
    }
  }
  if (a.out_depth) {
    load(a.depth + b * plane + p0, x0);
    if constexpr (kPool) load(a.depth + b * plane + p1, x1);
    reduce4<kPool>(x0, x1, out);
    store4(a.out_depth + b * opl + o, out);
  }
}

// Any layout and width: a thread per output pixel.
template <bool kPool>
__device__ __forceinline__ void pixels(const PassArgs& a) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)a.bs * a.H * a.W) return;
  const int X = (int)(t % a.W);
  const long long row = t / a.W;
  const int Y = (int)(row % a.H);
  const int b = (int)(row / a.H);
  const long long plane = (long long)a.is * a.is;
  // the window's raster pixels a, b (row is-1-2Y), c, d (the row above);
  // one pixel unpooled
  long long px[4];
  const int r0 = a.is - 1 - (kPool ? 2 * Y : Y);
  px[0] = (long long)r0 * a.is + (kPool ? 2 * X : X);
  px[1] = px[0] + 1;
  px[2] = px[0] - a.is;
  px[3] = px[2] + 1;
  constexpr int kN = kPool ? 4 : 1;
  const long long opl = (long long)a.H * a.W;
  const long long o = (long long)Y * a.W + X;

  float m[4];
  if (a.out_rgb || a.out_alpha) {
#pragma unroll
    for (int k = 0; k < kN; ++k) m[k] = coverage(a.cover[b * plane + px[k]]);
  }
  if (a.out_alpha)
    a.out_alpha[b * opl + o] =
        kPool ? pool(m[0], m[1], m[2], m[3]) : m[0];
  if (a.out_rgb) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float bg = a.bg[b * a.bg_bstride + c];
      float x[4];
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const long long at = a.rgb_interleaved ? px[k] * 3 + c
                                               : c * plane + px[k];
        x[k] = composite(a.rgb[b * a.rgb_bstride + at], m[k], bg);
      }
      a.out_rgb[(b * 3LL + c) * opl + o] =
          kPool ? pool(x[0], x[1], x[2], x[3]) : x[0];
    }
  }
  if (a.out_depth) {
    const float* src = a.depth + b * plane;
    a.out_depth[b * opl + o] =
        kPool ? pool(src[px[0]], src[px[1]], src[px[2]], src[px[3]])
              : src[px[0]];
  }
}

template <bool kPool, bool kQuads>
__global__ void __launch_bounds__(kThreads)
    composite_pool_kernel(PassArgs a) {
  if constexpr (kQuads)
    quads<kPool>(a);
  else
    pixels<kPool>(a);
}

template <bool kPool, bool kQuads>
int launch(const PassArgs& a, long long threads, cudaStream_t stream) {
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  composite_pool_kernel<kPool, kQuads>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// cover [bs, is, is] int32, rgb (planes with batch stride rgb_bstride, or
// interleaved), depth [bs, is, is], bg [3] or [bs, 3] (bg_bstride 0 or 3) on
// the device; out_rgb [bs, 3, H, W], out_alpha and out_depth [bs, H, W]
// contiguous, null where not drawn (their inputs may then be null).
// Launches on `stream` and returns cudaGetLastError().
int nr_composite_pool(const int* cover, const float* rgb, const float* depth,
                      const float* bg, int bs, int is, int pool,
                      long long rgb_bstride, int rgb_interleaved,
                      int bg_bstride, float* out_rgb, float* out_alpha,
                      float* out_depth, void* stream) {
  if (bs < 0 || is < 1 || (pool && is % 2) ||
      (bg_bstride != 0 && bg_bstride != 3))
    return (int)cudaErrorInvalidValue;
  const int H = pool ? is / 2 : is;
  PassArgs a{cover, rgb, depth, bg, out_rgb, out_alpha, out_depth,
             rgb_bstride, bg_bstride, bs, is, H, H, rgb_interleaved};
  const long long outputs = (long long)bs * H * H;
  if (outputs == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  // four outputs a thread where every row of every plane starts on 16 bytes
  const bool quad = H % 4 == 0 && is % 4 == 0 && !rgb_interleaved &&
                    rgb_bstride % 4 == 0 && aligned16(cover) &&
                    aligned16(rgb) && aligned16(depth) &&
                    aligned16(out_rgb) && aligned16(out_alpha) &&
                    aligned16(out_depth);
  if (quad)
    return pool ? launch<true, true>(a, outputs / 4, s)
                : launch<false, true>(a, outputs / 4, s);
  return pool ? launch<true, false>(a, outputs, s)
              : launch<false, false>(a, outputs, s);
}

}  // extern "C"
