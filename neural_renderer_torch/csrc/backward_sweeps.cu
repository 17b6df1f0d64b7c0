// K5 sweeps of the rasterizer's approximate backward for Hopper (sm_90a):
// the in-sweep and the out-sweep of the pixel-centric vertex gradient.
//
// Replace the TPU kernels backward_pallas._kernel (the in-sweep) and
// backward_pallas._outsweep_kernel (the out-sweep)
// (neural_renderer_tpu/rasterize/backward_pallas.py).  Both write channels
// of a channel-leading stack [bs, 12, is, is] in the (edge, axis) order
// _EA of rasterize/backward.py: channel 2 * (a * 3 + e) + k holds term c_k
// of edge e walked along axis a.  The stack may be a channel slice of a
// larger one: consecutive batch rows lie `bstride` floats apart.
//
// What bounds them on this card.  The in-sweep reads ~14 planes (xy 6,
// face ids, rgb 3, grad rgb 3, grad alpha) and writes 12: at batch 32 on a
// 512^2 raster ~870 MB, ~0.26 ms at 3.35 TB/s; its ~400 f32 operations a
// pixel (3 edges x 2 axes of crossing math) stay under that.  The
// out-sweep stages its line's value and gradient planes in shared memory;
// its work is one pass over the line per active crossing (O(is) each), so
// it is bound by f32 issue on the crossing-dense lines, not by memory.
//
// Design.  In-sweep: one thread per (batch, pixel) does all 6 (edge, axis)
// walks of its own face and fetches each crossing's out-pixel with a direct
// load (the TPU's lane-roll chain, offset radius and chunk-skip ladder exist
// only because a TPU lacks gathers).  Out-sweep: one block per (line,
// axis, batch); the line is the column x = L for axis 0 and the row y = L
// for axis 1.  Its threads stage the line's alpha, grad alpha, rgb and grad
// rgb in shared memory and mark which of each pixel's 3 edges has an active
// crossing (covered & valid & d1_in == the pixel's own d1); then one warp
// per crossing sums the gated terms over [lo, hi] of the line, lane-strided,
// and reduces with a fixed shuffle tree, so every run gives the same bits.
// There is no capacity (no row cap, schedule or budget).
//
// Numerics.  Every expression repeats the operand order of the plain
// PyTorch version (rasterize/backward.py), which follows the JAX package
// and the reference: build with --fmad=false and without fast math, so the
// in-sweep agrees with the plain version bit for bit (a contracted
// multiply-add could flip a dg > 0 gate or a d1_in == d1 test).  min/max
// propagate NaN as torch.minimum/maximum do.  The out-sweep's sums run in
// another order than torch.sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInThreads = 256;
constexpr int kOutThreads = 256;
constexpr int kWarps = kOutThreads / 32;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

// torch.minimum / torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? nan_f() : (a < b ? a : b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? nan_f() : (a > b ? a : b);
}
// torch.clamp(x, min=lo) / clamp(x, max=hi): NaN stays NaN
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x > hi ? hi : x;
}

// geometry.to_pixel_coords: 0.5 * (v * is + is - 1)
__device__ __forceinline__ float to_pixel(float v, float fis) {
  return 0.5f * (((v * fis) + fis) - 1.0f);
}

struct Walk {               // one edge in the walk frame of one axis
  float X0, X1, X2, Y0, Y1, Y2;
};

__device__ __forceinline__ Walk edge_coords(const float* ppx, const float* ppy,
                                            int e, int a) {
  const int i0 = e, i1 = (e + 1) % 3, i2 = (e + 2) % 3;
  Walk w;
  if (a == 0) {
    w.X0 = ppx[i0]; w.X1 = ppx[i1]; w.X2 = ppx[i2];
    w.Y0 = ppy[i0]; w.Y1 = ppy[i1]; w.Y2 = ppy[i2];
  } else {
    w.X0 = ppy[i0]; w.X1 = ppy[i1]; w.X2 = ppy[i2];
    w.Y0 = ppx[i0]; w.Y1 = ppx[i1]; w.Y2 = ppx[i2];
  }
  return w;
}

struct Cross {
  float dir, d1_cross, d1_in, d1_out;
  bool valid;
};

// backward._crossing (rasterize.py:559-579)
__device__ __forceinline__ Cross crossing(const Walk& w, int a, float d0,
                                          float fis) {
  Cross c;
  c.dir = (a == 0) ? (w.X0 < w.X1 ? -1.0f : 1.0f)
                   : (w.X0 < w.X1 ? 1.0f : -1.0f);
  const float d0_from = clamp_lo(ceilf(tmin(w.X0, w.X1)), 0.0f);
  const float d0_to = truncf(clamp_hi(tmax(w.X0, w.X1), fis - 1.0f));
  const bool in_extent = (d0 >= d0_from) && (d0 <= d0_to);
  c.d1_cross = (w.Y1 - w.Y0) / (w.X1 - w.X0) * (d0 - w.X0) + w.Y0;
  c.d1_in = c.dir > 0.0f ? floorf(c.d1_cross) : ceilf(c.d1_cross);
  c.d1_out = c.d1_in + c.dir;
  c.valid = in_extent && (c.d1_in >= 0.0f) && (c.d1_in <= fis - 1.0f) &&
            (c.d1_out >= 0.0f) && (c.d1_out <= fis - 1.0f);
  return c;
}

// backward._in_limit (rasterize.py:663-670)
__device__ __forceinline__ float in_limit(const Walk& w, float d0, float dir) {
  const bool mid = (d0 - w.X0) * (d0 - w.X2) < 0.0f;
  const float c_a = (w.Y2 - w.Y0) / (w.X2 - w.X0) * (d0 - w.X0) + w.Y0;
  const float c_b = (w.Y1 - w.Y2) / (w.X1 - w.X2) * (d0 - w.X2) + w.Y2;
  const float x = mid ? c_a : c_b;
  const float lim = dir > 0.0f ? ceilf(x) : floorf(x);
  return lim != lim ? 0.0f : lim;
}

// one term of backward._dist_contrib: -dg / dist
__device__ __forceinline__ float dist_term(float dg, float k_num, float k_den,
                                           float delta, float fis, float eps) {
  float dist = k_num / k_den * delta * 2.0f / fis;
  dist = dist > 0.0f ? dist + eps : dist - eps;
  return -dg / dist;
}

// backward._dist_contrib: (c0, c1), gated on dg > 0
__device__ __forceinline__ void dist_contrib(float dg, float delta,
                                             const Walk& w, float d0,
                                             float fis, float eps, float* c0,
                                             float* c1) {
  const bool gate = dg > 0.0f;
  *c0 = (gate && w.X1 != d0)
            ? dist_term(dg, w.X1 - w.X0, w.X1 - d0, delta, fis, eps) : 0.0f;
  *c1 = (gate && w.X0 != d0)
            ? dist_term(dg, w.X1 - w.X0, d0 - w.X0, delta, fis, eps) : 0.0f;
}

// the pixel's own face in pixel space, from the forward's NDC xy planes
__device__ __forceinline__ void load_face(const float* xy, size_t plane,
                                          float fis, float* ppx, float* ppy) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ppx[k] = to_pixel(xy[(2 * k) * plane], fis);
    ppy[k] = to_pixel(xy[(2 * k + 1) * plane], fis);
  }
}

// In-sweep.  xy [bs, 6, is, is], fim [bs, is, is], rgb / grgb [bs, 3, is,
// is] (RGB), galpha [bs, is, is] (ALPHA); out: 12 channels per batch row.
template <bool RGB, bool ALPHA>
__global__ void __launch_bounds__(kInThreads)
insweep_kernel(const float* __restrict__ xy, const int* __restrict__ fim,
               const float* __restrict__ rgb, const float* __restrict__ grgb,
               const float* __restrict__ galpha, int bs, int is, float eps,
               float* __restrict__ out, long long bstride) {
  const size_t plane = (size_t)is * is;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (size_t)bs * plane) return;
  const int b = (int)(gid / plane);
  const size_t p = gid - (size_t)b * plane;
  const int y = (int)(p / is);
  const int x = (int)(p - (size_t)y * is);
  float* o = out + (size_t)b * bstride + p;
  if (fim[gid] < 0) {
#pragma unroll
    for (int ch = 0; ch < 12; ++ch) o[ch * plane] = 0.0f;
    return;
  }
  const float fis = (float)is;
  float ppx[3], ppy[3];
  load_face(xy + (size_t)b * 6 * plane + p, plane, fis, ppx, ppy);
  const float* rgb_b = RGB ? rgb + (size_t)b * 3 * plane : nullptr;
  float rgb_own[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f};
  if (RGB) {
    for (int c = 0; c < 3; ++c) {
      rgb_own[c] = rgb_b[c * plane + p];
      g[c] = grgb[(size_t)b * 3 * plane + c * plane + p];
    }
  }
  const float ga = ALPHA ? galpha[gid] : 0.0f;

  for (int a = 0; a < 2; ++a) {
    const float d0 = (float)(a == 0 ? x : y);
    const float d1 = (float)(a == 0 ? y : x);
    for (int e = 0; e < 3; ++e) {
      const Walk w = edge_coords(ppx, ppy, e, a);
      const Cross cr = crossing(w, a, d0, fis);
      const float lim = in_limit(w, d0, cr.dir);
      const float lo2 = clamp_lo(tmin(cr.d1_in, lim), 0.0f);
      const float hi2 = clamp_hi(tmax(cr.d1_in, lim), fis - 1.0f);
      float c0 = 0.0f, c1 = 0.0f;
      if (cr.valid && d1 >= lo2 && d1 <= hi2) {
        // the out-pixel: row d1_out of column x (a = 0), column d1_out of
        // row y (a = 1)
        const int od = (int)cr.d1_out;
        const size_t op = a == 0 ? (size_t)od * is + x : (size_t)y * is + od;
        float dg = 0.0f;
        if (ALPHA) {
          const float a_out = fim[(size_t)b * plane + op] >= 0 ? 1.0f : 0.0f;
          dg = dg + (1.0f - a_out) * ga;
        }
        if (RGB) {
          const float t0 = (rgb_own[0] - rgb_b[op]) * g[0];
          const float t1 = (rgb_own[1] - rgb_b[plane + op]) * g[1];
          const float t2 = (rgb_own[2] - rgb_b[2 * plane + op]) * g[2];
          dg = dg + (t0 + t1 + t2);
        }
        dist_contrib(dg, d1 - cr.d1_cross, w, d0, fis, eps, &c0, &c1);
      }
      const int ch = 2 * (a * 3 + e);
      o[ch * plane] = c0;
      o[(ch + 1) * plane] = c1;
    }
  }
}

// Out-sweep.  One block per (line L, axis a, batch b).  With `accumulate`
// the sums are added to `out` (out = out + sum); otherwise written.
template <bool RGB, bool ALPHA>
__global__ void __launch_bounds__(kOutThreads)
outsweep_kernel(const float* __restrict__ xy, const int* __restrict__ fim,
                const float* __restrict__ rgb, const float* __restrict__ grgb,
                const float* __restrict__ galpha, int is, float eps,
                float* __restrict__ out, long long bstride, int accumulate) {
  extern __shared__ float smem[];
  float* s_a = smem;                 // alpha (covered) of the line
  float* s_ga = s_a + is;            // grad alpha
  float* s_rgb = s_ga + is;          // rgb [3][is]
  float* s_g = s_rgb + 3 * is;       // grad rgb [3][is]
  uint8_t* s_act = (uint8_t*)(s_g + 3 * is);   // active-edge bits

  const int L = blockIdx.x;
  const int a = blockIdx.y;
  const int b = blockIdx.z;
  const size_t plane = (size_t)is * is;
  const float fis = (float)is;
  const float d0 = (float)L;
  const float* xy_b = xy + (size_t)b * 6 * plane;
  // pixel of line position r
  auto pixel = [&](int r) -> size_t {
    return a == 0 ? (size_t)r * is + L : (size_t)L * is + r;
  };

  for (int r = threadIdx.x; r < is; r += blockDim.x) {
    const size_t p = pixel(r);
    const bool cov = fim[(size_t)b * plane + p] >= 0;
    s_a[r] = cov ? 1.0f : 0.0f;
    s_ga[r] = ALPHA ? galpha[(size_t)b * plane + p] : 0.0f;
    for (int c = 0; c < 3; ++c) {
      s_rgb[c * is + r] = RGB ? rgb[((size_t)b * 3 + c) * plane + p] : 0.0f;
      s_g[c * is + r] = RGB ? grgb[((size_t)b * 3 + c) * plane + p] : 0.0f;
    }
    uint8_t bits = 0;
    if (cov) {
      float ppx[3], ppy[3];
      load_face(xy_b + p, plane, fis, ppx, ppy);
      for (int e = 0; e < 3; ++e) {
        const Cross cr = crossing(edge_coords(ppx, ppy, e, a), a, d0, fis);
        if (cr.valid && cr.d1_in == (float)r) bits |= (uint8_t)(1 << e);
      }
    }
    s_act[r] = bits;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < is; r += kWarps) {
    const uint8_t bits = s_act[r];
    if (bits == 0 && accumulate) continue;
    const size_t p = pixel(r);
    float* o = out + (size_t)b * bstride + p;
    float ppx[3], ppy[3];
    if (bits) load_face(xy_b + p, plane, fis, ppx, ppy);
    for (int e = 0; e < 3; ++e) {
      float s0 = 0.0f, s1 = 0.0f;
      if ((bits >> e) & 1) {
        const Walk w = edge_coords(ppx, ppy, e, a);
        const Cross cr = crossing(w, a, d0, fis);
        const float d1_limit = cr.dir > 0.0f ? fis - 1.0f : 0.0f;
        const int lo = (int)clamp_lo(tmin(cr.d1_out, d1_limit), 0.0f);
        const int hi = (int)clamp_hi(tmax(cr.d1_out, d1_limit), fis - 1.0f);
        const float a_in = s_a[r];
        const float r0 = s_rgb[r], r1 = s_rgb[is + r], r2 = s_rgb[2 * is + r];
        for (int q = lo + lane; q <= hi; q += 32) {
          float dg = 0.0f;
          if (ALPHA) dg = dg + (s_a[q] - a_in) * s_ga[q];
          if (RGB) {
            const float t0 = (s_rgb[q] - r0) * s_g[q];
            const float t1 = (s_rgb[is + q] - r1) * s_g[is + q];
            const float t2 = (s_rgb[2 * is + q] - r2) * s_g[2 * is + q];
            dg = dg + (t0 + t1 + t2);
          }
          float c0, c1;
          dist_contrib(dg, (float)q - cr.d1_cross, w, d0, fis, eps, &c0, &c1);
          s0 = s0 + c0;
          s1 = s1 + c1;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s0 = s0 + __shfl_down_sync(0xffffffffu, s0, off);
          s1 = s1 + __shfl_down_sync(0xffffffffu, s1, off);
        }
      } else if (accumulate) {
        continue;
      }
      if (lane == 0) {
        const int ch = 2 * (a * 3 + e);
        float* o0 = o + ch * plane;
        float* o1 = o + (ch + 1) * plane;
        *o0 = accumulate ? *o0 + s0 : s0;
        *o1 = accumulate ? *o1 + s1 : s1;
      }
    }
  }
}

size_t outsweep_smem(int is) {
  return (size_t)8 * is * sizeof(float) + (size_t)is;
}

template <bool RGB, bool ALPHA>
int launch_in(const float* xy, const int* fim, const float* rgb,
              const float* grgb, const float* galpha, int bs, int is,
              float eps, float* out, long long bstride, cudaStream_t s) {
  const size_t n = (size_t)bs * is * is;
  const unsigned blocks = (unsigned)((n + kInThreads - 1) / kInThreads);
  insweep_kernel<RGB, ALPHA><<<blocks, kInThreads, 0, s>>>(
      xy, fim, rgb, grgb, galpha, bs, is, eps, out, bstride);
  return (int)cudaGetLastError();
}

template <bool RGB, bool ALPHA>
int launch_out(const float* xy, const int* fim, const float* rgb,
               const float* grgb, const float* galpha, int bs, int is,
               float eps, float* out, long long bstride, int accumulate,
               cudaStream_t s) {
  const size_t smem = outsweep_smem(is);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        outsweep_kernel<RGB, ALPHA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(is, 2, bs);
  outsweep_kernel<RGB, ALPHA><<<grid, kOutThreads, smem, s>>>(
      xy, fim, rgb, grgb, galpha, is, eps, out, bstride, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// rgb and grgb are both null (rgb not drawn) or both set; galpha is null
// when alpha is not drawn.  out: batch row b's 12 channels start at
// out + b * bstride, each a contiguous is x is plane.
int nr_insweep(const float* xy, const int* fim, const float* rgb,
               const float* grgb, const float* galpha, int bs, int is,
               float eps, float* out, long long bstride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rgb && galpha)
    return launch_in<true, true>(xy, fim, rgb, grgb, galpha, bs, is, eps,
                                 out, bstride, s);
  if (rgb)
    return launch_in<true, false>(xy, fim, rgb, grgb, galpha, bs, is, eps,
                                  out, bstride, s);
  if (galpha)
    return launch_in<false, true>(xy, fim, rgb, grgb, galpha, bs, is, eps,
                                  out, bstride, s);
  return (int)cudaErrorInvalidValue;
}

int nr_outsweep(const float* xy, const int* fim, const float* rgb,
                const float* grgb, const float* galpha, int bs, int is,
                float eps, float* out, long long bstride, int accumulate,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rgb && galpha)
    return launch_out<true, true>(xy, fim, rgb, grgb, galpha, bs, is, eps,
                                  out, bstride, accumulate, s);
  if (rgb)
    return launch_out<true, false>(xy, fim, rgb, grgb, galpha, bs, is, eps,
                                   out, bstride, accumulate, s);
  if (galpha)
    return launch_out<false, true>(xy, fim, rgb, grgb, galpha, bs, is, eps,
                                   out, bstride, accumulate, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
