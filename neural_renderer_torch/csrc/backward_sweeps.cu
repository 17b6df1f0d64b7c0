// K5 sweeps of the rasterizer's approximate backward for Hopper (sm_90a):
// the in-sweep and the out-sweep of the pixel-centric vertex gradient.
//
// Replace the TPU kernels backward_pallas._kernel (the in-sweep) and
// backward_pallas._outsweep_kernel (the out-sweep)
// (neural_renderer_tpu/rasterize/backward_pallas.py).  Both write channels
// of a channel-leading stack [bs, 12, is, is] in the (edge, axis) order
// _EA of rasterize/backward.py: channel 2 * (a * 3 + e) + k holds term c_k
// of edge e walked along axis a.  The stack may be a channel slice of a
// larger one: consecutive batch rows lie `bstride` floats apart.  rgb and
// grad rgb are read through their strides (the permuted NHWC maps of the
// forward and of autograd need no copy).
//
// What bounds them on this card.  The in-sweep reads ~14 planes (xy 6,
// face ids, rgb 3, grad rgb 3, grad alpha) and writes 12: at batch 32 on a
// 512^2 raster ~870 MB, ~0.26 ms at 3.35 TB/s; its ~400 f32 operations a
// pixel (3 edges x 2 axes of crossing math) stay under that.  The
// out-sweep's work is one pass over the line per active crossing: at the
// main shape ~1 M crossings sweep ~250 M positions, ~17 f32 operations and
// two divisions each (0.06 ms at 67 TFLOP/s), against ~0.2 GB of memory
// traffic (0.06 ms).  What it takes beyond that is latency: a line block
// waits on its line's face ids and faces, its staged planes and its sums'
// read-modify-write, 4 blocks of 8 warps per SM (shared memory and
// registers), and a column line's pixels are one sector each.
//
// Design.  In-sweep: one thread per (batch, pixel) does all 6 (edge, axis)
// walks of its own face and fetches each crossing's out-pixel with a direct
// load (the TPU's lane-roll chain, offset radius and chunk-skip ladder exist
// only because a TPU lacks gathers).  Out-sweep: one block per (line,
// axis, batch); the line is the column x = L for axis 0 and the row y = L
// for axis 1.
//   1. Detect exactly, then compact.  Each thread tests the 3 edges of two
//      consecutive line pixels (their loads issued together) with
//      crossing() in the plain operand order (covered & valid & d1_in ==
//      the pixel's own d1) and the block appends the active (r, e) to a
//      crossing list in shared memory, in ascending (r, e) order, by one
//      block prefix sum.  Each entry carries what is constant along its sweep,
//      computed once: d1_cross, [lo, hi], f0 = (X1-X0)/(X1-d0) * 2/is,
//      f1 = (X1-X0)/(d0-X0) * 2/is and the flags X1 != d0, X0 != d0.  A
//      line with no active crossing stops here (in accumulate mode it
//      writes nothing).
//   2. Only lines that sweep stage alpha, grad alpha, rgb and grad rgb in
//      shared memory, as (value, gradient) pairs with 32 zeros before and
//      after the line (pixel-major rgb gives a column line one sector per
//      pixel for its 3 channels).
//   3. The line's work is cut into items of (crossing, 32 positions of
//      [lo, hi], walked from d1_out toward the border) and the items are
//      split into 8 equal contiguous ranges, one per warp, so no warp waits
//      for a crowded one.  Per position, dg once, then each term as
//      -dg * (1 / (f * delta + e)) with one approximate reciprocal, where e
//      is +-eps by the sign of f * dir, fixed per crossing because every
//      swept position lies on the dir side of d1_cross; the gate dg > 0 is a
//      select.  The last chunk runs into the staged zeros, where dg is +-0
//      and the gate shuts, so no range mask is needed.  A warp sums each
//      crossing's positions per lane and reduces with a fixed shuffle tree;
//      a crossing whose items two warps share is summed from their partials
//      in warp order.  The split depends only on the inputs, so every run
//      gives the same bits.
//   4. The block adds all crossings' sums to `out` at once, a thread per
//      crossing, whose old values it fetched before the sweep, so no warp
//      waits on a read-modify-write of device memory.
// There is no capacity (no row cap, schedule or budget): the list holds
// the 3 * is crossings a line can have (is <= 2504 at 227 KB of shared
// memory, rgb and alpha drawn).  No wgmma or TMA: there is no matrix
// product here (the TPU kernel's one-hot contractions stood in for gathers),
// and a line's planes are a few KB that plain loads stage.
//
// Numerics.  Every expression that decides whether a term exists (the
// crossing, d1_in == d1, lo and hi, the in-sweep's interval and gate) repeats
// the operand order of the plain PyTorch version (rasterize/backward.py),
// which follows the JAX package and the reference: build with --fmad=false
// and without fast math, so the in-sweep agrees with the plain version bit
// for bit (a contracted multiply-add could flip a dg > 0 gate or a
// d1_in == d1 test).  min/max propagate NaN as torch.minimum/maximum do.
// The out-sweep leaves the plain order in three places: the hoisted factor
// (k * 2 / is) * delta for ((k * delta) * 2) / is, -dg * rcp(dist) by
// __fdividef (2 ulp) for the IEEE division, and its sums (which run from
// d1_out toward the border); the sign that picks +-eps is exact either way.
// Each term moves by a few ulp and the sums run in another order than
// torch.sum, so it is held to 1e-4 x the channel's max |value| (SUM_TOL of
// chip_smoke.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInThreads = 256;
constexpr int kOutThreads = 256;
constexpr int kWarps = kOutThreads / 32;
constexpr int kPer = 2;     // consecutive line pixels a thread detects and
                            // stages at a time, their loads issued together
constexpr unsigned kFull = 0xffffffffu;

// element strides of a [bs, 3, is, is] map
struct Strides {
  long long b, c, y, x;
};

__device__ __forceinline__ long long at(const Strides& s, int b, int c, int y,
                                        int x) {
  return b * s.b + c * s.c + y * s.y + x * s.x;
}

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
// is] through strides rs / gs (RGB), galpha [bs, is, is] (ALPHA); out: 12
// channels per batch row.
template <bool RGB, bool ALPHA>
__global__ void __launch_bounds__(kInThreads)
insweep_kernel(const float* __restrict__ xy, const int* __restrict__ fim,
               const float* __restrict__ rgb, Strides rs,
               const float* __restrict__ grgb, Strides gs,
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
  float rgb_own[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f};
  if (RGB) {
    for (int c = 0; c < 3; ++c) {
      rgb_own[c] = rgb[at(rs, b, c, y, x)];
      g[c] = grgb[at(gs, b, c, y, x)];
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
        const int oy = a == 0 ? od : y;
        const int ox = a == 0 ? x : od;
        float dg = 0.0f;
        if (ALPHA) {
          const float a_out =
              fim[(size_t)b * plane + (size_t)oy * is + ox] >= 0 ? 1.0f : 0.0f;
          dg = dg + (1.0f - a_out) * ga;
        }
        if (RGB) {
          const float t0 = (rgb_own[0] - rgb[at(rs, b, 0, oy, ox)]) * g[0];
          const float t1 = (rgb_own[1] - rgb[at(rs, b, 1, oy, ox)]) * g[1];
          const float t2 = (rgb_own[2] - rgb[at(rs, b, 2, oy, ox)]) * g[2];
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

// Block-wide exclusive prefix sums of two per-thread counts (kOutThreads
// threads): the thread's prefixes and the block's totals.  Ends with a
// barrier, so s_scan can be reused at once.
__device__ __forceinline__ void block_scan2(int v0, int v1, int* s_scan,
                                            int& p0, int& p1, int& t0,
                                            int& t1) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int i0 = v0, i1 = v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u0 = __shfl_up_sync(kFull, i0, off);
    const int u1 = __shfl_up_sync(kFull, i1, off);
    if (lane >= off) {
      i0 += u0;
      i1 += u1;
    }
  }
  if (lane == 31) {
    s_scan[warp] = i0;
    s_scan[kWarps + warp] = i1;
  }
  __syncthreads();
  int w0 = 0, w1 = 0;
  t0 = 0;
  t1 = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int a0 = s_scan[w], a1 = s_scan[kWarps + w];
    if (w < warp) {
      w0 += a0;
      w1 += a1;
    }
    t0 += a0;
    t1 += a1;
  }
  p0 = w0 + i0 - v0;
  p1 = w1 + i1 - v1;
  __syncthreads();
}

// Crossing-list entry key: edge e, the two term flags, the sweep direction,
// the signs of the two eps offsets, the in-pixel r and the first swept
// position q0 (12 bits each, so is <= 4096).
constexpr int kUse0 = 1 << 2, kUse1 = 1 << 3, kUp = 1 << 4;
constexpr int kEps0 = 1 << 5, kEps1 = 1 << 6;
constexpr int kRShift = 7, kQShift = 19, kPosMask = 0xfff;
// zeros staged before and after the line: a sweep runs whole chunks of 32
// positions past its end, where dg is +-0 (or NaN) and the gate stays shut
constexpr int kPad = 32;

// One active crossing's list entry: what is constant along its sweep.
struct Entry {
  int key, items;
  float d1c, f0, f1;
};

__device__ __forceinline__ Entry entry_of(const Walk& w, const Cross& cr,
                                          int r, int e, float d0, float fis) {
  const float d1_limit = cr.dir > 0.0f ? fis - 1.0f : 0.0f;
  const int lo = (int)clamp_lo(tmin(cr.d1_out, d1_limit), 0.0f);
  const int hi = (int)clamp_hi(tmax(cr.d1_out, d1_limit), fis - 1.0f);
  Entry en;
  en.d1c = cr.d1_cross;
  en.f0 = (w.X1 - w.X0) / (w.X1 - d0) * 2.0f / fis;
  en.f1 = (w.X1 - w.X0) / (d0 - w.X0) * 2.0f / fis;
  // every swept position lies on the dir side of d1_cross, so f * delta
  // has the sign of f * dir all along the sweep
  en.key = e | (w.X1 != d0 ? kUse0 : 0) | (w.X0 != d0 ? kUse1 : 0) |
           (cr.dir > 0.0f ? kUp : 0) | (en.f0 * cr.dir > 0.0f ? kEps0 : 0) |
           (en.f1 * cr.dir > 0.0f ? kEps1 : 0) | (r << kRShift) |
           ((cr.dir > 0.0f ? lo : hi) << kQShift);
  en.items = (hi - lo + 32) >> 5;
  return en;
}

// Out-sweep.  One block per (line L, axis a, batch b).  With `accumulate`
// the sums are added to `out` (out = out + sum); otherwise written.
template <bool RGB, bool ALPHA>
__global__ void __launch_bounds__(kOutThreads)
outsweep_kernel(const float* __restrict__ xy, const int* __restrict__ fim,
                const float* __restrict__ rgb, Strides rs,
                const float* __restrict__ grgb, Strides gs,
                const float* __restrict__ galpha, int is, float eps,
                float* __restrict__ out, long long bstride, int accumulate) {
  extern __shared__ float2 smem2[];
  const int cap = 3 * is;              // the most active crossings a line has
  const int span = is + 2 * kPad;      // a staged line with its zeros
  float2* s_v = smem2;                 // (rgb_c, grad rgb_c) [span][3]
  float2* s_ag = s_v + (RGB ? 3 * span : 0);   // (alpha, grad alpha) [span]
  float* s_d1c = (float*)(s_ag + (ALPHA ? span : 0));   // the crossing
  float* s_f0 = s_d1c + cap;           // list: d1_cross, the two hoisted
  float* s_f1 = s_f0 + cap;            // factors (then the two sums),
  int* s_key = (int*)(s_f1 + cap);     // the key,
  int* s_item = s_key + cap;           // the first item, [cap + 1]
  __shared__ int s_scan[2 * kWarps];
  __shared__ int s_seg_c[2 * kWarps];      // shared crossings' partials,
  __shared__ float s_seg_s[4 * kWarps];    // two slots per warp

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
  if (threadIdx.x < 2 * kWarps) s_seg_c[threadIdx.x] = -1;

  // 1. detect the active crossings and append them, (r, e) ascending:
  // thread t tests line pixels r0 .. r0 + kPer - 1 of each group
  int n = 0, nitems = 0;
  for (int base = 0; base < is; base += kPer * kOutThreads) {
    const int r0 = base + kPer * threadIdx.x;
    int win[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      win[j] = r0 + j < is ? fim[(size_t)b * plane + pixel(r0 + j)] : -1;
    float ppx[kPer][3], ppy[kPer][3];
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (win[j] >= 0) load_face(xy_b + pixel(r0 + j), plane, fis, ppx[j],
                                 ppy[j]);
    int bits = 0, cnt = 0, total = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (win[j] < 0) continue;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const Walk w = edge_coords(ppx[j], ppy[j], e, a);
        const Cross cr = crossing(w, a, d0, fis);
        if (!(cr.valid && cr.d1_in == (float)(r0 + j))) continue;
        bits |= 1 << (3 * j + e);
        ++cnt;
        total += entry_of(w, cr, r0 + j, e, d0, fis).items;
      }
    }
    if (!accumulate) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (r0 + j >= is) continue;
        float* o = out + (size_t)b * bstride + pixel(r0 + j);
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          if ((bits >> (3 * j + e)) & 1) continue;
          const int ch = 2 * (a * 3 + e);
          o[ch * plane] = 0.0f;
          o[(ch + 1) * plane] = 0.0f;
        }
      }
    }
    int slot, item, block_cnt, block_items;
    block_scan2(cnt, total, s_scan, slot, item, block_cnt, block_items);
    slot += n;
    item += nitems;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        if (!((bits >> (3 * j + e)) & 1)) continue;
        const Walk w = edge_coords(ppx[j], ppy[j], e, a);
        const Entry en = entry_of(w, crossing(w, a, d0, fis), r0 + j, e, d0,
                                  fis);
        s_key[slot] = en.key;
        s_d1c[slot] = en.d1c;
        s_f0[slot] = en.f0;
        s_f1[slot] = en.f1;
        s_item[slot] = item;
        item += en.items;
        ++slot;
      }
    }
    n += block_cnt;
    nitems += block_items;
  }
  if (n == 0) return;                  // the same n in every thread

  // 2. stage the line's value and gradient planes, zeros around them
  if (threadIdx.x == 0) s_item[n] = nitems;
  for (int i = threadIdx.x; i < 2 * kPad; i += kOutThreads) {
    const int q = i < kPad ? i : is + i;
    if (RGB)
      for (int c = 0; c < 3; ++c) s_v[q * 3 + c] = make_float2(0.0f, 0.0f);
    if (ALPHA) s_ag[q] = make_float2(0.0f, 0.0f);
  }
  for (int base = 0; base < is; base += kPer * kOutThreads) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = base + kPer * threadIdx.x + j;
      if (r >= is) continue;
      const size_t p = pixel(r);
      const int y = a == 0 ? r : L;
      const int x = a == 0 ? L : r;
      if (ALPHA)
        s_ag[kPad + r] = make_float2(
            fim[(size_t)b * plane + p] >= 0 ? 1.0f : 0.0f,
            galpha[(size_t)b * plane + p]);
      if (RGB) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          s_v[(kPad + r) * 3 + c] = make_float2(rgb[at(rs, b, c, y, x)],
                                                grgb[at(gs, b, c, y, x)]);
      }
    }
  }
  __syncthreads();
  // the in-pixel's two channels of crossing threadIdx.x, fetched now so the
  // sweep hides their latency; added to in step 4
  auto out_of = [&](int c) -> float* {
    const int key = s_key[c];
    return out + (size_t)b * bstride + 2 * (a * 3 + (key & 3)) * plane +
           pixel((key >> kRShift) & kPosMask);
  };
  float pre0 = 0.0f, pre1 = 0.0f;
  if (accumulate && threadIdx.x < n) {
    const float* o = out_of(threadIdx.x);
    pre0 = o[0];
    pre1 = o[plane];
  }

  // 3. sweep: warp w takes items [beg, end) of the line's nitems
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int beg = (int)((long long)nitems * warp / kWarps);
  const int end = (int)((long long)nitems * (warp + 1) / kWarps);
  if (beg < end) {
    int c = 0, c_hi = n - 1;           // the crossing of item beg
    while (c < c_hi) {
      const int mid = (c + c_hi + 1) >> 1;
      if (s_item[mid] <= beg) c = mid; else c_hi = mid - 1;
    }
    for (int it = beg; it < end; ++c) {
      const int c_beg = s_item[c];
      const int c_end = s_item[c + 1];
      const int stop = min(end, c_end);
      const int key = s_key[c];
      const int r = (key >> kRShift) & kPosMask;
      const bool use0 = key & kUse0, use1 = key & kUse1;
      const float e0 = (key & kEps0) ? eps : -eps;
      const float e1 = (key & kEps1) ? eps : -eps;
      const float d1c = s_d1c[c], f0 = s_f0[c], f1 = s_f1[c];
      const int step = (key & kUp) ? 32 : -32;
      const float a_in = ALPHA ? s_ag[kPad + r].x : 0.0f;
      float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
      if (RGB) {
        r0 = s_v[(kPad + r) * 3].x;
        r1 = s_v[(kPad + r) * 3 + 1].x;
        r2 = s_v[(kPad + r) * 3 + 2].x;
      }
      // positions q0, q0 +- 1, ... from the crossing's first item on
      int q = ((key >> kQShift) & kPosMask) + (it - c_beg) * step +
              (step > 0 ? lane : -lane);
      float qf = (float)q;
      const float stepf = (float)step;
      float s0 = 0.0f, s1 = 0.0f;
      for (; it < stop; ++it, q += step, qf += stepf) {
        float dg = 0.0f;
        if (ALPHA) {
          const float2 ag = s_ag[kPad + q];
          dg = (ag.x - a_in) * ag.y;
        }
        if (RGB) {
          const float2* v = s_v + (kPad + q) * 3;
          const float2 v0 = v[0], v1 = v[1], v2 = v[2];
          const float t0 = (v0.x - r0) * v0.y;
          const float t1 = (v1.x - r1) * v1.y;
          const float t2 = (v2.x - r2) * v2.y;
          dg = ALPHA ? dg + (t0 + t1 + t2) : t0 + t1 + t2;
        }
        const float delta = qf - d1c;
        const float c0 = __fdividef(-dg, f0 * delta + e0);
        const float c1 = __fdividef(-dg, f1 * delta + e1);
        const bool open = dg > 0.0f;
        s0 = (open && use0) ? s0 + c0 : s0;
        s1 = (open && use1) ? s1 + c1 : s1;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0 = s0 + __shfl_down_sync(kFull, s0, off);
        s1 = s1 + __shfl_down_sync(kFull, s1, off);
      }
      if (lane == 0) {
        if (c_beg >= beg && c_end <= end) {
          // the warp holds the whole crossing, whose factors only it reads
          s_f0[c] = s0;
          s_f1[c] = s1;
        } else {
          // a crossing shared with the warp before (slot 0) or after (1)
          const int i = 2 * warp + (c_beg < beg ? 0 : 1);
          s_seg_c[i] = c;
          s_seg_s[2 * i] = s0;
          s_seg_s[2 * i + 1] = s1;
        }
      }
    }
  }
  __syncthreads();
  // the shared crossings: the thread of each one's first slot adds the
  // partials of its later slots in warp (item) order
  if (threadIdx.x < 2 * kWarps) {
    const int i0 = threadIdx.x;
    const int c = s_seg_c[i0];
    int prev = i0 - 1;
    while (prev >= 0 && s_seg_c[prev] < 0) --prev;
    if (c >= 0 && (prev < 0 || s_seg_c[prev] != c)) {
      float t0 = s_seg_s[2 * i0], t1 = s_seg_s[2 * i0 + 1];
      for (int i = i0 + 1; i < 2 * kWarps; ++i) {
        const int ci = s_seg_c[i];
        if (ci < 0) continue;
        if (ci != c) break;
        t0 = t0 + s_seg_s[2 * i];
        t1 = t1 + s_seg_s[2 * i + 1];
      }
      s_f0[c] = t0;
      s_f1[c] = t1;
    }
  }
  __syncthreads();
  // 4. every crossing's two sums to its in-pixel, all at once
  for (int c = threadIdx.x; c < n; c += kOutThreads) {
    float* o = out_of(c);
    if (!accumulate) {
      o[0] = s_f0[c];
      o[plane] = s_f1[c];
    } else if (c == threadIdx.x) {
      o[0] = pre0 + s_f0[c];
      o[plane] = pre1 + s_f1[c];
    } else {
      o[0] = o[0] + s_f0[c];
      o[plane] = o[plane] + s_f1[c];
    }
  }
}

template <bool RGB, bool ALPHA>
size_t outsweep_smem(int is) {
  // the staged planes with their zeros, 5 words per list entry for 3 * is
  // entries, the item sentinel
  const size_t span = (size_t)is + 2 * kPad;
  return ((RGB ? 3 : 0) + (ALPHA ? 1 : 0)) * span * sizeof(float2) +
         ((size_t)5 * 3 * is + 1) * sizeof(float);
}

Strides strides_of(const long long* s) {
  Strides st = {0, 0, 0, 0};
  if (s) st = {s[0], s[1], s[2], s[3]};
  return st;
}

template <bool RGB, bool ALPHA>
int launch_in(const float* xy, const int* fim, const float* rgb, Strides rs,
              const float* grgb, Strides gs, const float* galpha, int bs,
              int is, float eps, float* out, long long bstride,
              cudaStream_t s) {
  const size_t n = (size_t)bs * is * is;
  const unsigned blocks = (unsigned)((n + kInThreads - 1) / kInThreads);
  insweep_kernel<RGB, ALPHA><<<blocks, kInThreads, 0, s>>>(
      xy, fim, rgb, rs, grgb, gs, galpha, bs, is, eps, out, bstride);
  return (int)cudaGetLastError();
}

template <bool RGB, bool ALPHA>
int launch_out(const float* xy, const int* fim, const float* rgb, Strides rs,
               const float* grgb, Strides gs, const float* galpha, int bs,
               int is, float eps, float* out, long long bstride,
               int accumulate, cudaStream_t s) {
  if (is > kPosMask + 1) return (int)cudaErrorInvalidValue;
  const size_t smem = outsweep_smem<RGB, ALPHA>(is);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        outsweep_kernel<RGB, ALPHA>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(is, 2, bs);
  outsweep_kernel<RGB, ALPHA><<<grid, kOutThreads, smem, s>>>(
      xy, fim, rgb, rs, grgb, gs, galpha, is, eps, out, bstride, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// rgb and grgb are both null (rgb not drawn) or both set, each with its 4
// element strides (batch, channel, y, x) in a host array; galpha is null
// when alpha is not drawn.  out: batch row b's 12 channels start at
// out + b * bstride, each a contiguous is x is plane.
int nr_insweep(const float* xy, const int* fim, const float* rgb,
               const long long* rgb_strides, const float* grgb,
               const long long* grgb_strides, const float* galpha, int bs,
               int is, float eps, float* out, long long bstride,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides rs = strides_of(rgb_strides), gs = strides_of(grgb_strides);
  if (rgb && galpha)
    return launch_in<true, true>(xy, fim, rgb, rs, grgb, gs, galpha, bs, is,
                                 eps, out, bstride, s);
  if (rgb)
    return launch_in<true, false>(xy, fim, rgb, rs, grgb, gs, galpha, bs, is,
                                  eps, out, bstride, s);
  if (galpha)
    return launch_in<false, true>(xy, fim, rgb, rs, grgb, gs, galpha, bs, is,
                                  eps, out, bstride, s);
  return (int)cudaErrorInvalidValue;
}

int nr_outsweep(const float* xy, const int* fim, const float* rgb,
                const long long* rgb_strides, const float* grgb,
                const long long* grgb_strides, const float* galpha, int bs,
                int is, float eps, float* out, long long bstride,
                int accumulate, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Strides rs = strides_of(rgb_strides), gs = strides_of(grgb_strides);
  if (rgb && galpha)
    return launch_out<true, true>(xy, fim, rgb, rs, grgb, gs, galpha, bs, is,
                                  eps, out, bstride, accumulate, s);
  if (rgb)
    return launch_out<true, false>(xy, fim, rgb, rs, grgb, gs, galpha, bs, is,
                                   eps, out, bstride, accumulate, s);
  if (galpha)
    return launch_out<false, true>(xy, fim, rgb, rs, grgb, gs, galpha, bs, is,
                                   eps, out, bstride, accumulate, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
