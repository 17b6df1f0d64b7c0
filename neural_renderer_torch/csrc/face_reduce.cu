// Per-face reduction of the rasterizer backward's fused per-pixel channel
// stack for Hopper (sm_90a), with the K6 texture factors built and expanded
// inside.
//
// Replaces the TPU kernel backward_pallas._csr_kernel
// (neural_renderer_tpu/rasterize/backward_pallas.py) and the segment_sum
// that followed it (core.py:567-689): per face, the sum over the pixels it
// won of every channel of the stack [bs, C, is, is] (channel-leading: the
// K5 and K7 channels), and, where textures of ts <= 4 get a gradient, of
// the K6 texture cells: ts^3 * 3 columns after the stack's, (i01 * ts + c2)
// * 3 + ch holding (p01[i01] * a2[c2]) * g[ch], the factors and multiply
// order of texture.texture_cell_factors and texture_channels_cells.  At
// ts 2 with the 12 K5 channels: 36 columns out.
//
// The K6 factors are not read from device memory: the tile pass builds
// them for each covered pixel from the forward's maps (z, weights and
// depth_map, and the rgb gradient: 10 words a pixel), into the same shared
// rows the stack's channels are staged in.  Built in plain torch they were
// ts^2 + ts + 3 planes over every raster pixel (23 at ts 4, 3.09 GB at
// bs 128 on a 512^2 raster, in about 70 elementwise launches), of which
// this pass read only the covered eighth.  A compile-time switch (kK6)
// keeps the factor code out of the pass that reduces no texture cells.
//
// What bounds it on this card.  The bytes: each covered pixel's C channels
// and map words read once (at batch 32 on a 512^2 raster ~1 M covered
// pixels x 22 words, 88 MB), the [bs * nf, C_out] result written once, and
// here a partial row per (tile, face) pair written and read once (~257 k
// pairs x 36 columns, 37 MB): ~0.05 ms at 3.35 TB/s.  A face wins ~6
// pixels on average, so a design that gives each face a warp, or gathers a
// pixel's channels from C scattered planes, is bound by latency instead.
//
// Design: two passes, no sort of the raster and no float atomics.  The
// forward binned the faces into per-(batch, 16x16 tile) lists in ascending
// id order (forward_cuda.bin_faces); every covered pixel's winner is in its
// tile's list, because the forward chose it from there.
//   1. Tile pass, one block per (batch, tile) with a non-empty list.  Each
//      thread owns one pixel: it finds its winner's slot k in the tile's list
//      by binary search and stages its C channels in shared memory (rows of
//      16 pixels, 64 B per plane; uncovered pixels read nothing), then, in
//      the kK6 instance, its K6 factors after them (zeros where uncovered).
//      A stable block radix sort (CUB's BlockRadixSort, a building block
//      inside this kernel) orders the pixels by (k, pixel), so each slot's
//      pixels are one run, which a thread per slot finds by binary search.
//      Then each thread keeps one output column and takes every
//      kThreads / C_out-th slot: it sums the slot's pixels in pixel order,
//      expanding the K6 factors, into row order[start + k] of a
//      [pairs, C_out] buffer, the pair's row in face-major order
//      (consecutive threads write consecutive columns).
//      Slots that won no pixel get zero rows.
//   2. Face pass, one warp per face, lanes over columns: the sum of the
//      face's contiguous partial rows first[f] .. first[f + 1], in tile
//      order.  A face with no pair, or only zero rows, gets exact zeros.
// Both orders are fixed by the inputs, so every run gives the same bits.
// There is no capacity (the TPU kernel's row budget and kmax sentinel have no
// counterpart).  No wgmma or TMA: there is no matrix product here (the TPU
// kernel's one-hot contractions stood in for the scatter), and a tile's
// staging is a few KB of row loads.
//
// Numerics.  The factors equal texture_cell_factors' on the card bit for
// bit: the same operations in the same order, each rounded alone (the
// library builds with --fmad=false), the division IEEE, the clamps keeping
// NaN as torch.clamp does.  The K6 products keep the plain operand order;
// the sums run per tile in pixel order and then over the face's tiles,
// another order than torch's index_add_, so the result is held to 1e-4 x
// the column's max |value| (SUM_TOL of chip_smoke.py).
//
// The face gradient's assembly (nr_face_grad, face_grad_kernel) rides in
// this library: it reads the face pass's output.  Its note is above the
// kernel.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kTile = 16;          // the forward's tile edge (zbuffer.cuh)
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kPad = kThreads + 1; // words per staged channel: lanes that
                                   // read other channels of one pixel hit
                                   // other banks
constexpr int kMaxTs = 4;          // the largest cube whose factors the
                                   // tile pass builds

using PixelSort = cub::BlockRadixSort<unsigned, kThreads, 1, int>;

// What the K6 factors are built from: the forward's z and weights
// [bs, 3, is, is], depth_map (as [bs, 1, is, is]) and the rgb gradient (as
// its [bs, 3, is, is] permutation), each with its element strides.
struct K6Maps {
  const float* z;
  const float* w;
  const float* d;
  const float* g;
  long long zs[4], ws[4], ds[4], gs[4];
  float hi;  // the clamp's upper limit, ts - 1 - eps rounded to float
};

__device__ __forceinline__ float map_at(const float* p, const long long* s,
                                        int b, int c, int y, int x) {
  return __ldg(p + b * s[0] + c * s[1] + y * s[2] + x * s[3]);
}

// A covered pixel's ts^2 + ts + 3 K6 factors into shared rows dst[0],
// dst[kPad], ..: p01[i0 * ts + i1] = a0[i0] * a1[i1], then a2, then g.
// texture._texture_index_float and _axis_hats, operation for operation:
// tif = (w * (ts - 1)) * (depth / z), clamped at 0, then at hi (NaN kept,
// as torch.clamp keeps it); lo by truncation, frac = tif - lo; the hat of
// an axis at j is (lo == j ? 1 - frac : 0) + (lo + 1 == j ? frac : 0).
__device__ __forceinline__ void k6_factors(const K6Maps& m, int b, int y,
                                           int x, int ts, float* dst) {
  const float depth = map_at(m.d, m.ds, b, 0, y, x);
  const float scale = (float)(ts - 1);
  float hat[3][kMaxTs];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float tif = (map_at(m.w, m.ws, b, k, y, x) * scale)
                * (depth / map_at(m.z, m.zs, b, k, y, x));
    if (!isnan(tif)) tif = fmaxf(tif, 0.0f);
    if (!isnan(tif)) tif = fminf(tif, m.hi);
    const int lo = (int)tif;
    const float frac = tif - (float)lo;
#pragma unroll
    for (int j = 0; j < kMaxTs; ++j)
      hat[k][j] = (lo == j ? 1.0f - frac : 0.0f)
                  + (lo + 1 == j ? frac : 0.0f);
  }
#pragma unroll
  for (int i0 = 0; i0 < kMaxTs; ++i0)
#pragma unroll
    for (int i1 = 0; i1 < kMaxTs; ++i1)
      if (i0 < ts && i1 < ts)
        dst[(i0 * ts + i1) * kPad] = hat[0][i0] * hat[1][i1];
#pragma unroll
  for (int j = 0; j < kMaxTs; ++j)
    if (j < ts) dst[(ts * ts + j) * kPad] = hat[2][j];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    dst[(ts * ts + ts + c) * kPad] = map_at(m.g, m.gs, b, c, y, x);
}

// Source channels of output column col: pass-through (ca) or the (p01, a2,
// g) factors of an expanded K6 cell.
__device__ __forceinline__ void column_sources(int col, int c_base, int ts,
                                               int& ca, int& cb, int& cc) {
  if (col < c_base) {
    ca = col;
    cb = -1;
    cc = -1;
    return;
  }
  const int j = col - c_base;
  const int cell = j / 3;
  ca = c_base + cell / ts;                        // p01[i01]
  cb = c_base + ts * ts + cell % ts;              // a2[c2]
  cc = c_base + ts * ts + ts + j % 3;             // g[ch]
}

// C: the staged rows; c_base: the stack's channels (C less the K6
// factors' ts^2 + ts + 3 in the kK6 instance, C in the other).
template <bool kK6>
__global__ void __launch_bounds__(kThreads)
face_reduce_tile_kernel(const float* __restrict__ stack,
                        const int* __restrict__ fim,
                        const int* __restrict__ start,
                        const int* __restrict__ ids,
                        const int* __restrict__ order, int nt, int is, int C,
                        int c_base, int ts, int c_out, K6Maps k6,
                        float* __restrict__ partial) {
  __shared__ PixelSort::TempStorage s_sort;
  __shared__ unsigned s_slot[kThreads];    // the pixels' slots, sorted
  __shared__ int s_pix[kThreads];          // and their pixels
  __shared__ int s_lb[kThreads], s_ub[kThreads], s_row[kThreads];
  extern __shared__ float s_val[];         // [C][kPad] staged channels

  const int b = blockIdx.y;
  const int t = blockIdx.x;                // ty * nt + tx
  const int s0 = start[(size_t)b * nt * nt + t];
  const int n = start[(size_t)b * nt * nt + t + 1] - s0;
  if (n == 0) return;
  const int tid = threadIdx.x;
  const int y = (t / nt) * kTile + tid / kTile;
  const int x = (t % nt) * kTile + tid % kTile;
  const size_t plane = (size_t)is * is;

  // the pixel's slot in the tile's ascending list (n: uncovered)
  int k = n;
  if (y < is && x < is) {
    const int w = fim[(size_t)b * plane + (size_t)y * is + x];
    if (w >= 0) {
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ids[s0 + mid] < w) lo = mid + 1; else hi = mid;
      }
      k = lo;
    }
  }
  const bool covered = k < n;
  const int c_stack = kK6 ? c_base : C;
  const float* src = stack + (size_t)b * c_stack * plane + (size_t)y * is + x;
#pragma unroll 4
  for (int c = 0; c < c_stack; ++c)
    s_val[c * kPad + tid] = covered ? __ldg(src + c * plane) : 0.0f;
  if (kK6) {
    float* dst = s_val + c_base * kPad + tid;
    if (covered) {
      k6_factors(k6, b, y, x, ts, dst);
    } else {
      for (int j = 0; j < C - c_base; ++j) dst[j * kPad] = 0.0f;
    }
  }
  const int ncov = __syncthreads_count(covered);
  if (ncov > 0) {
    unsigned key[1] = {(unsigned)k};
    int pix[1] = {tid};
    PixelSort(s_sort).Sort(key, pix, 0, 32 - __clz(n));
    s_slot[tid] = key[0];
    s_pix[tid] = pix[0];
    __syncthreads();
  }

  // the slots' rows, up to kThreads at a time: each thread finds one slot's
  // pixels s_pix[lb .. ub), then the block sums (row, column) pairs
  for (int base = 0; base < n; base += kThreads) {
    const int rows = min(kThreads, n - base);
    if (tid < rows) {
      const int kk = base + tid;
      int lb = 0, hi = ncov;
      while (lb < hi) {
        const int mid = (lb + hi) >> 1;
        if ((int)s_slot[mid] < kk) lb = mid + 1; else hi = mid;
      }
      int ub = lb;
      hi = ncov;
      while (ub < hi) {
        const int mid = (ub + hi) >> 1;
        if ((int)s_slot[mid] <= kk) ub = mid + 1; else hi = mid;
      }
      s_lb[tid] = lb;
      s_ub[tid] = ub;
      s_row[tid] = order[s0 + kk];
    }
    __syncthreads();
    // thread tid keeps column tid % c_out (and the next ones past kThreads)
    // of every group-th row: consecutive threads write consecutive columns
    const int groups = max(1, kThreads / c_out);
    if (tid < groups * c_out) {
      for (int col = tid % c_out; col < c_out; col += kThreads) {
        int ca, cb, cc;
        column_sources(col, c_base, ts, ca, cb, cc);
        for (int kk = tid / c_out; kk < rows; kk += groups) {
          float acc = 0.0f;
          for (int i = s_lb[kk]; i < s_ub[kk]; ++i) {
            const int p = s_pix[i];
            float v = s_val[ca * kPad + p];
            if (cb >= 0)
              v = (v * s_val[cb * kPad + p]) * s_val[cc * kPad + p];
            acc = acc + v;
          }
          partial[(size_t)s_row[kk] * c_out + col] = acc;
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
face_reduce_face_kernel(const float* __restrict__ partial,
                        const int* __restrict__ first, int nseg, int c_out,
                        float* __restrict__ out) {
  const int seg = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= nseg) return;
  const int r0 = first[seg];
  const int r1 = first[seg + 1];
  for (int col = lane; col < c_out; col += 32) {
    float acc = 0.0f;
    for (int r = r0; r < r1; ++r)
      acc = acc + partial[(size_t)r * c_out + col];
    out[(size_t)seg * c_out + col] = acc;
  }
}

// The face gradient's assembly: grad_faces [n, 3, 3] (n = bs * nf faces)
// from the per-face sums [n, c_out] that the face pass writes.
//
// Not a TPU kernel: it replaces the JAX package's XLA scatter of the K5 sums
// to the vertex slots (neural_renderer_tpu/rasterize/backward.py:540-565,
// scatter_pixel_channels) and the K7 add after it.  Entry (v, c) of face r:
//   c < 2:  (0 + (s[r, 2 ch0] + s[r, 2 ch1 + 1])) + s[r, k7_off + 3 v + c]
//   c = 2:  0 + s[r, k7_off + 3 v + 2]
// with ch0 = 3 (1 - c) + v and ch1 = 3 (1 - c) + (v + 2) % 3, the (edge,
// axis) walks of _EA in rasterize/backward.py (K5_SLOTS there); the K5 term
// only where k5 is set, the K7 term only where k7_off >= 0.  The leading
// 0 + is the plain version's add onto zeros: -0 becomes +0.  Every add is
// rounded alone (__fadd_rn), in that order, so the result equals
// rasterize/backward_cuda.face_grad_plain bit for bit.
//
// What bounds it: the bytes.  Each face's row of sums is read once (48 B of
// K5 sums, 36 B more of K7 where depth is drawn; the K6 cells behind them
// are not read) and 36 B are written: at bs 128 x 163,840 faces with c_out
// 12, 1.76 GB, 0.526 ms at 3.35 TB/s.  In plain torch the same entries
// took about a dozen passes over the face set and a stack that wrote 4
// bytes at a 36-byte stride.
// Design: a thread per output entry, consecutive threads on consecutive
// entries, so a warp's stores are one contiguous 128-byte run and its loads
// fall in the 3 to 5 consecutive rows of its faces (rows at any stride
// row_stride >= the columns read); the second K5 load finds its sectors in
// L1.  A grid-stride loop covers the 9 n entries, from the teapot step's
// 630,784 faces to the icosphere step's 20,971,520.  No shared memory and
// no atomics: each entry is written once by one thread.
__global__ void __launch_bounds__(kThreads)
face_grad_kernel(const float* __restrict__ sums, long long row_stride,
                 long long entries, int k5, int k7_off,
                 float* __restrict__ out) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < entries; i += step) {
    const long long r = i / 9;
    const int j = (int)(i - r * 9);
    const int v = j / 3;
    const int c = j - 3 * v;
    const float* row = sums + r * row_stride;
    float acc = 0.0f;
    if (k5 && c < 2) {
      const int ch0 = 3 * (1 - c) + v;
      const int ch1 = 3 * (1 - c) + (v + 2) % 3;
      acc = __fadd_rn(0.0f, __fadd_rn(__ldg(row + 2 * ch0),
                                      __ldg(row + 2 * ch1 + 1)));
    }
    if (k7_off >= 0) acc = __fadd_rn(acc, __ldg(row + k7_off + j));
    out[i] = acc;
  }
}

// The staged channels beside the sort's static storage may pass 48 KB:
// raise the tile pass's limit to all the device allows, once per device
// and instance.
template <bool kK6>
cudaError_t raise_tile_smem() {
  static std::atomic<int> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (raised[dev].load()) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes attr;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, face_reduce_tile_kernel<kK6>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(face_reduce_tile_kernel<kK6>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  if (err == cudaSuccess) raised[dev].store(1);
  return err;
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int nr_face_reduce_tile() { return kTile; }

// Launches both passes on `stream`; returns cudaGetLastError() (0 on
// success).  stack [bs, C, is, is] contiguous (C may be 0 where ts > 0);
// fim [bs, is, is] int32; the forward's tile lists at kTile: start
// [bs * nt * nt + 1] and ids [pairs] (ascending face ids per tile), order
// [pairs] (tile-major pair -> its face-major row) and first [bs * nf + 1]
// (each face's first face-major row); where 0 < ts <= kMaxTs, maps: the
// device addresses of z, weights, depth_map and the rgb gradient, strides:
// their 4 element strides each, in that order (K6Maps), hi: the clamp's
// upper limit (null, null and unread where ts == 0); partial [pairs, c_out]
// scratch; out [bs * nf, c_out] with c_out = C + ts^3 * 3 (C where ts == 0).
int nr_face_reduce(const float* stack, const int* fim, const int* start,
                   const int* ids, const int* order, const int* first, int bs,
                   int nf, int is, int C, int ts, const float* const* maps,
                   const long long* strides, float hi, float* partial,
                   float* out, void* stream) {
  const int naux = ts > 0 ? ts * ts + ts + 3 : 0;
  const int staged = C + naux;
  const int c_out = C + (ts > 0 ? ts * ts * ts * 3 : 0);
  if (C < 0 || ts < 0 || ts > kMaxTs || c_out <= 0
      || (ts > 0 && (maps == nullptr || strides == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int nseg = bs * nf;
  if (nseg == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = (is + kTile - 1) / kTile;
  const size_t smem = (size_t)staged * kPad * sizeof(float);
  const dim3 grid(nt * nt, bs);
  K6Maps k6{};
  cudaError_t err;
  if (ts > 0) {
    k6.z = maps[0];
    k6.w = maps[1];
    k6.d = maps[2];
    k6.g = maps[3];
    for (int i = 0; i < 4; ++i) {
      k6.zs[i] = strides[i];
      k6.ws[i] = strides[4 + i];
      k6.ds[i] = strides[8 + i];
      k6.gs[i] = strides[12 + i];
    }
    k6.hi = hi;
    err = raise_tile_smem<true>();
    if (err != cudaSuccess) return (int)err;
    face_reduce_tile_kernel<true><<<grid, kThreads, smem, s>>>(
        stack, fim, start, ids, order, nt, is, staged, C, ts, c_out, k6,
        partial);
  } else {
    err = raise_tile_smem<false>();
    if (err != cudaSuccess) return (int)err;
    face_reduce_tile_kernel<false><<<grid, kThreads, smem, s>>>(
        stack, fim, start, ids, order, nt, is, C, C, 0, c_out, k6, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((nseg + kWarps - 1) / kWarps);
  face_reduce_face_kernel<<<blocks, kThreads, 0, s>>>(partial, first, nseg,
                                                      c_out, out);
  return (int)cudaGetLastError();
}

// Launches the face gradient's assembly on `stream`; returns
// cudaGetLastError() (0 on success).  sums [faces, >= the columns read]
// float32 with unit column stride and row_stride elements between rows;
// k5: columns 0-11 hold the K5 sums; k7_off: the first of the 9 K7
// columns, or -1 for none; out [faces, 9] contiguous.
int nr_face_grad(const float* sums, long long row_stride, long long faces,
                 int k5, int k7_off, float* out, void* stream) {
  if (faces < 0 || k7_off < -1) return (int)cudaErrorInvalidValue;
  if (faces == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long entries = faces * 9;
  // a few waves of resident blocks (8 of kThreads threads an SM)
  const long long want = (entries + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 32;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  face_grad_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sums, row_stride, entries, k5, k7_off, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
