// Per-face reduction of the rasterizer backward's fused per-pixel channel
// stack for Hopper (sm_90a), with the K6 texture-cell expansion inside.
//
// Replaces the TPU kernel backward_pallas._csr_kernel
// (neural_renderer_tpu/rasterize/backward_pallas.py) and the segment_sum
// that followed it (core.py:567-689): per face, the sum over the pixels it
// won of every channel of the stack [bs, C, is, is] (channel-leading).  The
// last ts^2 + ts + 3 channels may be K6 factors (texture.
// texture_cell_factors: p01[ts^2], a2[ts], g[3]); they leave as ts^3 * 3
// cell columns, (i01 * ts + c2) * 3 + ch holding (p01[i01] * a2[c2]) *
// g[ch], the multiply order of texture.texture_channels_cells.  At ts 2 with
// the 12 K5 channels: 21 channels in, 36 columns out.
//
// What bounds it on this card.  The bytes: each covered pixel's C channels
// read once (at batch 32 on a 512^2 raster ~1 M covered pixels x 21 channels,
// 85 MB), the [bs * nf, C_out] result written once, and here a partial row
// per (tile, face) pair written and read once (~257 k pairs x 36 columns,
// 37 MB): ~0.05 ms at 3.35 TB/s.  A face wins ~6 pixels on average, so a
// design that gives each face a warp, or gathers a pixel's channels from C
// scattered planes, is bound by latency instead.
//
// Design: two passes, no sort of the raster and no float atomics.  The
// forward binned the faces into per-(batch, 16x16 tile) lists in ascending
// id order (forward_cuda.bin_faces); every covered pixel's winner is in its
// tile's list, because the forward chose it from there.
//   1. Tile pass, one block per (batch, tile) with a non-empty list.  Each
//      thread owns one pixel: it finds its winner's slot k in the tile's list
//      by binary search and stages its C channels in shared memory (rows of
//      16 pixels, 64 B per plane; uncovered pixels read nothing).  A stable
//      block radix sort (CUB's BlockRadixSort, a building block inside this
//      kernel) orders the pixels by (k, pixel), so each slot's pixels are one
//      run, which a thread per slot finds by binary search.  Then each
//      thread keeps one output column and takes every kThreads / C_out-th
//      slot: it sums the slot's pixels in pixel order, expanding the K6
//      factors, into row order[start + k] of a [pairs, C_out] buffer, the
//      pair's row in face-major order (consecutive threads write
//      consecutive columns).
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
// Numerics.  The K6 products keep the plain operand order; the sums run per
// tile in pixel order and then over the face's tiles, another order than
// torch's index_add_, so the result is held to 1e-4 x the column's max
// |value| (SUM_TOL of chip_smoke.py).
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

using PixelSort = cub::BlockRadixSort<unsigned, kThreads, 1, int>;

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

__global__ void __launch_bounds__(kThreads)
face_reduce_tile_kernel(const float* __restrict__ stack,
                        const int* __restrict__ fim,
                        const int* __restrict__ start,
                        const int* __restrict__ ids,
                        const int* __restrict__ order, int nt, int is, int C,
                        int c_base, int ts, int c_out,
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
  const float* src = stack + (size_t)b * C * plane + (size_t)y * is + x;
#pragma unroll 4
  for (int c = 0; c < C; ++c)
    s_val[c * kPad + tid] = covered ? __ldg(src + c * plane) : 0.0f;
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

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int nr_face_reduce_tile() { return kTile; }

// Launches both passes on `stream`; returns cudaGetLastError() (0 on
// success).  stack [bs, C, is, is] contiguous; fim [bs, is, is] int32; the
// forward's tile lists at kTile: start [bs * nt * nt + 1] and ids [pairs]
// (ascending face ids per tile), order [pairs] (tile-major pair -> its
// face-major row) and first [bs * nf + 1] (each face's first face-major
// row); partial [pairs, c_out] scratch; out [bs * nf, c_out] with c_out = C
// when ts == 0, else C - (ts^2 + ts + 3) + ts^3 * 3.
int nr_face_reduce(const float* stack, const int* fim, const int* start,
                   const int* ids, const int* order, const int* first, int bs,
                   int nf, int is, int C, int ts, float* partial, float* out,
                   void* stream) {
  const int naux = ts > 0 ? ts * ts + ts + 3 : 0;
  const int c_base = C - naux;
  const int c_out = c_base + (ts > 0 ? ts * ts * ts * 3 : 0);
  if (c_base < 0 || c_out <= 0) return (int)cudaErrorInvalidValue;
  const int nseg = bs * nf;
  if (nseg == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int nt = (is + kTile - 1) / kTile;
  // the staged channels beside the sort's static storage may pass 48 KB:
  // raise the tile pass's limit to all the device allows, once per device
  const size_t smem = (size_t)C * kPad * sizeof(float);
  static std::atomic<int> raised[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev].load()) {
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, face_reduce_tile_kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(face_reduce_tile_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)attr.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    raised[dev].store(1);
  }
  face_reduce_tile_kernel<<<dim3(nt * nt, bs), kThreads, smem, s>>>(
      stack, fim, start, ids, order, nt, is, C, c_base, ts, c_out, partial);
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
