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
// What bounds it on this card.  It reads each covered pixel's channels
// once per group of 16 output columns (the factors again from L1) and
// writes [bs * nf, C_out]: at batch 32 on a 512^2 raster a few hundred MB
// of reads at most, gathered rather than streamed, so latency-bound on the
// gathers of small faces.
//
// Design.  The host side (backward_cuda.py, plain PyTorch) sorts the
// covered pixels by (batch, face) with a stable sort, so every face's
// pixels form one run in ascending pixel order, and passes the run starts.
// One warp per face walks its run, lane l taking pixels l, l + 32, ...;
// each lane keeps 16 column sums in registers, adds its pixels in order,
// and the warp reduces with a fixed shuffle tree.  No float atomics: the
// same inputs give the same bits on every run.  There is no capacity limit
// (the TPU kernel's row budget and kmax sentinel have no counterpart), and
// a face that wins no pixel gets exact zeros.  Uncovered pixels are never
// read.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 16;          // output columns per pass over a run

__global__ void __launch_bounds__(kThreads)
face_reduce_kernel(const float* __restrict__ stack,
                   const int* __restrict__ order,
                   const int* __restrict__ start, int nseg, int nf,
                   long long plane, int C, int c_base, int ts, int c_out,
                   float* __restrict__ out) {
  const int seg = (int)(((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= nseg) return;
  const int b = seg / nf;
  const int begin = start[seg];
  const int end = start[seg + 1];
  const float* base = stack + (size_t)b * C * plane;
  const size_t first_pixel = (size_t)b * plane;
  const int n01 = ts * ts;

  for (int col0 = 0; col0 < c_out; col0 += kCols) {
    // source channels of this pass's columns: pass-through (ca) or
    // (p01, a2, g) of an expanded K6 cell
    int ca[kCols], cb[kCols], cc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int col = min(col0 + k, c_out - 1);
      if (col < c_base) {
        ca[k] = col; cb[k] = -1; cc[k] = -1;
      } else {
        const int j = col - c_base;
        const int cell = j / 3;
        ca[k] = c_base + cell / ts;                 // p01[i01]
        cb[k] = c_base + n01 + cell % ts;           // a2[c2]
        cc[k] = c_base + n01 + ts + j % 3;          // g[ch]
      }
    }
    float acc[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
    for (int i = begin + lane; i < end; i += 32) {
      const float* px = base + ((size_t)order[i] - first_pixel);
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        float v = __ldg(px + ca[k] * plane);
        if (cb[k] >= 0)
          v = (v * __ldg(px + cb[k] * plane)) * __ldg(px + cc[k] * plane);
        acc[k] = acc[k] + v;
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] = acc[k] + __shfl_down_sync(0xffffffffu, acc[k], off);
    }
    if (lane == 0) {
      float* o = out + (size_t)seg * c_out;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (col0 + k < c_out) o[col0 + k] = acc[k];
    }
  }
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// stack [bs, C, is, is] contiguous; order [n] int32 flat pixel indices over
// [bs, is, is], sorted by face; start [bs * nf + 1] int32 run starts into
// order; out [bs * nf, c_out] with c_out = C when ts == 0, else
// C - (ts^2 + ts + 3) + ts^3 * 3.
int nr_face_reduce(const float* stack, const int* order, const int* start,
                   int bs, int nf, int is, int C, int ts, float* out,
                   void* stream) {
  const int naux = ts > 0 ? ts * ts + ts + 3 : 0;
  const int c_base = C - naux;
  const int c_out = c_base + (ts > 0 ? ts * ts * ts * 3 : 0);
  if (c_base < 0 || c_out <= 0) return (int)cudaErrorInvalidValue;
  const int nseg = bs * nf;
  if (nseg == 0) return (int)cudaSuccess;
  const int warps_per_block = kThreads / 32;
  const unsigned blocks = (unsigned)((nseg + warps_per_block - 1) /
                                     warps_per_block);
  face_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      stack, order, start, nseg, nf, (long long)is * is, C, c_base, ts,
      c_out, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
