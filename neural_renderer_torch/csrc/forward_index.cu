// Index-and-depth rasterizer forward for Hopper (sm_90a): the binned
// z-buffer alone, writing per pixel the winning face and its raw depth.
//
// Replaces the TPU kernel forward_pallas._tile_kernel
// (neural_renderer_tpu/rasterize/forward_pallas.py).  For every pixel of
// every batch row it finds the lowest-id front face with the strictly
// smallest perspective depth and writes
//   face_index_map  int32 [bs, is, is], -1 where no face covers the pixel;
//   depth           f32   [bs, is, is], the raw running minimum
//                   zp = wsum / (w0 (1/z0) + w1 (1/z1) + w2 (1/z2)) with
//                   clipped, not renormalized, weights; `far` where
//                   uncovered.
// This depth is the quantity a z test compares, not the renormalized
// winner depth that forward_shaded.cu writes.
//
// What bounds it on this card: the z test.  Its writes are 2 words a pixel
// (67 MB at batch 32 on a 512^2 raster, 0.02 ms at 3.35 TB/s) and its reads
// one pass over each tile's face list (72 bytes a face).  The work is ~15
// f32 operations per (pixel, binned face) pair that fails the edge tests
// and ~40 for one that passes, read from a shared-memory broadcast; the
// pairs are the tile list lengths x 256 pixels, which chip_smoke.py counts
// from the binning and turns into the kernel's compute bound.
//
// Design.  One block per (batch, 16x16 tile) runs the binned z-buffer loop
// of zbuffer.cuh, the shaded kernel's (the tile's CSR face list staged in
// shared memory, a running (zmin, winner) per pixel thread with a strict
// '<', so coincident duplicated faces resolve to the lowest id), and
// nothing after it but two coalesced stores.  A block loops over any list
// length: there is no capacity and no face limit, so the TPU package's face
// slices, multi-pass merge, membership prefix, one-hot MXU fetch, lane
// rolls and strip staging have no counterpart here.
//
// Numerics.  zbuffer.cuh repeats the plain version's (forward_dense.py)
// operand order with the per-face reciprocals 1/z_k, so face index and
// depth agree with it bit for bit; degenerate faces (zeroed face_inv) get
// depth 0/0 = NaN and are rejected, where the plain version culls them.

#include <cuda_runtime.h>

#include "zbuffer.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
index_kernel(const float* __restrict__ rec, const int* __restrict__ start,
             const int* __restrict__ ids, int nf, int is, int nt, float near,
             float far, int* __restrict__ idx_out,
             float* __restrict__ depth_out) {
  __shared__ Face s_face[kThreads];
  __shared__ int s_id[kThreads];

  const int b = blockIdx.z;
  const int tile = (b * nt + blockIdx.y) * nt + blockIdx.x;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int xi = blockIdx.x * kTile + threadIdx.x;
  const int yi = blockIdx.y * kTile + threadIdx.y;
  const float fx = (float)xi;
  const float fy = (float)yi;
  const float fis = (float)is;
  const float xp = (2.0f * fx + 1.0f - fis) / fis;
  const float yp = (2.0f * fy + 1.0f - fis) / fis;

  float zmin;
  const int win = zbuffer_tile(rec + (size_t)b * nf * kRec, ids, start[tile],
                               start[tile + 1], tid, fx, fy, xp, yp, near,
                               far, s_face, s_id, zmin);

  if (xi >= is || yi >= is) return;
  const size_t p = ((size_t)b * is + yi) * is + xi;
  idx_out[p] = win;
  depth_out[p] = win < 0 ? far : zmin;
}

}  // namespace

extern "C" {

int nr_forward_index_tile() { return kTile; }

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rec [bs, nf, 18] f32; start [bs * nt * nt + 1] i32; ids [start[-1]] i32;
// outputs idx i32 and depth f32, both [bs, is, is].
int nr_forward_index(const float* rec, const int* start, const int* ids,
                     int bs, int nf, int is, float near, float far, int* idx,
                     float* depth, void* stream) {
  const int nt = (is + kTile - 1) / kTile;
  const dim3 grid(nt, nt, bs);
  const dim3 block(kTile, kTile);
  index_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      rec, start, ids, nf, is, nt, near, far, idx, depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
