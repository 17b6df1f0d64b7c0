// Shaded rasterizer forward for Hopper (sm_90a): binned z-buffer, winner
// attributes and fused K4 trilinear texture shading, in one kernel.
//
// Replaces the TPU kernel forward_pallas._shaded_kernel
// (neural_renderer_tpu/rasterize/forward_pallas.py), forward outputs only:
// face_index_map, depth, weights[3], the winner's NDC xy[6] and z[3], and
// rgb for texture cubes with ts <= 4.
//
// What bounds it on this card: its output.  Each pixel writes 17 words
// (index, depth, weights[3], xy[6], z[3], rgb[3]); at batch 32 on a 512^2
// raster that is 570 MB, 0.17 ms at 3.35 TB/s, and the kernel was measured
// at 0.24 ms there (H100 80GB HBM3, 700 W).  The z test is ~15 f32
// operations per (pixel, binned face) pair that fails the edge tests and
// ~40 for one that passes, read from a shared-memory broadcast; binning by
// 16x16 tile leaves few enough pairs that this stays well under the write
// time.  Reads are small: per block one pass over its tile's face list (72
// bytes a face), per pixel the winner's record and its texels.  The design
// therefore does nothing clever about compute: one thread per pixel writes
// each output plane with coalesced stores.
//
// Design.  One block per (batch, 16x16 tile) runs the binned z-buffer
// loop of zbuffer.cuh (the tile's CSR face list staged in shared memory, a
// running (zmin, winner) per pixel thread, no capacity); the finalize then
// reads the winner's record and texels with direct global loads.  The TPU
// kernel's one-hot MXU fetches, lane rolls, VMEM face table,
// scalar-prefetched schedule and strip staging have no counterpart here.
//
// Numerics.  Every expression repeats the operand order of the plain
// PyTorch version (forward_dense.py, texture.py), which follows the
// reference; zbuffer.cuh says why the build uses --fmad=false and never
// --use_fast_math.

#include <cuda_runtime.h>

#include "zbuffer.cuh"

namespace {

// TS: texture cube size for fused shading (2..4), 0 for maps only.
template <int TS>
__global__ void __launch_bounds__(kThreads)
shaded_kernel(const float* __restrict__ rec, const int* __restrict__ start,
              const int* __restrict__ ids, const float* __restrict__ tex,
              int nf, int is, int nt, float near, float far, float tif_max,
              int* __restrict__ idx_out, float* __restrict__ depth_out,
              float* __restrict__ w_out, float* __restrict__ xy_out,
              float* __restrict__ z_out, float* __restrict__ rgb_out) {
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
  const float* face_base = rec + (size_t)b * nf * kRec;

  float zmin;
  const int win = zbuffer_tile(face_base, ids, start[tile], start[tile + 1],
                               tid, fx, fy, xp, yp, near, far, s_face, s_id,
                               zmin);

  if (xi >= is || yi >= is) return;
  const size_t plane = (size_t)is * is;
  const size_t p = (size_t)yi * is + xi;
  idx_out[b * plane + p] = win;
  if (win < 0) {
    depth_out[b * plane + p] = far;
    for (int k = 0; k < 3; ++k) {
      w_out[(b * 3 + k) * plane + p] = 0.0f;
      z_out[(b * 3 + k) * plane + p] = 0.0f;
    }
    for (int k = 0; k < 6; ++k) xy_out[(b * 6 + k) * plane + p] = 0.0f;
    if (TS > 0)
      for (int c = 0; c < 3; ++c) rgb_out[(b * 3 + c) * plane + p] = 0.0f;
    return;
  }

  // winner attributes: clamp -> renormalize -> zp (forward_dense.
  // winner_attributes, reference rasterize.py:317-330)
  const float* r = face_base + (size_t)win * kRec;
  float z[3], w[3];
  for (int k = 0; k < 3; ++k) {
    z[k] = r[6 + k];
    w[k] = clip01(r[9 + 3 * k] * fx + r[10 + 3 * k] * fy + r[11 + 3 * k]);
  }
  const float wsum = w[0] + w[1] + w[2];
  for (int k = 0; k < 3; ++k) w[k] = w[k] / wsum;
  const float zp = 1.0f / (w[0] / z[0] + w[1] / z[1] + w[2] / z[2]);

  depth_out[b * plane + p] = zp;
  for (int k = 0; k < 3; ++k) {
    w_out[(b * 3 + k) * plane + p] = w[k];
    z_out[(b * 3 + k) * plane + p] = z[k];
  }
  for (int k = 0; k < 6; ++k) xy_out[(b * 6 + k) * plane + p] = r[k];

  if (TS > 0) {
    // K4 8-corner trilinear (texture.sample_textures, reference
    // rasterize.py:398-425); NaN-preserving clamps like torch.clamp
    float fr[3];
    int lo[3];
    for (int k = 0; k < 3; ++k) {
      float t = (w[k] * (float)(TS - 1)) * (zp / z[k]);
      t = t < 0.0f ? 0.0f : t;
      t = t > tif_max ? tif_max : t;
      const int l = min(max((int)t, 0), TS - 2);
      lo[k] = l;
      fr[k] = t - (float)l;
    }
    const float* cube = tex + ((size_t)b * nf + win) * (TS * TS * TS * 3);
    float rgb[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int pn = 0; pn < 8; ++pn) {
      float cw = 1.0f;
      int ii[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int bit = (pn >> k) & 1;
        cw = cw * (bit ? fr[k] : (1.0f - fr[k]));
        ii[k] = lo[k] + bit;
      }
      const int isc = ii[0] * TS * TS + ii[1] * TS + ii[2];
      for (int c = 0; c < 3; ++c) rgb[c] = rgb[c] + cw * cube[isc * 3 + c];
    }
    for (int c = 0; c < 3; ++c) rgb_out[(b * 3 + c) * plane + p] = rgb[c];
  }
}

}  // namespace

extern "C" {

int nr_forward_shaded_tile() { return kTile; }

int nr_forward_shaded_record() { return kRec; }

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// rec [bs, nf, 18] f32; start [bs * nt * nt + 1] i32; ids [start[-1]] i32;
// tex [bs, nf, ts, ts, ts, 3] f32 (ignored for ts == 0); outputs idx/depth
// [bs, is, is], w/z/rgb [bs, 3, is, is], xy [bs, 6, is, is].
int nr_forward_shaded(const float* rec, const int* start, const int* ids,
                      const float* tex, int bs, int nf, int is, int ts,
                      float near, float far, float tif_max, int* idx,
                      float* depth, float* w, float* xy, float* z,
                      float* rgb, void* stream) {
  const int nt = (is + kTile - 1) / kTile;
  const dim3 grid(nt, nt, bs);
  const dim3 block(kTile, kTile);
  cudaStream_t s = (cudaStream_t)stream;
  switch (ts) {
    case 0:
      shaded_kernel<0><<<grid, block, 0, s>>>(rec, start, ids, tex, nf, is,
                                              nt, near, far, tif_max, idx,
                                              depth, w, xy, z, rgb);
      break;
    case 2:
      shaded_kernel<2><<<grid, block, 0, s>>>(rec, start, ids, tex, nf, is,
                                              nt, near, far, tif_max, idx,
                                              depth, w, xy, z, rgb);
      break;
    case 3:
      shaded_kernel<3><<<grid, block, 0, s>>>(rec, start, ids, tex, nf, is,
                                              nt, near, far, tif_max, idx,
                                              depth, w, xy, z, rgb);
      break;
    case 4:
      shaded_kernel<4><<<grid, block, 0, s>>>(rec, start, ids, tex, nf, is,
                                              nt, near, far, tif_max, idx,
                                              depth, w, xy, z, rgb);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
