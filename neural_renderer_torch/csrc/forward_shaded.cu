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
// Design.  The host side (forward_cuda.py, plain PyTorch) bins every front
// face by its conservative pixel bbox (+-1 pixel pad) into per-(batch,
// tile) lists in ascending face order, in CSR form.  One block of
// kTile x kTile threads renders one tile of one batch element, one thread
// per pixel.  The block stages the tile's list in chunks of kThreads face
// records in shared memory; every thread walks the chunk (all threads read
// the same record: a shared-memory broadcast) and keeps a running
// (zmin, winner) with a strict '<'.  Ascending order plus strict '<' is the
// reference's sequential first-wins rule (rasterize.py:334).  A block loops
// over any list length: there is no capacity limit.  The finalize reads the
// winner's record and texels with direct global loads.  The TPU kernel's
// one-hot MXU fetches, lane rolls, VMEM face table, scalar-prefetched
// schedule and strip staging have no counterpart here.
//
// Numerics.  Every expression repeats the operand order of the plain
// PyTorch version (forward_dense.py, texture.py), which follows the
// reference.  Build with --fmad=false: a fused multiply-add in the edge
// tests or in finv . (x, y, 1) would round differently from the separate
// PyTorch operations and can flip a near-tie z test or an edge pixel.
// Never build with --use_fast_math: 1/z and wsum/(...) must stay IEEE
// divisions.  clip() lets NaN through, as torch.clamp does; degenerate
// faces arrive with a zeroed face_inv (forward_cuda._face_records), so
// their z is 0/0 = NaN and the z test rejects them.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;               // tile edge in pixels
constexpr int kThreads = kTile * kTile;
constexpr int kRec = 18;                // x0 y0 x1 y1 x2 y2, z0-2, finv[9]

struct Face {
  float x0, y0, x1, y1, x2, y2;
  float f[9];                           // face_inv rows
  float iz0, iz1, iz2;                  // 1 / z_k
};

__device__ __forceinline__ float clip01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

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

  float zmin = __int_as_float(0x7f800000);   // +inf
  int win = -1;
  const int begin = start[tile];
  const int end = start[tile + 1];
  for (int c0 = begin; c0 < end; c0 += kThreads) {
    const int n = min(kThreads, end - c0);
    __syncthreads();                   // the previous chunk is consumed
    if (tid < n) {
      const int id = ids[c0 + tid];
      const float* r = face_base + (size_t)id * kRec;
      Face f;
      f.x0 = r[0]; f.y0 = r[1]; f.x1 = r[2];
      f.y1 = r[3]; f.x2 = r[4]; f.y2 = r[5];
      f.iz0 = 1.0f / r[6]; f.iz1 = 1.0f / r[7]; f.iz2 = 1.0f / r[8];
#pragma unroll
      for (int k = 0; k < 9; ++k) f.f[k] = r[9 + k];
      s_face[tid] = f;
      s_id[tid] = id;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const Face& f = s_face[j];
      // strict inside test, reference rasterize.py:310-312 operand order
      const bool outside =
          ((yp - f.y0) * (f.x1 - f.x0) < (xp - f.x0) * (f.y1 - f.y0)) |
          ((yp - f.y1) * (f.x2 - f.x1) < (xp - f.x1) * (f.y2 - f.y1)) |
          ((yp - f.y2) * (f.x0 - f.x2) < (xp - f.x2) * (f.y0 - f.y2));
      if (outside) continue;
      const float w0 = clip01(f.f[0] * fx + f.f[1] * fy + f.f[2]);
      const float w1 = clip01(f.f[3] * fx + f.f[4] * fy + f.f[5]);
      const float w2 = clip01(f.f[6] * fx + f.f[7] * fy + f.f[8]);
      const float wsum = w0 + w1 + w2;
      const float zp = wsum / (w0 * f.iz0 + w1 * f.iz1 + w2 * f.iz2);
      if (zp > near && zp < far && zp < zmin) {
        zmin = zp;
        win = s_id[j];
      }
    }
  }

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
