// The binned z-buffer loop of forward_shaded.cu (forward_index.cu has a z
// loop of its own).
//
// One block of kTile x kTile threads owns one screen tile of one batch
// element, one thread per pixel.  bin_faces.cu bins every front face by its
// conservative pixel bbox (+-1 pixel pad) into per-(batch, tile) lists in
// ascending face order, in CSR form.  The block
// stages its tile's list in chunks of kThreads face records in shared
// memory; every thread walks the chunk (all threads read the same record: a
// shared-memory broadcast) and keeps a running (zmin, winner) with a strict
// '<'.  Ascending order plus strict '<' is the reference's sequential
// first-wins rule (rasterize.py:334): coincident faces resolve to the
// lowest id.  A block loops over any list length: there is no capacity and
// no face limit.
//
// Numerics.  Every expression repeats the operand order of the plain
// PyTorch version (forward_dense.py), which follows the reference, with the
// per-face reciprocals 1/z_k: zp = wsum / (w0 (1/z0) + w1 (1/z1) +
// w2 (1/z2)) with clipped, not renormalized, weights.  Build with
// --fmad=false: a fused multiply-add in the edge tests or in
// finv . (x, y, 1) would round differently from the separate PyTorch
// operations and can flip a near-tie z test or an edge pixel.  Never build
// with --use_fast_math: 1/z and wsum/(...) must stay IEEE divisions.
// clip01 lets NaN through, as torch.clamp does; degenerate faces arrive
// with a zeroed face_inv (forward_cuda._face_records), so their depth is
// 0/0 = NaN and the z test rejects them.

#pragma once

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

// The z test of tile list ids[begin:end) at integer pixel (fx, fy), NDC
// pixel center (xp, yp).  Every thread of the block calls it (it
// synchronises); s_face / s_id are the block's kThreads-entry staging
// buffers in shared memory.  Returns the winner (-1 if none) and sets zmin
// to its raw depth (+inf if none).
__device__ __forceinline__ int zbuffer_tile(
    const float* __restrict__ face_base, const int* __restrict__ ids,
    int begin, int end, int tid, float fx, float fy, float xp, float yp,
    float near, float far, Face* s_face, int* s_id, float& zmin) {
  zmin = __int_as_float(0x7f800000);    // +inf
  int win = -1;
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
  return win;
}

}  // namespace
