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
// What bounds it on this card: its writes, 2 words a pixel (67 MB at batch
// 32 on a 512^2 raster, 0.022 ms at 3.35 TB/s); the z test's least f32
// operations (15 per binned (pixel, face) pair, 1e9 there) take 0.015 ms.
// In practice it is bound by issued instructions: per-block timestamps of
// kernel variants on an H100 showed the blocks in flight held down by their
// registers and each block's time growing with its list length at the same
// rate per face, whether a thread owned one pixel or four and whether the
// faces were split over warps or over pixels.  So the design spends its
// instructions only on the pixels a face can cover.
//
// Design.  One block of 256 threads per (batch, 16x16 tile), a pixel a
// thread; each warp owns an 8 x 4 block of the tile.
//   * Empty tiles (~83% at the main shape) only write -1 and `far`.
//   * The per-face work is done once, by the setup pass (bin_faces.cu): a
//     28-float record (7 x 16 bytes) with the six edge differences, face_inv,
//     1/z_k and the face's conservative pixel bbox.
//   * The tile's list is staged kStage faces at a time by 16-byte cp.async
//     into a double buffer: the next chunk's records load while the current
//     one is tested.  Records are read from shared memory as float4.
//   * Each lane tests one face's bbox against its warp's block, and a ballot
//     leaves the warp only the faces that can cover one of its pixels,
//     visited in ascending order: one test per 32 faces instead of a
//     warp-uniform test of every face, which measured slower.
//   * __launch_bounds__ keeps it at 40 registers, six blocks to an SM.
// Measured and dropped, as slower at the main shape: 2 or 4 pixels a thread
// with the column-constant halves of the tests hoisted; 64- and 128-thread
// blocks; blocks walking 2-16 tiles with one pipeline across them; a
// face-parallel variant, each warp rasterizing its own faces' bboxes into a
// shared (depth, id) z-buffer by 64-bit atomicMin.
// There is no capacity and no face limit: a block loops over any list
// length, so the TPU package's face slices, multi-pass merge, membership
// prefix, one-hot MXU fetch, lane rolls and strip staging have no
// counterpart here.
//
// Numerics.  Every expression keeps the plain version's (forward_dense.py)
// operands and order; the edge differences and 1/z_k are the same f32
// operations, made once in the setup pass, so face index and depth agree
// with it bit for bit.  Ties keep the lowest id: the lists are ascending,
// the ballot keeps their order, and the test is a strict '<'.  Degenerate
// faces (zeroed face_inv) get depth 0/0 = NaN and are rejected, where the
// plain version culls them.  Build with --fmad=false, never with fast math
// (zbuffer.cuh).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                        // tile edge in pixels
constexpr int kThreads = kTile * kTile;          // a pixel a thread
constexpr int kWarpW = 8;                        // a warp's pixels: this
constexpr int kWarpH = 32 / kWarpW;              // wide, this tall
constexpr int kWarpsX = kTile / kWarpW;
constexpr int kMinBlocks = 6;                    // blocks an SM must hold
constexpr int kIRec = 28;                        // floats per face record
constexpr int kVec = kIRec / 4;                  // 16-byte pieces
constexpr int kStage = 64;                       // faces per staged chunk

__device__ __forceinline__ float clip01(float v) {
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest committed group have landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// issue the copies of list entries [c0, c0 + n) into one stage
__device__ __forceinline__ void stage(const float* __restrict__ face_base,
                                      const int* __restrict__ ids, int c0,
                                      int n, int tid, float4* s_rec,
                                      int* s_id) {
  for (int q = tid; q < n * kVec; q += kThreads) {
    const int j = q / kVec;
    const int id = ids[c0 + j];
    cp_async16(s_rec + q, face_base + (size_t)id * kIRec + (q - j * kVec) * 4);
  }
  for (int j = tid; j < n; j += kThreads) s_id[j] = ids[c0 + j];
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
index_kernel(const float* __restrict__ irec, const int* __restrict__ start,
             const int* __restrict__ ids, int nf, int is, int nt, float near,
             float far, int* __restrict__ idx_out,
             float* __restrict__ depth_out) {
  __shared__ float4 s_rec[2][kStage * kVec];    // the block's two stages
  __shared__ int s_id[2][kStage];

  const int b = blockIdx.z;
  const int tile = (b * nt + blockIdx.y) * nt + blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // the warp's kWarpW x kWarpH block of the tile, the thread's pixel in it
  const int wx0 = blockIdx.x * kTile + (warp % kWarpsX) * kWarpW;
  const int wy0 = blockIdx.y * kTile + (warp / kWarpsX) * kWarpH;
  const int xi = wx0 + lane % kWarpW;
  const int yi = wy0 + lane / kWarpW;
  const bool mine = xi < is && yi < is;
  const size_t p = ((size_t)b * is + yi) * is + xi;
  const int begin = start[tile];
  const int end = start[tile + 1];

  if (begin == end) {                             // empty tile
    if (mine) {
      idx_out[p] = -1;
      depth_out[p] = far;
    }
    return;
  }

  const float* face_base = irec + (size_t)b * nf * kIRec;
  stage(face_base, ids, begin, min(kStage, end - begin), tid, s_rec[0],
        s_id[0]);
  cp_async_commit();

  const float fis = (float)is;
  const float fx = (float)xi;
  const float fy = (float)yi;
  const float xp = (2.0f * fx + 1.0f - fis) / fis;
  const float yp = (2.0f * fy + 1.0f - fis) / fis;
  // the warp's pixel block, as the records' pixel bbox compares it
  const float bx0 = (float)wx0, bx1 = (float)(wx0 + kWarpW - 1);
  const float by0 = (float)wy0, by1 = (float)(wy0 + kWarpH - 1);
  float zmin = __int_as_float(0x7f800000);       // +inf
  int win = -1;

  int buf = 0;
  for (int c0 = begin; c0 < end; c0 += kStage, buf ^= 1) {
    const int n = min(kStage, end - c0);
    // the other stage was consumed before the last loop's barrier
    if (c0 + kStage < end)
      stage(face_base, ids, c0 + kStage, min(kStage, end - c0 - kStage), tid,
            s_rec[buf ^ 1], s_id[buf ^ 1]);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += 32) {
      // lane l tests face j0 + l's bbox against the warp's block; the warp
      // then visits the faces that meet it, in ascending order
      bool meets = false;
      if (j0 + lane < n) {
        const float4 box = s_rec[buf][(j0 + lane) * kVec + 6];  // ylo yhi
        meets = !(box.y < by0 || box.x > by1 ||                 // xlo xhi
                  box.w < bx0 || box.z > bx1);
      }
      for (unsigned m = __ballot_sync(0xffffffffu, meets); m; m &= m - 1) {
        const int j = j0 + __ffs(m) - 1;
        const float4* r = s_rec[buf] + j * kVec;
        // q0 = x0 y0 x1 y1, q1 = x2 y2 dx01 dy01, q2 = dx12 dy12 dx20
        // dy20, q3..q5 = face_inv[0..8], 1/z0 1/z1 1/z2
        const float4 q0 = r[0], q1 = r[1], q2 = r[2];
        // strict inside test, reference rasterize.py:310-312 operand order
        const bool outside = ((yp - q0.y) * q1.z < (xp - q0.x) * q1.w) |
                             ((yp - q0.w) * q2.x < (xp - q0.z) * q2.y) |
                             ((yp - q1.y) * q2.z < (xp - q1.x) * q2.w);
        if (outside) continue;
        const float4 q3 = r[3], q4 = r[4], q5 = r[5];
        const float w0 = clip01(q3.x * fx + q3.y * fy + q3.z);
        const float w1 = clip01(q3.w * fx + q4.x * fy + q4.y);
        const float w2 = clip01(q4.z * fx + q4.w * fy + q5.x);
        const float wsum = w0 + w1 + w2;
        const float zp = wsum / (w0 * q5.y + w1 * q5.z + w2 * q5.w);
        if (zp > near && zp < far && zp < zmin) {
          zmin = zp;
          win = s_id[buf][j];
        }
      }
    }
    __syncthreads();                              // this stage is consumed
  }

  if (mine) {
    idx_out[p] = win;
    depth_out[p] = win < 0 ? far : zmin;
  }
}

}  // namespace

extern "C" {

int nr_forward_index_tile() { return kTile; }

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// irec [bs, nf, 28] f32 (bin_faces.cu), 16-byte aligned; start [bs * nt *
// nt + 1] i32; ids [start[-1]] i32; outputs idx i32 and depth f32, both
// [bs, is, is].
int nr_forward_index(const float* irec, const int* start, const int* ids,
                     int bs, int nf, int is, float near, float far, int* idx,
                     float* depth, void* stream) {
  const int nt = (is + kTile - 1) / kTile;
  const dim3 grid(nt, nt, bs);
  index_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      irec, start, ids, nf, is, nt, near, far, idx, depth);
  return (int)cudaGetLastError();
}

}  // extern "C"
