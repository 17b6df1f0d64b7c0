// Per-face setup and tile binning of the forward kernels for Hopper
// (sm_90a): the records the z-buffer kernels read and the per-tile face
// lists, made on the card.
//
// Not a TPU kernel's port: the JAX package does this work in XLA
// (forward_pallas._feature_table, _face_tile_ranges, _membership_prefix).
// The plain PyTorch versions are forward_cuda._face_records,
// _index_records and bin_faces; every output here equals theirs bit for
// bit (the records) or exactly (the lists).
//
// Outputs, for faces [bs, nf, 3, 3] and a tile edge `tile` (nt = ceil(is /
// tile) tiles a side, T = nt * nt per batch row):
//   rec   [bs, nf, 18]  x0 y0 x1 y1 x2 y2, z0-2, face_inv rows (non-finite
//                       zeroed): forward_shaded.cu's record (optional);
//   irec  [bs, nf, 28]  forward_index.cu's record (optional): x0 y0 x1 y1
//                       x2 y2, the edge differences x1-x0 y1-y0 x2-x1 y2-y1
//                       x0-x2 y0-y2, face_inv, 1/z0-2, and the conservative
//                       pixel bbox: rows floor(min py) - 1, ceil(max py) + 1,
//                       columns floor(min px) - 1, ceil(max px) + 1 (7 x 16
//                       bytes);
//   start [bs * T + 1]  CSR offsets of the tile lists;
//   ids   [pairs]       each tile's front faces, ascending;
//   order [pairs]       tile-major pair -> its face-major row;
//   first [bs * nf + 1] each face's first face-major row.
//
// Passes (nr_bin_count, then nr_bin_fill after the host has read the pair
// total to size ids and order):
//   1. setup, one thread per (batch, face): the records, the face's tile
//      rectangle and its pair count, and one integer atomicAdd per covered
//      tile into a count per (tile, chunk of kChunk faces);
//   2. CUB exclusive scans: of the pair counts (int64) into `first`, and of
//      the (tile, chunk) counts laid out tile-major, chunk-minor, which
//      gives each chunk's first slot in each tile's list directly;
//   3. finish: `first` to int32 and `start` gathered from the chunk slots;
//   4. fill, one block per (batch, chunk), one thread per face: a face's
//      slot in a tile is its chunk's slot plus the number of lower faces of
//      its chunk that cover the tile, counted from the chunk's rectangles
//      in shared memory.  No sort: face-major row first[f] + (ty - ty0) nx
//      + (tx - tx0) is known, and the lists come out ascending.
// Integer atomics only add counts, so every run writes the same bits; there
// is no capacity, and a list may be any length.
//
// What bounds it: the bytes.  Faces are read once (36 bytes), records
// written once (72 or 112 bytes), and the pairs written as ids and order;
// the (tile, chunk) counts are bs * T * ceil(nf / kChunk) words, zeroed,
// scanned and read once.  The fill's rank loop is at most kChunk integer
// tests per pair from a shared-memory broadcast.
//
// Numerics.  Every float expression repeats the plain version's operand
// order (geometry.to_pixel_coords, geometry.face_inv_matrix,
// forward_cuda._face_tile_ranges); built with --fmad=false and IEEE
// division.  Min and max propagate NaN as torch.amin / amax do (fminf does
// not), and clamp lets NaN through as torch.clamp does; a face with a NaN
// bbox misses every tile (t0 = 0, t1 = -1).

#include <cub/device/device_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kRec = 18;
constexpr int kIRec = 28;
constexpr int kChunk = 128;        // faces per rank chunk (fill block size)
constexpr int kSetupThreads = 256;

__device__ __forceinline__ float min3(float a, float b, float c) {
  if (a != a) return a;
  if (b != b) return b;
  if (c != c) return c;
  return fminf(fminf(a, b), c);
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  if (a != a) return a;
  if (b != b) return b;
  if (c != c) return c;
  return fmaxf(fmaxf(a, b), c);
}

// torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

// forward_cuda._face_tile_ranges' rng(): tile range [t0, t1] of the padded
// pixel range [lo, hi]; t1 = t0 - 1 (0, -1) where it misses the image
__device__ __forceinline__ void tile_range(float lo, float hi, int tile,
                                           int nt, float fis, int& t0,
                                           int& t1) {
  const float ft = (float)tile;
  const float a = clampf(floorf(lo / ft), 0.0f, (float)(nt - 1));
  const float b = clampf(floorf(hi / ft), 0.0f, (float)(nt - 1));
  const bool hits = (hi >= 0.0f) && (lo <= fis - 1.0f);   // false for NaN
  t0 = hits ? (int)a : 0;
  t1 = hits ? (int)b : -1;
}

__global__ void __launch_bounds__(kSetupThreads)
bin_setup_kernel(const float* __restrict__ faces, int nseg, int nf, int is,
                 int tile, int nt, int nch, float* __restrict__ rec,
                 float* __restrict__ irec, int4* __restrict__ rect,
                 long long* __restrict__ count, int* __restrict__ cnt) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s == 0) count[nseg] = 0;          // the scans' trailing zero
  if (s >= nseg) return;
  const float* v = faces + (size_t)s * 9;
  const float x0 = v[0], y0 = v[1], z0 = v[2];
  const float x1 = v[3], y1 = v[4], z1 = v[5];
  const float x2 = v[6], y2 = v[7], z2 = v[8];
  const float fis = (float)is;

  // geometry.to_pixel_coords: 0.5 * (v * is + is - 1)
  const float p0x = 0.5f * ((x0 * fis + fis) - 1.0f);
  const float p1x = 0.5f * ((x1 * fis + fis) - 1.0f);
  const float p2x = 0.5f * ((x2 * fis + fis) - 1.0f);
  const float p0y = 0.5f * ((y0 * fis + fis) - 1.0f);
  const float p1y = 0.5f * ((y1 * fis + fis) - 1.0f);
  const float p2y = 0.5f * ((y2 * fis + fis) - 1.0f);

  // geometry.face_inv_matrix, zeroed where not finite (_face_records)
  const float denom =
      (p2x * (p0y - p1y) + p0x * (p1y - p2y)) + p1x * (p2y - p0y);
  float fi[9] = {p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y,
                 p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y,
                 p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    fi[k] = fi[k] / denom;
    if (!isfinite(fi[k])) fi[k] = 0.0f;
  }

  const float ylo = floorf(min3(p0y, p1y, p2y)) - 1.0f;
  const float yhi = ceilf(max3(p0y, p1y, p2y)) + 1.0f;
  const float xlo = floorf(min3(p0x, p1x, p2x)) - 1.0f;
  const float xhi = ceilf(max3(p0x, p1x, p2x)) + 1.0f;

  if (rec != nullptr) {
    float* r = rec + (size_t)s * kRec;
    r[0] = x0; r[1] = y0; r[2] = x1; r[3] = y1; r[4] = x2; r[5] = y2;
    r[6] = z0; r[7] = z1; r[8] = z2;
#pragma unroll
    for (int k = 0; k < 9; ++k) r[9 + k] = fi[k];
  }
  if (irec != nullptr) {
    float4* r = reinterpret_cast<float4*>(irec + (size_t)s * kIRec);
    r[0] = make_float4(x0, y0, x1, y1);
    r[1] = make_float4(x2, y2, x1 - x0, y1 - y0);
    r[2] = make_float4(x2 - x1, y2 - y1, x0 - x2, y0 - y2);
    r[3] = make_float4(fi[0], fi[1], fi[2], fi[3]);
    r[4] = make_float4(fi[4], fi[5], fi[6], fi[7]);
    r[5] = make_float4(fi[8], 1.0f / z0, 1.0f / z1, 1.0f / z2);
    r[6] = make_float4(ylo, yhi, xlo, xhi);
  }

  // geometry.is_frontface (NDC), then the tile rectangle
  const bool front = !((y2 - y0) * (x1 - x0) < (y1 - y0) * (x2 - x0));
  int ty0, ty1, tx0, tx1;
  tile_range(ylo, yhi, tile, nt, fis, ty0, ty1);
  tile_range(xlo, xhi, tile, nt, fis, tx0, tx1);
  const int ny = front ? max(ty1 - ty0 + 1, 0) : 0;
  const int nx = max(tx1 - tx0 + 1, 0);
  rect[s] = make_int4(ty0, tx0, ny, nx);
  count[s] = (long long)ny * nx;
  if (ny * nx == 0) return;

  const int b = s / nf;
  const int c = (s - b * nf) / kChunk;
  int* base = cnt + (size_t)b * nt * nt * nch + c;
  for (int ty = ty0; ty <= ty1; ++ty)
    for (int tx = tx0; tx <= tx1; ++tx)
      atomicAdd(base + (size_t)(ty * nt + tx) * nch, 1);
}

// first (int32) from the int64 scan; start from each tile's chunk-0 slot
__global__ void bin_finish_kernel(const long long* __restrict__ first64,
                                  const int* __restrict__ offs, int nseg,
                                  int ntiles, int nch, int* __restrict__ first,
                                  int* __restrict__ start) {
  const int n = max(nseg, ntiles) + 1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (i <= nseg) first[i] = (int)first64[i];
    if (i <= ntiles) start[i] = offs[(size_t)i * nch];
  }
}

__global__ void __launch_bounds__(kChunk)
bin_fill_kernel(const int4* __restrict__ rect, const int* __restrict__ first,
                const int* __restrict__ offs, int nf, int nt, int nch,
                int* __restrict__ ids, int* __restrict__ order) {
  __shared__ int4 s_rect[kChunk];
  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int i = threadIdx.x;
  const int f = c * kChunk + i;
  const size_t s = (size_t)b * nf + f;
  const int4 r = f < nf ? rect[s] : make_int4(0, 0, 0, 0);
  s_rect[i] = r;
  __syncthreads();
  const int n = r.z * r.w;
  if (n == 0) return;
  const int row0 = first[s];
  const int* tile_offs = offs + (size_t)b * nt * nt * nch + c;
  for (int j = 0; j < n; ++j) {
    const int ty = r.x + j / r.w;
    const int tx = r.y + j % r.w;
    // lower faces of this chunk in the same tile
    int rank = 0;
    for (int l = 0; l < i; ++l) {
      const int4 q = s_rect[l];
      rank += ((unsigned)(ty - q.x) < (unsigned)q.z) &
              ((unsigned)(tx - q.y) < (unsigned)q.w);
    }
    const int pos = tile_offs[(size_t)(ty * nt + tx) * nch] + rank;
    ids[pos] = f;
    order[pos] = row0 + j;
  }
}

int chunks(int nf) { return (nf + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// (tile, chunk) counters of nr_bin_count for this shape, the trailing zero
// included: the size of its `cnt` and `offs` scratch.
long long nr_bin_cells(int bs, int nf, int is, int tile) {
  const long long nt = (is + tile - 1) / tile;
  return (long long)bs * nt * nt * chunks(nf) + 1;
}

// Bytes of CUB scratch nr_bin_count needs (its `temp`), or -1 on error.
long long nr_bin_scan_bytes(int bs, int nf, int is, int tile) {
  const long long cells = nr_bin_cells(bs, nf, is, tile);
  if (cells > 0x7fffffffLL) return -1;
  size_t a = 0, b = 0;
  if (cub::DeviceScan::ExclusiveSum(nullptr, a, (const long long*)nullptr,
                                    (long long*)nullptr, bs * nf + 1) !=
          cudaSuccess ||
      cub::DeviceScan::ExclusiveSum(nullptr, b, (const int*)nullptr,
                                    (int*)nullptr, (int)cells) != cudaSuccess)
    return -1;
  return (long long)(a > b ? a : b);
}

// Passes 1-3 on `stream`; returns cudaGetLastError() (0 on success).
// faces [bs, nf, 3, 3] f32 contiguous; rec [bs, nf, 18] and irec [bs, nf,
// 28] f32 or null (not written); scratch: rect [bs * nf] int4, count and
// first64 [bs * nf + 1] int64, cnt and offs [nr_bin_cells] int32, temp
// [nr_bin_scan_bytes]; outputs first [bs * nf + 1] and start [bs * nt * nt
// + 1] int32.  The pair total is first64[bs * nf].
int nr_bin_count(const float* faces, int bs, int nf, int is, int tile,
                 float* rec, float* irec, void* rect, long long* count,
                 long long* first64, int* cnt, int* offs, void* temp,
                 long long temp_bytes, int* first, int* start, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (is + tile - 1) / tile;
  const int nseg = bs * nf;
  const int nch = chunks(nf);
  const long long cells = nr_bin_cells(bs, nf, is, tile);
  if (tile <= 0 || cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(cnt, 0, (size_t)cells * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (nseg > 0) {
    bin_setup_kernel<<<(nseg + kSetupThreads - 1) / kSetupThreads,
                       kSetupThreads, 0, st>>>(
        faces, nseg, nf, is, tile, nt, nch, rec, irec,
        reinterpret_cast<int4*>(rect), count, cnt);
  } else {
    err = cudaMemsetAsync(count, 0, sizeof(long long), st);
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t bytes = (size_t)temp_bytes;
  err = cub::DeviceScan::ExclusiveSum(temp, bytes, count, first64, nseg + 1,
                                      st);
  if (err != cudaSuccess) return (int)err;
  bytes = (size_t)temp_bytes;
  err = cub::DeviceScan::ExclusiveSum(temp, bytes, cnt, offs, (int)cells, st);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = bs * nt * nt;
  const int n = (nseg > ntiles ? nseg : ntiles) + 1;
  bin_finish_kernel<<<(n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024, 256, 0,
                      st>>>(first64, offs, nseg, ntiles, nch, first, start);
  return (int)cudaGetLastError();
}

// Pass 4 on `stream`: ids and order [pairs] from nr_bin_count's rect,
// first and offs.  Returns cudaGetLastError() (0 on success).
int nr_bin_fill(const void* rect, const int* first, const int* offs, int bs,
                int nf, int is, int tile, int* ids, int* order,
                void* stream) {
  if (bs * nf == 0) return (int)cudaSuccess;
  const int nt = (is + tile - 1) / tile;
  bin_fill_kernel<<<dim3(chunks(nf), bs), kChunk, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(rect), first, offs, nf, nt, chunks(nf),
      ids, order);
  return (int)cudaGetLastError();
}

}  // extern "C"
