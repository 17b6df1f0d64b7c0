// Per-face setup and tile binning of the forward kernels for Hopper
// (sm_90a): the records the z-buffer kernels read and the per-tile face
// lists, made on the card.
//
// Not a TPU kernel's port: the JAX package does this work in XLA
// (forward_pallas._feature_table, _face_tile_ranges, _membership_prefix).
// The plain PyTorch versions are forward_cuda._face_records,
// _index_records and bin_faces; every output here equals theirs bit for
// bit (the records) or exactly (the lists).  forward_cuda.coverage_masks
// and lists_from_masks are the plain versions of this design's masks,
// counts and ranks.
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
// Design.  Faces go in chunks of kChunk = 128, one block of 128 threads per
// (chunk, batch row); a cell is a (tile, chunk) and holds a 128-bit
// coverage mask, bit 32 w + l for face 32 w + l of the chunk.  Cells are
// laid out tile-major, chunk-minor, so an exclusive scan of their popcounts
// gives each chunk's first slot in each tile's list, and a face's slot in a
// tile is that plus the popcount of the mask's bits below its own: O(1) a
// pair, and the lists come out ascending with no sort.
//   1. Count (nr_bin_count), one block of 128 threads per (chunk, batch
//      row): the block reads its faces as one run and writes their records
//      through shared memory (neighbouring threads at neighbouring
//      addresses); each thread makes its face's tile rectangle and pair
//      count; the block takes the chunk's tile bbox over its faces with
//      pairs and zeroes its masks inside it (a mask outside is never read);
//      then each warp walks the (tile, face) pairs of its 32 faces, kUnroll
//      pairs a lane per step (a lane finds its face by a binary search of
//      the warp's pair-count prefix held in the lanes), setting each pair's
//      bit with an integer atomicOr.  A face with 252 tiles thus spreads
//      over its warp's lanes, and OR does not depend on order, so every run
//      writes the same bits.
//   2. One CUB exclusive scan (an init kernel and a scan kernel) over the
//      faces' pair counts followed by the cells' popcounts (read through an
//      iterator: 0 outside the chunk's bbox; its divisions by multiply and
//      shift), into int64: the first nseg + 1 entries are `first`, entry
//      nseg the pair total P, and a cell's entry less P its first slot.
//   The host reads P (the forward's one host sync) to size ids and order.
//   3. Fill (nr_bin_fill), one lane per face-major pair row over the
//      whole grid, so a heavy chunk or face holds no block: the row's face
//      by a 32-way warp search of `first` and a short search from there,
//      its tile from the face's rectangle, its slot from the cell's scan
//      entry and mask; it writes the id and the row there.  The same grid
//      writes `first` as int32 and `start` (each tile's chunk-0 slot).
// Four device operations a call; no memset (the masks are zeroed by their
// chunk's block, only where they are read).
//
// What bounds it: the bytes.  Faces are read once (36 bytes), records
// written once (72 or 112 bytes), and the pairs written as ids and order.
// The masks cost 16 bytes a cell inside the chunks' bboxes; the scan reads
// one int per face and cell and writes 8 bytes for each.
//
// Numerics.  Every float expression repeats the plain version's operand
// order (geometry.to_pixel_coords, geometry.face_inv_matrix,
// forward_cuda._face_tile_ranges); built with --fmad=false and IEEE
// division.  Min and max propagate NaN as torch.amin / amax do (fminf does
// not), and clamp lets NaN through as torch.clamp does; a face with a NaN
// bbox misses every tile (t0 = 0, t1 = -1).  Integer atomics only set
// bits; there is no capacity, and a list may be any length.

#include <cub/device/device_scan.cuh>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <iterator>

namespace {

constexpr int kRec = 18;
constexpr int kIRec = 28;
constexpr int kChunk = 128;        // faces per chunk: one block, 4 mask words
constexpr int kWarps = kChunk / 32;
constexpr int kUnroll = 4;         // pairs a lane takes per step of a walk
constexpr int kFillThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// d >= 1 for quotients of 0 <= n < 2^31 by a multiply and a shift
// (cutlass::FastDivmod's method)
struct FastDiv {
  int d;
  unsigned mul, shr;
};

FastDiv fast_div(int d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned l = 0;
    while ((1ull << l) < (unsigned long long)d) ++l;        // ceil(log2 d)
    const unsigned p = 31 + l;
    f.mul = (unsigned)(((1ull << p) + (unsigned)d - 1) / (unsigned)d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ int quot(int n, const FastDiv& f) {
  return f.d == 1 ? n : (int)(__umulhi((unsigned)n, f.mul) >> f.shr);
}

// A face's records and tile rectangle (ty0, tx0, ny, nx), ny = 0 for a
// back face, from its 9 coordinates.
struct Setup {
  float fi[9];
  float ylo, yhi, xlo, xhi;
  int4 rect;
};

__device__ __forceinline__ Setup face_setup(const float* v, int is, int tile,
                                            int nt) {
  const float x0 = v[0], y0 = v[1];
  const float x1 = v[3], y1 = v[4];
  const float x2 = v[6], y2 = v[7];
  const float fis = (float)is;
  Setup o;

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
  const float fi[9] = {p1y - p2y, p2x - p1x, p1x * p2y - p2x * p1y,
                       p2y - p0y, p0x - p2x, p2x * p0y - p0x * p2y,
                       p0y - p1y, p1x - p0x, p0x * p1y - p1x * p0y};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    o.fi[k] = fi[k] / denom;
    if (!isfinite(o.fi[k])) o.fi[k] = 0.0f;
  }

  o.ylo = floorf(min3(p0y, p1y, p2y)) - 1.0f;
  o.yhi = ceilf(max3(p0y, p1y, p2y)) + 1.0f;
  o.xlo = floorf(min3(p0x, p1x, p2x)) - 1.0f;
  o.xhi = ceilf(max3(p0x, p1x, p2x)) + 1.0f;

  // geometry.is_frontface (NDC), then the tile rectangle
  const bool front = !((y2 - y0) * (x1 - x0) < (y1 - y0) * (x2 - x0));
  int ty0, ty1, tx0, tx1;
  tile_range(o.ylo, o.yhi, tile, nt, fis, ty0, ty1);
  tile_range(o.xlo, o.xhi, tile, nt, fis, tx0, tx1);
  o.rect = make_int4(ty0, tx0, front ? max(ty1 - ty0 + 1, 0) : 0,
                     max(tx1 - tx0 + 1, 0));
  return o;
}

// One pair of a warp's walk: pair j (of `total`, in face-major order over
// the warp's 32 faces) belongs to lane `owner`'s face, and is its tile
// (ty, tx).  `incl` is each lane's inclusive prefix of the pair counts.
// Every lane must call it (shuffles); `valid` is false past the walk's end.
struct Pair {
  int owner, ty, tx;
  bool valid;
};

__device__ __forceinline__ Pair warp_pair(unsigned j, unsigned total,
                                          unsigned incl, int ty0, int tx0,
                                          int nx, int n) {
  // the first lane whose inclusive prefix passes j
  int lo = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const unsigned v = __shfl_sync(kFull, incl, lo + step - 1);
    if (v <= j) lo += step;
  }
  const unsigned before = __shfl_sync(kFull, incl, lo > 0 ? lo - 1 : 0);
  const int oty0 = __shfl_sync(kFull, ty0, lo);
  const int otx0 = __shfl_sync(kFull, tx0, lo);
  const int onx = __shfl_sync(kFull, nx, lo);
  const int on = __shfl_sync(kFull, n, lo);
  const unsigned q = j - (lo > 0 ? before : 0u);
  Pair p;
  p.owner = lo;
  // q < on keeps a wrapped prefix (more than 2^32 pairs, which the host
  // refuses after the count) inside the face's rectangle
  p.valid = j < total && q < (unsigned)on;
  p.ty = p.valid ? oty0 + (int)(q / (unsigned)onx) : 0;
  p.tx = p.valid ? otx0 + (int)(q % (unsigned)onx) : 0;
  return p;
}

__device__ __forceinline__ unsigned warp_inclusive(unsigned v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kChunk)
bin_count_kernel(const float* __restrict__ faces, int nf, int is, int tile,
                 int nt, int nch, float* __restrict__ rec,
                 float* __restrict__ irec, int4* __restrict__ rect,
                 int* __restrict__ count, int4* __restrict__ box,
                 uint4* __restrict__ mask) {
  __shared__ float s_face[kChunk * 9];
  __shared__ float4 s_rec[kChunk * kIRec / 4];   // one record per face
  __shared__ int4 s_box[kWarps];
  const int c = blockIdx.x, b = blockIdx.y;
  const int i = threadIdx.x, lane = i & 31, w = i >> 5;
  const int nc = min(kChunk, nf - c * kChunk);    // faces in this chunk
  const size_t s0 = (size_t)b * nf + c * kChunk;

  // the chunk's faces are one run: read it and write its records through
  // shared memory, neighbouring threads at neighbouring addresses
  for (int k = i; k < nc * 9; k += kChunk) s_face[k] = faces[s0 * 9 + k];
  __syncthreads();
  const float* v = s_face + i * 9;
  Setup o;
  int4 r = make_int4(0, 0, 0, 0);
  if (i < nc) {
    o = face_setup(v, is, tile, nt);
    r = o.rect;
    rect[s0 + i] = r;
    count[s0 + i] = r.z * r.w;
  }
  if (rec != nullptr) {
    float* sr = reinterpret_cast<float*>(s_rec);
    if (i < nc) {
      float* d = sr + i * kRec;
      d[0] = v[0]; d[1] = v[1]; d[2] = v[3]; d[3] = v[4]; d[4] = v[6];
      d[5] = v[7]; d[6] = v[2]; d[7] = v[5]; d[8] = v[8];
#pragma unroll
      for (int k = 0; k < 9; ++k) d[9 + k] = o.fi[k];
    }
    __syncthreads();
    for (int k = i; k < nc * kRec; k += kChunk) rec[s0 * kRec + k] = sr[k];
    __syncthreads();
  }
  if (irec != nullptr) {
    if (i < nc) {
      float4* d = s_rec + i * (kIRec / 4);
      d[0] = make_float4(v[0], v[1], v[3], v[4]);
      d[1] = make_float4(v[6], v[7], v[3] - v[0], v[4] - v[1]);
      d[2] = make_float4(v[6] - v[3], v[7] - v[4], v[0] - v[6], v[1] - v[7]);
      d[3] = make_float4(o.fi[0], o.fi[1], o.fi[2], o.fi[3]);
      d[4] = make_float4(o.fi[4], o.fi[5], o.fi[6], o.fi[7]);
      d[5] = make_float4(o.fi[8], 1.0f / v[2], 1.0f / v[5], 1.0f / v[8]);
      d[6] = make_float4(o.ylo, o.yhi, o.xlo, o.xhi);
    }
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(irec) + s0 * (kIRec / 4);
    for (int k = i; k < nc * (kIRec / 4); k += kChunk) out[k] = s_rec[k];
  }
  const int n = r.z * r.w;

  // the chunk's tile bbox over its faces with pairs
  const bool live = n > 0;
  int4 q = make_int4(__reduce_min_sync(kFull, live ? r.x : INT_MAX),
                     __reduce_max_sync(kFull, live ? r.x + r.z - 1 : INT_MIN),
                     __reduce_min_sync(kFull, live ? r.y : INT_MAX),
                     __reduce_max_sync(kFull, live ? r.y + r.w - 1 : INT_MIN));
  if (lane == 0) s_box[w] = q;
  __syncthreads();
  q = s_box[0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    q.x = min(q.x, s_box[k].x);
    q.y = max(q.y, s_box[k].y);
    q.z = min(q.z, s_box[k].z);
    q.w = max(q.w, s_box[k].w);
  }
  if (q.x > q.y) q = make_int4(0, -1, 0, -1);      // no pair in the chunk
  if (i == 0) box[(size_t)b * nch + c] = q;

  uint4* cells = mask + (size_t)b * nt * nt * nch + c;
  const int bw = q.w - q.z + 1;
  const int area = (q.y - q.x + 1) * bw;
  for (int k = i; k < area; k += kChunk)
    cells[(size_t)((q.x + k / bw) * nt + q.z + k % bw) * nch] =
        make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // this warp's pairs, kUnroll a lane per step: set each one's bit
  const unsigned incl = warp_inclusive((unsigned)n, lane);
  const unsigned total = __shfl_sync(kFull, incl, 31);
  for (long long j0 = 0; j0 < total; j0 += 32 * kUnroll) {
    Pair p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      p[u] = warp_pair((unsigned)j0 + 32 * u + lane, total, incl, r.x, r.y,
                       r.w, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p[u].valid)
        atomicOr(reinterpret_cast<unsigned*>(
                     cells + (size_t)(p[u].ty * nt + p[u].tx) * nch) + w,
                 1u << p[u].owner);
  }
}

// The face of face-major pair row `row`: the last s with scan[s] <= row
// (scan[0 .. nseg] ascending, scan[nseg] = pairs > row), searched from
// `lo`, a face at or before it: doubling steps, then halving.
__device__ __forceinline__ int face_of(const long long* __restrict__ scan,
                                       int nseg, int lo, long long row) {
  int step = 1;
  while (lo + step < nseg && scan[lo + step] <= row) {
    lo += step;
    step *= 2;
  }
  int hi = lo + step < nseg ? lo + step : nseg;  // scan[hi] > row
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (scan[mid] <= row) lo = mid; else hi = mid;
  }
  return lo;
}

// A warp per 32 consecutive face-major pair rows, a lane per row, the
// warps spread over the grid: the face of the warp's first row by a
// 32-way search of the scan's face part (each step narrows it 32-fold),
// each lane's face from there, its tile from the face's rectangle, its
// slot from the cell's scan entry and mask; it writes the id and the row
// there.  The same grid writes `first` as int32 and `start` (each tile's
// chunk-0 slot).
__global__ void __launch_bounds__(kFillThreads)
bin_fill_kernel(const int4* __restrict__ rect,
                const long long* __restrict__ scan,
                const uint4* __restrict__ mask, int nseg, FastDiv nf,
                int nt, int nch, long long ntiles, int pairs,
                int* __restrict__ ids, int* __restrict__ order,
                int* __restrict__ first, int* __restrict__ start) {
  const long long g = (long long)blockIdx.x * kFillThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kFillThreads;
  for (long long k = g; k < nseg; k += stride) first[k] = (int)scan[k];
  for (long long k = g; k < ntiles; k += stride)
    start[k] = (int)(scan[nseg + k * nch] - pairs);
  if (g == 0) {
    first[nseg] = pairs;
    start[ntiles] = pairs;
  }
  const int lane = threadIdx.x & 31;
  for (long long row0 = g - lane; row0 < pairs; row0 += stride) {
    int lo = 0, hi = nseg;                  // scan[lo] <= row0 < scan[hi]
    while (hi - lo > 1) {
      const int at = lo + (int)((long long)(hi - lo) * lane / 32);
      const unsigned le = __ballot_sync(kFull, scan[at] <= row0);
      const int top = 31 - __clz(le);       // lane 0 probes lo: le != 0
      const int next = top < 31 ? lo + (int)((long long)(hi - lo) *
                                             (top + 1) / 32) : hi;
      lo = lo + (int)((long long)(hi - lo) * top / 32);
      hi = next;
    }
    const long long row = row0 + lane;
    if (row >= pairs) continue;
    const int s = face_of(scan, nseg, lo, row);
    const int4 r = rect[s];
    const int q = (int)(row - scan[s]);
    const int qy = q / r.w;
    const int ty = r.x + qy, tx = r.y + (q - qy * r.w);
    const int b = quot(s, nf);
    const int f = s - b * nf.d;                  // the face in its batch row
    const int w = (f % kChunk) >> 5, bit = f & 31;
    const size_t cell =
        ((size_t)b * nt * nt + ty * nt + tx) * nch + f / kChunk;
    const uint4 m = mask[cell];
    // the faces of lower warps of the chunk, then this warp's lower lanes
    const unsigned mine = w == 0 ? m.x : w == 1 ? m.y : w == 2 ? m.z : m.w;
    const int rank = __popc(mine & ((1u << bit) - 1u)) +
                     (w > 0 ? __popc(m.x) : 0) + (w > 1 ? __popc(m.y) : 0) +
                     (w > 2 ? __popc(m.z) : 0);
    const int pos = (int)(scan[nseg + cell] - pairs) + rank;
    ids[pos] = f;
    order[pos] = (int)row;
  }
}

// The scan's input: face k < nseg gives its pair count, cell j = k - nseg
// the popcount of its mask where its tile lies in its chunk's bbox, else 0
// (the mask there is never written).
struct CountIt {
  using value_type = int;
  using difference_type = std::ptrdiff_t;
  using pointer = const int*;
  using reference = int;
  using iterator_category = std::random_access_iterator_tag;

  const int* count;
  const uint4* mask;
  const int4* box;
  int nseg;
  FastDiv nch, tiles, nt;
  difference_type k;

  __host__ __device__ int at(difference_type idx) const {
#ifdef __CUDA_ARCH__
    const int kk = (int)idx;
    if (kk < nseg) return count[kk];
    const int j = kk - nseg;
    const int bt = quot(j, nch);
    const int c = j - bt * nch.d;
    const int b = quot(bt, tiles);
    const int t = bt - b * tiles.d;
    const int ty = quot(t, nt), tx = t - ty * nt.d;
    const int4 q = box[(size_t)b * nch.d + c];
    if (ty < q.x || ty > q.y || tx < q.z || tx > q.w) return 0;
    const uint4 m = mask[j];
    return __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
#else
    (void)idx;
    return 0;
#endif
  }
  __host__ __device__ int operator*() const { return at(k); }
  __host__ __device__ int operator[](difference_type d) const {
    return at(k + d);
  }
  __host__ __device__ CountIt operator+(difference_type d) const {
    CountIt o = *this;
    o.k += d;
    return o;
  }
};

struct Add64 {
  __host__ __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};

int chunks(int nf) { return (nf + kChunk - 1) / kChunk; }

// faces and cells the scan runs over, or -1 past int32
long long scan_items(int bs, int nf, int is, int tile) {
  if (bs < 0 || nf < 0 || is < 1 || tile < 1) return -1;
  const long long nt = (is + tile - 1) / tile;
  const long long items =
      (long long)bs * nf + (long long)bs * nt * nt * chunks(nf);
  return items > INT_MAX ? -1 : items;
}

cudaError_t scan(void* temp, size_t& bytes, const CountIt& in,
                 long long* out, int items, cudaStream_t st) {
  return cub::DeviceScan::ExclusiveScan(temp, bytes, in, out, Add64{}, 0LL,
                                        items, st);
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// (tile, chunk) cells of this shape: the rows of nr_bin_count's `mask`
// (4 words each); the chunks of a batch row are cells / (bs * nt * nt).
// -1 where faces and cells pass int32.
long long nr_bin_cells(int bs, int nf, int is, int tile) {
  const long long items = scan_items(bs, nf, is, tile);
  return items < 0 ? -1 : items - (long long)bs * nf;
}

// Bytes of CUB scratch nr_bin_count needs (its `temp`), or -1 on error.
long long nr_bin_scan_bytes(int bs, int nf, int is, int tile) {
  const long long items = scan_items(bs, nf, is, tile);
  if (items < 0) return -1;
  size_t bytes = 0;
  const FastDiv one = fast_div(1);
  CountIt in{nullptr, nullptr, nullptr, bs * nf, one, one, one, 0};
  if (scan(nullptr, bytes, in, nullptr, (int)items, 0) != cudaSuccess)
    return -1;
  return (long long)bytes;
}

// Passes 1-2 on `stream`; returns cudaGetLastError() (0 on success).
// faces [bs, nf, 3, 3] f32 contiguous; rec [bs, nf, 18] and irec [bs, nf,
// 28] f32 or null (not written); scratch: rect [bs * nf] int4, count [bs *
// nf] int32, box [bs * chunks] int4, mask [nr_bin_cells] uint4, temp
// [nr_bin_scan_bytes]; scan [max(bs * nf + cells, 1)] int64 out, whose
// entry bs * nf is the pair total (0 when there is no face).
int nr_bin_count(const float* faces, int bs, int nf, int is, int tile,
                 float* rec, float* irec, void* rect, int* count, void* box,
                 void* mask, long long* out, void* temp,
                 long long temp_bytes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long items = scan_items(bs, nf, is, tile);
  if (items < 0) return (int)cudaErrorInvalidValue;
  const int nseg = bs * nf;
  if (nseg == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(long long), st);
  const int nt = (is + tile - 1) / tile;
  const int nch = chunks(nf);
  bin_count_kernel<<<dim3(nch, bs), kChunk, 0, st>>>(
      faces, nf, is, tile, nt, nch, rec, irec, reinterpret_cast<int4*>(rect),
      count, reinterpret_cast<int4*>(box), reinterpret_cast<uint4*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t bytes = (size_t)temp_bytes;
  CountIt in{count,          reinterpret_cast<const uint4*>(mask),
             reinterpret_cast<const int4*>(box), nseg, fast_div(nch),
             fast_div(nt * nt), fast_div(nt),   0};
  err = scan(temp, bytes, in, out, (int)items, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Pass 3 on `stream`: ids and order [pairs], first [bs * nf + 1] and start
// [bs * nt * nt + 1] int32 from nr_bin_count's rect, mask and scan, with
// `pairs` the total the host read.  Returns cudaGetLastError() (0 on
// success).
int nr_bin_fill(const void* rect, const long long* scan, const void* mask,
                int bs, int nf, int is, int tile, int pairs, int* ids,
                int* order, int* first, int* start, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int nt = (is + tile - 1) / tile;
  const int nseg = bs * nf;
  if (nseg == 0) {
    cudaError_t err = cudaMemsetAsync(first, 0, sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(
        start, 0, ((size_t)bs * nt * nt + 1) * sizeof(int), st);
  }
  const long long ntiles = (long long)bs * nt * nt;
  long long work = pairs > nseg ? pairs : nseg;
  work = work > ntiles ? work : ntiles;
  const long long blocks = (work + kFillThreads - 1) / kFillThreads;
  bin_fill_kernel<<<(unsigned)(blocks < (1 << 20) ? blocks : (1 << 20)),
                    kFillThreads, 0, st>>>(
      reinterpret_cast<const int4*>(rect), scan,
      reinterpret_cast<const uint4*>(mask), nseg, fast_div(nf), nt,
      chunks(nf), ntiles, pairs, ids, order, first, start);
  return (int)cudaGetLastError();
}

}  // extern "C"
