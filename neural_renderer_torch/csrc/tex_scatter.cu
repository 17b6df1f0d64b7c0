// The texture gradient of cubes above ts 4 for Hopper (sm_90a): each
// face's ts^3 x 3 gradient cube, summed from the pixels it won.
//
// Replaces the 8-corner scatter of texture.grad_textures on the card (the
// JAX package's neural_renderer_tpu/rasterize/texture.py:275-289, a
// segment_sum per corner there; the reference's atomicAdd scatter,
// rasterize.py:750-792): a covered pixel adds w_pn * grad_rgb[c] to channel
// c of cell isc_pn of its winner's cube, for the 8 corners pn around its
// perspective-corrected texture coordinate.  Before this kernel the port
// built the 8 corner rows of every raster pixel in plain torch, sorted them
// by cell and found each cell's run with searchsorted over every cell (at
// bs 32 on a 512^2 raster at ts 16: 67 M rows, 646 M cells, 5.2 GB of
// offsets), only so that the sums ran in a fixed order without float
// atomics.  The forward's tile lists give such an order with no sort, as
// they do for face_reduce.
//
// What bounds it on this card: the bytes, almost all of them the cube
// written once (bs * nf * ts^3 * 3 floats: 7.75 GB at bs 32, 4,928 faces,
// ts 16, ~2.3 ms at 3.35 TB/s).  Each covered pixel reads 10 map words and
// the face-index words of the tiles its face was binned into.
//
// Design: no sort, no float atomics, no size limit on the cube.
//   1. tex_scatter_zero_kernel writes the whole cube with zeros in 16-byte
//      stores, as a memset would.
//   2. tex_scatter_rows_kernel, a warp per tile: inverts the tile-major
//      order of the (tile, face) pairs, so each face-major row learns its
//      tile (row_tile, 4 bytes a pair), and resets the faces' counter.
//   3. tex_scatter_kernel, a warp per face (b, f), the faces handed out in
//      turn by that integer counter: the warp walks the face's rows
//      first[s] .. first[s + 1] in order.  For a row's tile it reads the
//      tile's 256 face-index words and takes the pixels the face won in
//      pixel order (8 ballots of 32).  Each lane computes the texture
//      coordinate of its own won pixel; the pixels are then added one at a
//      time in order, the pixel's values shuffled to lanes 0-23, lane
//      3 pn + c adding corner pn's term to channel c.  A pixel's 8 corners
//      are 8 distinct cells (lo <= ts - 2), so its 24 adds never collide.
//      While consecutive pixels keep their lo triple (the same 8 cells) a
//      lane keeps its cell's running sum in a register; when the triple
//      changes the lanes store their sums, __syncwarp orders the stores
//      before the next loads, and the new cells are read.  Each cell is
//      thus read, added to in the pixels' order and written, exactly as
//      one add after another in memory.
//   A face with no row, or no pixel in its rows, keeps its zeros.  The
//   cube is never staged in shared memory, so any ts runs.
// The order (rows, then pixels in tile order) is fixed by the inputs, and
// which warp takes a face changes nothing in it, so every run gives the
// same bits.
//
// Measured at the ts-16 cell's shape on an H100 (PERF.md): a warp that
// zeroed its own face's cube before adding to it took 3.71 ms; the zeros
// apart (2.47 ms; a memset of the cube takes 2.36) and the adds with the
// faces handed out by the counter (0.50 ms; 0.66 ms with a fixed
// grid-stride share of faces, where a few warps draw many pixels) take
// 3.00 ms.
//
// Numerics.  texture._texture_index_float and _corner operation for
// operation: tif = (w * (ts - 1)) * (depth / z), clamped at 0 and then at
// hi = ts - 1 - eps rounded to float (NaN kept, as torch.clamp keeps it);
// lo by truncation, frac = tif - lo; the weight of corner pn the product
// over the axes k = 0, 1, 2, in that order, of frac_k (bit k of pn set)
// or 1 - frac_k; its term w * g[c].  Each operation is rounded alone (the
// library builds with --fmad=false) and the division is IEEE, so every
// term is bit-equal to texture.corner_rows'.  Only the order of the adds
// differs from the plain index_add_ (SEGMENT_TOL of chip_smoke.py).  lo is
// clamped to [0, ts - 2] besides, which changes nothing where eps > 0 and
// keeps any input's writes inside its face's cube.
//
// Addressing: the cube holds bs * nf * ts^3 * 3 floats, past 2^31 at the
// ts-16 cell's shape, so cube and cell offsets are 64-bit; faces, pixels
// and pairs are int32 (the wrapper checks).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;          // the forward's tile edge (zbuffer.cuh)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunks = kTile * kTile / 32;  // a tile's ballots of 32 pixels
constexpr int kLanes = 24;         // 8 corners x 3 channels of one pixel
constexpr int kZeroBlocksPerSm = 16;
constexpr unsigned kFull = 0xffffffffu;

// The forward's z and weights [bs, 3, is, is], depth_map (as
// [bs, 1, is, is]) and the rgb gradient (as its [bs, 3, is, is]
// permutation), each with its element strides.
struct Maps {
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

// Zeros into out[0 .. n): 16-byte stores (out 16-byte aligned), the last
// n % 4 floats alone.
__global__ void __launch_bounds__(kThreads)
tex_scatter_zero_kernel(float* __restrict__ out, long long n) {
  const long long n4 = n >> 2;
  float4* v = reinterpret_cast<float4*>(out);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += step)
    v[i] = zero;
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4)
    out[4 * n4 + threadIdx.x] = 0.0f;
}

__global__ void __launch_bounds__(kThreads)
tex_scatter_rows_kernel(const int* __restrict__ start,
                        const int* __restrict__ order, int ntiles,
                        int* __restrict__ row_tile, int* __restrict__ next) {
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && threadIdx.x == 0) *next = 0;
  const int step = gridDim.x * kWarps;
  for (int t = (blockIdx.x * kThreads + threadIdx.x) >> 5; t < ntiles;
       t += step) {
    const int s1 = start[t + 1];
    for (int p = start[t] + lane; p < s1; p += 32) row_tile[order[p]] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
tex_scatter_kernel(const int* __restrict__ fim, const int* __restrict__ first,
                   const int* __restrict__ row_tile, int* __restrict__ next,
                   int nseg, int nf, int is, int nt, int ts, Maps m,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long cube = 3LL * ts * ts * ts;
  const float scale = (float)(ts - 1);
  // this lane's corner and channel (lanes 0-23)
  const int pn = lane / 3;
  const int ch = lane - 3 * pn;
  for (;;) {
    int seg = 0;
    if (lane == 0) seg = atomicAdd(next, 1);
    seg = __shfl_sync(kFull, seg, 0);
    if (seg >= nseg) break;
    const long long base = (long long)seg * cube;
    const int b = seg / nf;
    const int f = seg - b * nf;
    const int r1 = first[seg + 1];
    int cur = -1;      // the lo triple whose 8 cells the lanes hold
    float acc = 0.0f;  // this lane's running sum of its cell
    float* cell = out;
    for (int r = first[seg]; r < r1; ++r) {
      const int t = row_tile[r] - b * nt * nt;
      const int y0 = (t / nt) * kTile;
      const int x0 = (t % nt) * kTile;
      const int x = x0 + (lane & (kTile - 1));
      unsigned won[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int y = y0 + 2 * c + (lane >> 4);
        won[c] = y < is && x < is
                 && fim[((size_t)b * is + y) * is + x] == f;
      }
#pragma unroll
      for (int c = 0; c < kChunks; ++c) won[c] = __ballot_sync(kFull, won[c]);
#pragma unroll 1
      for (int c = 0; c < kChunks; ++c) {
        unsigned todo = won[c];
        if (todo == 0) continue;
        // this lane's pixel, where the face won it: lo and frac per axis
        int lo[3] = {0, 0, 0};
        float fr[3] = {0.0f, 0.0f, 0.0f}, g[3] = {0.0f, 0.0f, 0.0f};
        if ((todo >> lane) & 1u) {
          const int y = y0 + 2 * c + (lane >> 4);
          const float depth = map_at(m.d, m.ds, b, 0, y, x);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float tif = (map_at(m.w, m.ws, b, k, y, x) * scale)
                        * (depth / map_at(m.z, m.zs, b, k, y, x));
            if (!isnan(tif)) tif = fmaxf(tif, 0.0f);
            if (!isnan(tif)) tif = fminf(tif, m.hi);
            lo[k] = min(max((int)tif, 0), ts - 2);
            fr[k] = tif - (float)lo[k];
            g[k] = map_at(m.g, m.gs, b, k, y, x);
          }
        }
        while (todo) {
          const int src = __ffs(todo) - 1;
          todo &= todo - 1;
          const int l0 = __shfl_sync(kFull, lo[0], src);
          const int l1 = __shfl_sync(kFull, lo[1], src);
          const int l2 = __shfl_sync(kFull, lo[2], src);
          const float f0 = __shfl_sync(kFull, fr[0], src);
          const float f1 = __shfl_sync(kFull, fr[1], src);
          const float f2 = __shfl_sync(kFull, fr[2], src);
          const float g0 = __shfl_sync(kFull, g[0], src);
          const float g1 = __shfl_sync(kFull, g[1], src);
          const float g2 = __shfl_sync(kFull, g[2], src);
          const int key = (l0 * ts + l1) * ts + l2;
          if (key != cur) {
            if (cur >= 0 && lane < kLanes) *cell = acc;
            __syncwarp();
            cur = key;
            if (lane < kLanes) {
              const int i0 = l0 + (pn & 1);
              const int i1 = l1 + ((pn >> 1) & 1);
              const int i2 = l2 + (pn >> 2);
              cell = out + base + 3LL * ((i0 * ts + i1) * ts + i2) + ch;
              acc = __ldcg(cell);
            }
          }
          if (lane < kLanes) {
            float w = (pn & 1) ? f0 : 1.0f - f0;
            w = w * ((pn & 2) ? f1 : 1.0f - f1);
            w = w * ((pn & 4) ? f2 : 1.0f - f2);
            acc = acc + w * (ch == 0 ? g0 : ch == 1 ? g1 : g2);
          }
        }
      }
    }
    if (cur >= 0 && lane < kLanes) *cell = acc;
  }
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int nr_tex_scatter_tile() { return kTile; }

// Launches the three kernels on `stream`; returns cudaGetLastError() (0 on
// success).  fim [bs, is, is] int32; the forward's tile lists at kTile:
// start [bs * nt * nt + 1], order [pairs] (tile-major pair -> its
// face-major row) and first [bs * nf + 1] (each face's first face-major
// row); row_tile [pairs + 1] int32 scratch (the rows' tiles, then the
// faces' counter); maps: the device addresses of z, weights, depth_map and
// the rgb gradient, strides: their 4 element strides each, in that order
// (Maps); hi: the clamp's upper limit; out [bs, nf, ts, ts, ts, 3] float32,
// 16-byte aligned, of out_floats floats, every one written.
int nr_tex_scatter(const int* fim, const int* start, const int* order,
                   const int* first, int* row_tile, int pairs, int bs, int nf,
                   int is, int ts, const float* const* maps,
                   const long long* strides, float hi, float* out,
                   long long out_floats, void* stream) {
  if (pairs < 0 || bs < 0 || nf < 0 || is < 0 || ts < 2 || maps == nullptr
      || strides == nullptr || ((uintptr_t)out & 15) != 0
      || out_floats != 3LL * bs * nf * ts * ts * ts)
    return (int)cudaErrorInvalidValue;
  const int nseg = bs * nf;
  if (nseg == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tex_scatter_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  Maps m{};
  m.z = maps[0];
  m.w = maps[1];
  m.d = maps[2];
  m.g = maps[3];
  for (int i = 0; i < 4; ++i) {
    m.zs[i] = strides[i];
    m.ws[i] = strides[4 + i];
    m.ds[i] = strides[8 + i];
    m.gs[i] = strides[12 + i];
  }
  m.hi = hi;
  const long long zero_want = (out_floats / 4 + kThreads - 1) / kThreads;
  const long long zero_cap = (long long)sms * kZeroBlocksPerSm;
  const unsigned zero_blocks =
      (unsigned)(zero_want < 1 ? 1 : zero_want < zero_cap ? zero_want
                                                          : zero_cap);
  tex_scatter_zero_kernel<<<zero_blocks, kThreads, 0, s>>>(out, out_floats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int* next = row_tile + pairs;
  const int nt = (is + kTile - 1) / kTile;
  const int ntiles = bs * nt * nt;
  const int rows_want = (ntiles + kWarps - 1) / kWarps;
  const int rows_cap = sms * 16;
  tex_scatter_rows_kernel<<<rows_want < 1 ? 1 : rows_want < rows_cap
                                                    ? rows_want
                                                    : rows_cap,
                            kThreads, 0, s>>>(start, order, ntiles, row_tile,
                                              next);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the resident warps, each taking faces from the counter
  const int want = (nseg + kWarps - 1) / kWarps;
  const int cap = sms * (per_sm > 0 ? per_sm : 1);
  tex_scatter_kernel<<<want < cap ? want : cap, kThreads, 0, s>>>(
      fim, first, row_tile, next, nseg, nf, is, nt, ts, m, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
