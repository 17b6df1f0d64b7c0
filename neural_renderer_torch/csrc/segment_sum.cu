// Segmented row sums for Hopper (sm_90a): the deterministic scatter of the
// vertex gradient (ops/vertices_to_faces.py) and of the texture gradient of
// cubes above ts 4 (rasterize/texture.py).
//
// Not a TPU kernel: the JAX package computes the same sums with XLA, as an
// incidence matmul (neural_renderer_tpu/ops/vertices_to_faces.py:66-78) or
// a scatter, and with segment_sum (neural_renderer_tpu/rasterize/
// texture.py:258-285).  The port's autograd scatter (index_put_ /
// index_add_ on the card) adds with float atomics in an order that changes
// from run to run; this kernel sums in a fixed order instead.
//
// out[s, c] = sum of rows[perm[i], c] over i in [offsets[s], offsets[s+1]),
// added in ascending i, where perm orders the rows by segment id, stable
// (torch.sort(stable=True) of the ids, which the caller makes and may keep
// across calls).  Rows whose id lies beyond the last segment are never
// read.  No float atomics: every run gives the same bits, equal to
// index_add_ adding the rows in order.
//
// Design.  A warp owns `spw` consecutive segments (a power of two up to
// 32, one a lane; the caller picks it from the mean segment length so that
// a warp's rows fill about one window), and their rows are one contiguous
// run of perm.  The warp walks that run in windows of kWindow rows: each
// lane gathers kRounds rows (perm read by neighbouring lanes at
// neighbouring addresses, all the window's loads in flight at once) and
// stages them in shared memory, up to kCols columns a row; then each
// segment's lane adds its rows of the window in ascending order, while
// the next window's rows and the perm entries of the one after are in
// flight.  So a
// segment with thousands of rows has its gathers spread over the warp and
// only its adds in series, as the fixed order requires, and a vertex's ~12
// rows cost a share of one window.  More than kCols columns take another
// walk.
//
// What bounds it on this card: the bytes, each row read once through its
// permutation (4 C bytes) with its 8-byte index, 8 bytes of offsets and 4 C
// bytes out per segment; a vertex has ~12 incident rows, a texture cell a
// few to thousands.  The adds are one f32 operation a read, in a chain per
// segment and column.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                 // columns staged per walk
constexpr int kRounds = 4;               // rows a lane gathers per window
constexpr int kWindow = 32 * kRounds;    // rows a warp stages per window
constexpr unsigned kFull = 0xffffffffu;

// perm entries [w0, w0 + kWindow) of a walk ending at r1 (-1 past it)
__device__ __forceinline__ void load_perm(const long long* __restrict__ perm,
                                          long long w0, long long r1,
                                          int lane, long long (&p)[kRounds]) {
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    const long long i = w0 + k * 32 + lane;
    p[k] = i < r1 ? perm[i] : -1;
  }
}

// columns c0 .. c0 + nc - 1 (nc <= kCols) of the rows p names
__device__ __forceinline__ void load_rows(const float* __restrict__ rows,
                                          const long long (&p)[kRounds],
                                          int C, int c0, int nc,
                                          float4 (&v)[kRounds]) {
#pragma unroll
  for (int k = 0; k < kRounds; ++k) {
    if (p[k] < 0) continue;
    const float* row = rows + p[k] * C + c0;
    v[k] = make_float4(row[0], nc > 1 ? row[1] : 0.0f,
                       nc > 2 ? row[2] : 0.0f, nc > 3 ? row[3] : 0.0f);
  }
}

__device__ __forceinline__ void add(float (&acc)[kCols], const float4& x) {
  acc[0] = acc[0] + x.x;
  acc[1] = acc[1] + x.y;
  acc[2] = acc[2] + x.z;
  acc[3] = acc[3] + x.w;
}

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ rows,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ offsets, long long nseg,
                   int C, int spw, float* __restrict__ out) {
  __shared__ float4 stage[kWarps][kWindow];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long s0 = ((long long)blockIdx.x * kWarps + w) * spw;
  if (s0 >= nseg) return;
  // this lane's segment and rows [a, b), and the warp's [r0, r1)
  const long long s = lane < spw ? s0 + lane : nseg;
  const long long a = offsets[s < nseg ? s : nseg];
  const long long b = offsets[s < nseg ? s + 1 : nseg];
  const long long r0 = __shfl_sync(kFull, a, 0);
  const long long r1 = __shfl_sync(kFull, b, spw - 1);
  float4* st = stage[w];
  for (int c0 = 0; c0 < C; c0 += kCols) {
    const int nc = C - c0 < kCols ? C - c0 : kCols;
    float acc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
    // rows of this window in registers, perm of the next one loaded
    long long p[kRounds];
    float4 v[kRounds];
    load_perm(perm, r0, r1, lane, p);
    load_rows(rows, p, C, c0, nc, v);
    load_perm(perm, r0 + kWindow, r1, lane, p);
    for (long long w0 = r0; w0 < r1; w0 += kWindow) {
#pragma unroll
      for (int k = 0; k < kRounds; ++k)
        if (w0 + k * 32 + lane < r1) st[k * 32 + lane] = v[k];
      __syncwarp();
      // the next window's loads fly while this one is summed
      load_rows(rows, p, C, c0, nc, v);
      load_perm(perm, w0 + 2 * kWindow, r1, lane, p);
      // this lane's rows of the window, as offsets into it
      const int lo = (int)((a > w0 ? a : w0) - w0);
      const int hi = (int)((b < w0 + kWindow ? b : w0 + kWindow) - w0);
      int i = lo;
      for (; i + 8 <= hi; i += 8) {
        float4 x[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) x[k] = st[i + k];
#pragma unroll
        for (int k = 0; k < 8; ++k) add(acc, x[k]);
      }
      for (; i < hi; ++i) add(acc, st[i]);
      __syncwarp();
    }
    if (s < nseg)
      for (int j = 0; j < nc; ++j) out[s * C + c0 + j] = acc[j];
  }
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rows [n, C] f32, perm [n] and offsets [nseg + 1] int64 on the device;
// out [nseg, C] f32.  Launches on `stream` and returns cudaGetLastError().
int nr_segment_sum(const float* rows, const long long* perm,
                   const long long* offsets, long long n, long long nseg,
                   int C, float* out, void* stream) {
  if (n < 0 || nseg < 0 || C < 1) return (int)cudaErrorInvalidValue;
  if (nseg == 0) return 0;
  // segments a warp: the most, up to 32, whose rows fill a window at the
  // mean length n / nseg
  int spw = 32;
  while (spw > 1 && (long long)spw * n > (long long)kWindow * nseg) spw /= 2;
  const long long per_block = (long long)kWarps * spw;
  const long long blocks = (nseg + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(rows, perm, offsets, nseg, C,
                                               spw, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
