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
// read.  One thread per (segment, column): no float atomics, and every run
// gives the same bits, equal to index_add_ adding the rows in order.
//
// What bounds it on this card: the bytes, each row read once through its
// permutation (4 C bytes) with its 8-byte index, 8 bytes of offsets and 4 C
// bytes out per segment; a vertex has ~12 incident rows, a texture cell a
// few to thousands.  The adds are one f32 operation a read.  Its rows are
// gathered one word a thread, so it reads whole sectors for a word each; it
// is a first, simple kernel (one warp a segment would read contiguous rows).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ rows,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ offsets, long long nseg,
                   int C, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= nseg * C) return;
  const long long s = t / C;
  const int c = (int)(t - s * C);
  const long long end = offsets[s + 1];
  float acc = 0.0f;
  for (long long i = offsets[s]; i < end; ++i)
    acc = acc + rows[perm[i] * C + c];
  out[t] = acc;
}

}  // namespace

extern "C" {

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rows [n, C] f32, perm [n] and offsets [nseg + 1] int64 on the device;
// out [nseg, C] f32.  Launches on `stream` and returns cudaGetLastError().
int nr_segment_sum(const float* rows, const long long* perm,
                   const long long* offsets, long long nseg, int C,
                   float* out, void* stream) {
  if (nseg < 0 || C < 1) return (int)cudaErrorInvalidValue;
  const long long work = nseg * C;
  if (work == 0) return 0;
  const long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(rows, perm, offsets, nseg, C,
                                               out);
  return (int)cudaGetLastError();
}

}  // extern "C"
