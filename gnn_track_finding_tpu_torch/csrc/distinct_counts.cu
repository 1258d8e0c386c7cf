// Side-norm distinct-x counts of the mixture reweight, for Hopper (sm_90a).
//
// Replaces the TPU kernel gnn_track_finding_tpu/ops/pallas_distinct.py
// (_kernel, entered through distinct_counts_tile).  Per node (one row of
// the (N, K) in-edge table) and side (left = x < node_x), count the
// DISTINCT raw x values among the ok slots: slot i counts when it is ok
// and no earlier ok slot j < i holds the same x on the same side
// (the len(set()) of helper.py:127-134).  Output (N, 2) in the x dtype.
//
// What bounds it on the card: memory.  Each row is K x-values plus K flags
// (K = 64 at the full event: 576 bytes at f64) read once, and the K^2/2
// compares per row run from L1.  Design: one warp per node, so a row's
// loads are contiguous across the lanes; the warp walks the row in chunks
// of 32 slots (any K works), lane i compares its slot against every
// earlier slot, and each side's count is a __ballot_sync + __popc per
// chunk.  No shared memory, no atomics, integer-exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void distinct_counts_kernel(const T* __restrict__ x,
                                       const uint8_t* __restrict__ ok,
                                       const T* __restrict__ node_x,
                                       T* __restrict__ out, int n, int k) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n) return;  // uniform across the warp
  const T* xr = x + (size_t)warp * k;
  const uint8_t* okr = ok + (size_t)warp * k;
  const T nx = node_x[warp];
  int count_left = 0;
  int count_right = 0;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    bool first = false;
    bool left = false;
    if (i < k && okr[i]) {
      const T xi = xr[i];
      left = xi < nx;
      bool dup = false;
      for (int j = 0; j < i && !dup; ++j) {
        if (okr[j]) {
          const T xj = xr[j];
          dup = (xj == xi) && ((xj < nx) == left);
        }
      }
      first = !dup;
    }
    count_left += __popc(__ballot_sync(0xffffffffu, first && left));
    count_right += __popc(__ballot_sync(0xffffffffu, first && !left));
  }
  if (lane == 0) {
    out[2 * (size_t)warp] = (T)count_left;
    out[2 * (size_t)warp + 1] = (T)count_right;
  }
}

template <typename T>
int launch(const void* x, const void* ok, const void* node_x, void* out,
           int n, int k, void* stream) {
  if (n > 0) {
    const int threads = 256;  // 8 warps = 8 nodes per block
    const int blocks = (int)(((long long)n * 32 + threads - 1) / threads);
    distinct_counts_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const uint8_t*)ok, (const T*)node_x, (T*)out, n, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int distinct_counts_f32(const void* x, const void* ok,
                                   const void* node_x, void* out, int n, int k,
                                   void* stream) {
  return launch<float>(x, ok, node_x, out, n, k, stream);
}

extern "C" int distinct_counts_f64(const void* x, const void* ok,
                                   const void* node_x, void* out, int n, int k,
                                   void* stream) {
  return launch<double>(x, ok, node_x, out, n, k, stream);
}
