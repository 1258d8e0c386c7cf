// Side-norm distinct-x counts of the mixture reweight, for Hopper (sm_90a).
//
// Replaces the TPU kernel gnn_track_finding_tpu/ops/pallas_distinct.py
// (_kernel, entered through distinct_counts_tile).  Per node (one row of
// the (N, K) in-edge table) and side (left = x < node_x), count the
// DISTINCT raw x values among the ok slots: slot i counts when it is ok
// and no earlier ok slot j < i holds the same x on the same side
// (the len(set()) of helper.py:127-134; NaN is never equal, so each NaN
// counts, on the right).  Output (N, 2) in the x dtype.
//
// What bounds it on the card: memory, and mostly the ok table.  At the
// full event 10,102 of 57,344 rows hold any ok slot, 18,978 ok cells of
// 3.67 M, at most 12 in a row, so the K ok bytes per row are the bytes
// that matter; x and node_x are read only where a slot is ok.  All rows
// fit in one wave, so the kernel takes as long as its slowest row's chain
// of dependent loads.  Design: one thread per row turns the row's ok bytes
// into one 64-bit mask per 64 slots, with 16-byte vector loads where the
// rows are 16-byte aligned (K % 16 == 0); a row with an empty mask writes
// (0, 0) and reads nothing else; a row of at most 64 slots with at most
// kHeld ok slots loads the x of its ok slots all at once into registers
// (an unrolled walk of the set bits, __ffsll) and compares them there; any
// other row walks its set bits serially.  Any K works.  No shared memory,
// no atomics, integer-exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHeld = 16;   // ok slots a thread holds in registers

// Bit t of the result = byte t of w is nonzero, for the 4 bytes of w.
__device__ __forceinline__ uint32_t byte_bits(uint32_t w) {
  // the 0/1 bytes at bits 0, 8, 16, 24 land at bits 24..27 of the product,
  // every cross term below bit 24 or beyond bit 31
  return (((w | (w >> 1) | (w >> 2) | (w >> 3) | (w >> 4) | (w >> 5) |
            (w >> 6) | (w >> 7)) & 0x01010101u) * 0x01020408u) >> 24;
}

// ok flags of slots [64 w, 64 w + 64) of a row, as a bit mask.
__device__ __forceinline__ uint64_t ok_mask(const uint8_t* okr, int w, int k,
                                            bool vec) {
  const int base = 64 * w;
  const int len = min(64, k - base);
  uint64_t m = 0;
  if (vec) {  // len is a multiple of 16, the row 16-byte aligned
    for (int c = 0; c < len / 16; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(okr + base + 16 * c);
      const uint64_t bits = byte_bits(v.x) | (byte_bits(v.y) << 4) |
                            (byte_bits(v.z) << 8) | (byte_bits(v.w) << 12);
      m |= bits << (16 * c);
    }
  } else {
    for (int t = 0; t < len; ++t)
      if (okr[base + t]) m |= 1ull << t;
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    distinct_counts_kernel(const T* __restrict__ x,
                           const uint8_t* __restrict__ ok,
                           const T* __restrict__ node_x, T* __restrict__ out,
                           int n, int k, bool vec) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const uint8_t* okr = ok + (size_t)r * k;
  const T* xr = x + (size_t)r * k;
  const int words = (k + 63) / 64;
  int n_ok = 0;
  uint64_t m0 = 0;
  for (int w = 0; w < words; ++w) {
    const uint64_t m = ok_mask(okr, w, k, vec);
    if (w == 0) m0 = m;
    n_ok += __popcll(m);
  }
  int count_left = 0;
  int count_right = 0;
  if (n_ok > 0) {
    const T nx = node_x[r];
    if (words == 1 && n_ok <= kHeld) {
      // the x of the ok slots, in slot order, loaded together
      T xv[kHeld];
      uint64_t m = m0;
#pragma unroll
      for (int t = 0; t < kHeld; ++t) {
        if (t < n_ok) xv[t] = xr[__ffsll((long long)m) - 1];
        m &= m - 1;
      }
#pragma unroll
      for (int t = 0; t < kHeld; ++t) {
        if (t < n_ok) {
          const bool left = xv[t] < nx;
          bool dup = false;
#pragma unroll
          for (int u = 0; u < t; ++u)
            dup |= (xv[u] == xv[t]) && ((xv[u] < nx) == left);
          if (!dup) {
            if (left)
              ++count_left;
            else
              ++count_right;
          }
        }
      }
    } else {
      for (int w = 0; w < words; ++w) {
        const uint64_t mw = w ? ok_mask(okr, w, k, vec) : m0;
        for (uint64_t m = mw; m; m &= m - 1) {
          const int b = __ffsll((long long)m) - 1;
          const T xi = xr[64 * w + b];
          const bool left = xi < nx;
          bool dup = false;
          // earlier ok slots: the lower bits of this word, earlier words
          for (uint64_t e = mw & ((1ull << b) - 1); e && !dup; e &= e - 1) {
            const T xj = xr[64 * w + __ffsll((long long)e) - 1];
            dup = (xj == xi) && ((xj < nx) == left);
          }
          for (int v = 0; v < w && !dup; ++v) {
            for (uint64_t e = ok_mask(okr, v, k, vec); e && !dup;
                 e &= e - 1) {
              const T xj = xr[64 * v + __ffsll((long long)e) - 1];
              dup = (xj == xi) && ((xj < nx) == left);
            }
          }
          if (!dup) {
            if (left)
              ++count_left;
            else
              ++count_right;
          }
        }
      }
    }
  }
  out[2 * (size_t)r] = (T)count_left;
  out[2 * (size_t)r + 1] = (T)count_right;
}

template <typename T>
int launch(const void* x, const void* ok, const void* node_x, void* out,
           int n, int k, void* stream) {
  if (n > 0 && k > 0) {
    const bool vec = k % 16 == 0 && (uintptr_t)ok % 16 == 0;
    const int blocks = (n + kThreads - 1) / kThreads;
    distinct_counts_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const uint8_t*)ok, (const T*)node_x, (T*)out, n, k, vec);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* out) {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, distinct_counts_kernel<T>, kThreads, 0);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = 0;
  return (int)rc;
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

extern "C" int distinct_counts_occupancy_f32(int* out) {
  return occupancy<float>(out);
}

extern "C" int distinct_counts_occupancy_f64(int* out) {
  return occupancy<double>(out);
}
