// Close-proximity same-layer merge and row compaction of extraction's
// candidate rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves this analysis
// (gnn_track_finding_tpu/ops/extract.py, _proximity_merge) to XLA's
// fusion, which the port has no counterpart for: as torch ops
// (ops/extract.py, _proximity_merge then _compact_rows) it builds boolean
// (C, H, H) planes over every padded candidate row (same key, same key
// and earlier, the pair mask and its uint8 copy for argmax), reduces each
// over H and scatters the survivors to the front of each row, ~80 graph
// nodes an extraction; at the full event C = 14,400 and H = 32, so each
// plane holds 14.7 M entries for the 837-1,963 rows that have two or more
// hits (PERF.md).  Per candidate row (a row of ops/extract.py's
// _candidate_matrix: node indices radius-descending, -1 padded):
//   (a) the analysis (extract._proximity_merge): each slot's raw
//       coordinates and its key, volume * 1000 + layer (-1 - slot for an
//       empty slot); freq, how many valid slots share the key; is_first,
//       no earlier slot has it; the partner of a first slot, the next
//       slot with its key.  The row can be processed when no key repeats
//       (clean), or when some key is held twice, at most two keys are,
//       none thrice, and every such pair lies within node_merge_distance
//       (mergeable);
//   (b) the merge: on a mergeable row each pair's first slot takes the
//       pair's midpoint (x, y, z and the midpoint's r) and its partner
//       slot dies;
//   (c) the compaction (extract._compact_rows): the surviving slots moved
//       to the front, radius order kept, zeros after them.
// Outputs: coords_c (C, H, 4) contiguous, valid_c (C, H), n_hits,
// can_process and n_pairs (C,).  The plain ops' argmax gives a partner of
// 0 where none exists; it is read only where a pair leads, so it is not
// copied.
//
// Bitwise: the midpoint is an add then a multiply by 0.5, its r multiply,
// multiply, add, sqrt; the pair distance three subtracts, three
// multiplies, two adds (left to right) and a sqrt, as the torch ops
// order them; the file builds with -fmad=false (_build.FMAD), so nvcc
// contracts nothing into a fused multiply-add and each +, - and * is
// rounded once.  The
// distance test is `d3 <= node_merge_distance` with the threshold cast to
// the dtype, as torch casts a Python scalar.  The keys are int64 and
// compared over every slot, empty ones included, as the (C, H, H) planes
// compare them.
//
// What bounds it on the card: memory, and barely.  The compulsory bytes
// are ~22 MB a full-event extraction (mat 3.7 MB, the live slots' xyzr and
// vivl, coords_c 14.7 MB written) and ~145 MB for 32 stacked volume-7
// events, 0.007 and 0.043 ms at 3.35 TB/s.  Design, H <= 32: one warp a
// row, lane i holds slot i; the warp reads the row coalesced, and a row
// with no valid slot (most rows are padding) writes its zero outputs and
// leaves.  __match_any_sync on the key gives each slot's same-key mask:
// freq is its popcount over the valid slots, is_first says no lower lane
// is in it, the partner is its lowest lane above this one, whose
// coordinates come by __shfl_sync; the row's verdicts are ballots.  A
// surviving slot's place is the popcount of the survivors below it.
// H > 32 (allowed by the configuration, used by no committed cell): one
// warp a row, lane i holds slots i, i + 32, ..., the row's keys and flags
// in shared memory, each slot comparing its key with every other.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by merge_kernel._Args (ctypes).
struct MergeArgs {
  const void *mat, *xyzr, *vivl;
  void *coords_c, *valid_c, *n_hits, *can_process, *n_pairs;
  long long mat_stride, xyzr_stride, vivl_stride;  // row strides, in elements
  int rows, h;
  double merge_distance;
};

namespace {

constexpr int kWarps = 8;                  // rows per block, H <= 32
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
// shared bytes a slot of the H > 32 path takes: key, valid, lead, survives
constexpr int kWideSlotBytes = 8 + 3;

__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }

template <typename T>
struct Hit {
  T x, y, z, r;
};

// A slot's coordinates as the plain ops gather them: zero when empty.
template <typename T>
__device__ __forceinline__ Hit<T> load_hit(const MergeArgs& a, long long m) {
  if (m < 0) return {T(0), T(0), T(0), T(0)};
  const T* p = static_cast<const T*>(a.xyzr) + m * a.xyzr_stride;
  return {p[0], p[1], p[2], p[3]};
}

// vivl0 * 1000 + vivl1 in int64 (wrapping as torch's int64 ops do), or
// -1 - slot for an empty slot.
__device__ __forceinline__ long long slot_key(const MergeArgs& a, long long m,
                                              int slot) {
  if (m < 0) return -1 - (long long)slot;
  const long long* v = static_cast<const long long*>(a.vivl) + m * a.vivl_stride;
  return (long long)((unsigned long long)v[0] * 1000ull +
                     (unsigned long long)v[1]);
}

// sqrt(dd0 * dd0 + dd1 * dd1 + dd2 * dd2) of dd = c - p over x, y, z.
template <typename T>
__device__ __forceinline__ T distance3(const Hit<T>& c, const Hit<T>& p) {
  const T d0 = c.x - p.x, d1 = c.y - p.y, d2 = c.z - p.z;
  return root(d0 * d0 + d1 * d1 + d2 * d2);
}

// The midpoint 0.5 * (c + p) over x, y, z, and its r.
template <typename T>
__device__ __forceinline__ Hit<T> midpoint(const Hit<T>& c, const Hit<T>& p) {
  const T half = T(0.5);
  Hit<T> o;
  o.x = half * (c.x + p.x);
  o.y = half * (c.y + p.y);
  o.z = half * (c.z + p.z);
  o.r = root(o.x * o.x + o.y * o.y);
  return o;
}

template <typename T>
struct Vec4;
template <>
struct Vec4<double> {
  static __device__ __forceinline__ void store(double* p, const Hit<double>& v) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v.x, v.y);
    reinterpret_cast<double2*>(p)[1] = make_double2(v.z, v.r);
  }
};
template <>
struct Vec4<float> {
  static __device__ __forceinline__ void store(float* p, const Hit<float>& v) {
    *reinterpret_cast<float4*>(p) = make_float4(v.x, v.y, v.z, v.r);
  }
};

// The row's per-row outputs (lane 0 writes them).
__device__ __forceinline__ void row_scalars(const MergeArgs& a, int row,
                                            int n, bool can, int pairs) {
  static_cast<long long*>(a.n_hits)[row] = n;
  static_cast<uint8_t*>(a.can_process)[row] = can;
  static_cast<long long*>(a.n_pairs)[row] = pairs;
}

// Slots [n, h) of a row zeroed and its valid flags written.
template <typename T>
__device__ __forceinline__ void row_tail(const MergeArgs& a, int row, int lane,
                                         int n) {
  T* out = static_cast<T*>(a.coords_c) + (size_t)row * a.h * 4;
  uint8_t* vout = static_cast<uint8_t*>(a.valid_c) + (size_t)row * a.h;
  for (int s = lane; s < a.h; s += 32) {
    if (s >= n) Vec4<T>::store(out + 4 * s, {T(0), T(0), T(0), T(0)});
    vout[s] = s < n;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) row_merge_kernel(const MergeArgs a) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // the whole warp: row is the warp's
  const int h = a.h;
  const bool present = lane < h;
  const unsigned slots = h == 32 ? kFull : (1u << h) - 1;
  const unsigned below = (1u << lane) - 1;
  const long long m =
      present ? static_cast<const long long*>(a.mat)[row * a.mat_stride + lane]
              : -1;
  const bool valid = m >= 0;
  const unsigned valid_mask = __ballot_sync(kFull, valid);
  if (valid_mask == 0) {  // padding: no slot, clean, nothing to fit
    row_tail<T>(a, row, lane, 0);
    if (lane == 0) row_scalars(a, row, 0, true, 0);
    return;
  }

  const Hit<T> c = load_hit<T>(a, m);
  const unsigned same = __match_any_sync(kFull, slot_key(a, m, lane)) & slots;
  const int freq = valid ? __popc(same & valid_mask) : 0;
  const bool is_first = valid && (same & below) == 0;
  const bool lead = is_first && freq == 2;
  const unsigned later = same & ~below & ~(1u << lane);
  const int partner = later ? __ffs(later) - 1 : 0;
  Hit<T> p;
  p.x = __shfl_sync(kFull, c.x, partner);
  p.y = __shfl_sync(kFull, c.y, partner);
  p.z = __shfl_sync(kFull, c.z, partner);
  p.r = __shfl_sync(kFull, c.r, partner);
  const T threshold = (T)a.merge_distance;

  const bool has2 = __any_sync(kFull, freq == 2);
  const int layers_with_2 = __popc(__ballot_sync(kFull, lead));
  const bool has_ge3 = __any_sync(kFull, freq >= 3);
  const bool pairs_ok =
      __all_sync(kFull, !lead || distance3(c, p) <= threshold);
  const bool clean = !__any_sync(kFull, freq >= 2);
  const bool mergeable = has2 && layers_with_2 <= 2 && !has_ge3 && pairs_ok;
  const bool do_merge = mergeable && lead;
  // a slot dies when a merged lead below it shares its key
  const bool kill = (same & below & __ballot_sync(kFull, do_merge)) != 0;
  const bool survives = valid && !kill;
  const unsigned kept = __ballot_sync(kFull, survives);
  const int n = __popc(kept);
  if (survives) {
    T* out = static_cast<T*>(a.coords_c) + (size_t)row * h * 4;
    Vec4<T>::store(out + 4 * __popc(kept & below),
                   do_merge ? midpoint(c, p) : c);
  }
  row_tail<T>(a, row, lane, n);
  if (lane == 0)
    row_scalars(a, row, n, clean || mergeable, mergeable ? layers_with_2 : 0);
}

// H > 32: one warp a row (one block), lane i holds slots i, i + 32, ...
template <typename T>
__global__ void __launch_bounds__(32) row_merge_wide_kernel(const MergeArgs a) {
  extern __shared__ long long s_key[];
  const int h = a.h;
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_key + h);
  uint8_t* s_lead = s_valid + h;
  uint8_t* s_survives = s_lead + h;
  const int lane = threadIdx.x;
  const int row = blockIdx.x;
  const unsigned below = (1u << lane) - 1;
  const long long* mrow = static_cast<const long long*>(a.mat) + row * a.mat_stride;

  bool any_valid = false;
  for (int s = lane; s < h; s += 32) {
    const long long m = mrow[s];
    s_key[s] = slot_key(a, m, s);
    s_valid[s] = m >= 0;
    any_valid |= m >= 0;
  }
  if (!__any_sync(kFull, any_valid)) {
    row_tail<T>(a, row, lane, 0);
    if (lane == 0) row_scalars(a, row, 0, true, 0);
    return;
  }
  __syncwarp();

  // the first slot after i with i's key (0 if none, as argmax gives)
  auto partner_of = [&](int i) {
    for (int j = i + 1; j < h; ++j)
      if (s_key[j] == s_key[i]) return j;
    return 0;
  };
  const T threshold = (T)a.merge_distance;
  bool has2 = false, has_ge3 = false, pairs_ok = true, repeats = false;
  int layers_with_2 = 0;
  for (int i = lane; i < h; i += 32) {
    int freq = 0;
    bool dup_before = false;
    for (int j = 0; j < h; ++j) {
      if (s_key[j] != s_key[i]) continue;
      freq += s_valid[j];
      dup_before |= j < i;
    }
    if (!s_valid[i]) freq = 0;
    const bool lead = s_valid[i] && !dup_before && freq == 2;
    has2 |= freq == 2;
    has_ge3 |= freq >= 3;
    repeats |= freq >= 2;
    layers_with_2 += lead;
    if (lead)
      pairs_ok &= distance3(load_hit<T>(a, mrow[i]),
                            load_hit<T>(a, mrow[partner_of(i)])) <= threshold;
    s_lead[i] = lead;
  }
  has2 = __any_sync(kFull, has2);
  has_ge3 = __any_sync(kFull, has_ge3);
  pairs_ok = __all_sync(kFull, pairs_ok);
  const bool clean = !__any_sync(kFull, repeats);
  layers_with_2 = __reduce_add_sync(kFull, layers_with_2);
  const bool mergeable = has2 && layers_with_2 <= 2 && !has_ge3 && pairs_ok;
  __syncwarp();

  for (int j = lane; j < h; j += 32) {
    bool kill = false;
    for (int i = 0; i < j && mergeable; ++i)
      kill |= s_lead[i] && s_key[i] == s_key[j];
    s_survives[j] = s_valid[j] && !kill;
  }
  __syncwarp();

  T* out = static_cast<T*>(a.coords_c) + (size_t)row * h * 4;
  int n = 0;
  for (int base = 0; base < h; base += 32) {
    const int s = base + lane;
    const bool survives = s < h && s_survives[s];
    const unsigned kept = __ballot_sync(kFull, survives);
    if (survives) {
      Hit<T> c = load_hit<T>(a, mrow[s]);
      if (mergeable && s_lead[s])
        c = midpoint(c, load_hit<T>(a, mrow[partner_of(s)]));
      Vec4<T>::store(out + 4 * (n + __popc(kept & below)), c);
    }
    n += __popc(kept);
  }
  row_tail<T>(a, row, lane, n);
  if (lane == 0)
    row_scalars(a, row, n, clean || mergeable, mergeable ? layers_with_2 : 0);
}

template <typename T>
int launch(const MergeArgs* args, void* stream) {
  if (args->rows > 0) {
    if (args->h <= 32) {
      const int blocks = (args->rows + kWarps - 1) / kWarps;
      row_merge_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
    } else {
      row_merge_wide_kernel<T><<<args->rows, 32, args->h * kWideSlotBytes,
                                 (cudaStream_t)stream>>>(*args);
    }
  }
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* out) {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, row_merge_kernel<T>, kThreads, 0);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = 0;
  return (int)rc;
}

}  // namespace

extern "C" int row_merge_f32(const MergeArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int row_merge_f64(const MergeArgs* args, void* stream) {
  return launch<double>(args, stream);
}

extern "C" int row_merge_occupancy_f32(int* out) { return occupancy<float>(out); }

extern "C" int row_merge_occupancy_f64(int* out) { return occupancy<double>(out); }
