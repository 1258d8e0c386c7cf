// GMR clustering core (Gaussian-mixture reduction per node), for Hopper (sm_90a).
//
// Replaces the TPU kernel gnn_track_finding_tpu/ops/pallas_cluster.py
// (_kernel, entered through cluster_tile).  Per compacted row (one gated
// node) over its n member slots (the leading non-negative edge ids of its
// row of the compacted table; n <= kc <= 32):
//   (a) the pairwise chi2 of every slot pair i > j: Mahalanobis distance
//       on the joint [a, b] block plus a delta-tau term whose sigmas are
//       endcap dependent (the X coordinate is tested under bug_compat);
//       zero chi2 is excluded (clustering.py:11-141, 411-413);
//   (b) the minimum pair, first (i, j) in flat order i * kc + j on ties;
//   (c) found = best < chi2_thr & isfinite(best), and no NaN pair;
//   (d) the inverse-variance merge of that pair for the parabolic and the
//       joint states, plus the sum of their priors;
//   (e) greedy steps, each absorbing the lowest-slot KL argmin while KL <
//       the row's threshold (elementwise trace under bug_compat); a NaN KL
//       stops the row;
//   (f) deact = member slots left unabsorbed in a found row.
// The arithmetic is that of the plain version (cluster_kernel.py, the port
// of clustering._cluster_core_xla) operation for operation; with nvcc's
// -fmad=false nothing is contracted, so float64 results are bitwise those
// of the plain version on the card.
//
// Inputs: the round's per-edge state tensors, each with its row stride in
// elements (rows contiguous): p_sv (E, 3), p_cov (E, 3, 3), j_sv (E, 3),
// j_cov (E, 3, 3), prior (E,), xyzr (E, 4) (a strided view in the seed
// round); tab (rows, kc) int64 edge ids; nodex (rows, 4), klthr (rows,);
// live, one int64 in device memory (or null: every row): the rows at or
// past it hold no member, so the grid can cover a static row capacity
// while the count of gated rows is known only on the device.
// Outputs: found (rows,) u8, pm (rows, 3), pc (rows, 9), mprior (rows,),
// deact (rows, kc) u8.  Rows not found get zero outputs.
//
// What bounds it on the card: by the bytes these inputs need (the member
// slots' joint states and coordinates, the p-states of the merged slots)
// it is memory, but it runs far from that bound, held by float64
// instruction throughput and latency: every 3x3 inverse is nine IEEE
// divisions, and a found row's chain is three inverses deep before its
// first greedy step (PERF.md).
// Design:
//   - a group of G lanes per row (G = 8; 4 measured slower), 32 / G rows
//     per warp, so the row's scalar chain runs on G lanes, not 32; every
//     reduction is a segmented shuffle over the group (width G) and every
//     sync names the group's lanes only, so rows of one warp diverge
//     freely;
//   - only the n member slots are read, only the n(n-1)/2 real pairs
//     enumerated, and the per-slot phases run over n (lanes loop when
//     n > G); rows not found leave after the chi2 phase;
//   - the slot fields are read straight from the per-edge tensors through
//     the row's edge ids (no packed copy); the p-states are read only for
//     the slots that are merged;
//   - shared memory holds, per slot, what later phases read: j_sv, j_cov,
//     and the chi2 terms that the inverse of j_cov overwrites when the row
//     is found; per row, the merged joint state that the KL step reads;
//   - the best pair's two parabolic inverses are tasks of the round that
//     inverts the member joint covariances, a lane each; then even lanes
//     carry the parabolic merge and odd lanes the joint merge, the same
//     instructions on other data, so each merge step costs one inverse,
//     not two.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by cluster_kernel._Args (ctypes).
struct ClusterArgs {
  const void *tab, *p_sv, *p_cov, *j_sv, *j_cov, *prior, *xyzr, *nodex,
      *klthr, *live;
  void *found, *pm, *pc, *mprior, *deact;
  long long tab_stride, p_sv_stride, p_cov_stride, j_sv_stride,
      j_cov_stride, prior_stride, xyzr_stride;
  int rows, kc, bug_compat;
  double chi2_thr, endcap, s_rz, s_rz2;
};

namespace {

// lanes per row: 8 (4 lanes per row measured 45% slower on the H100 at
// float64, seed round of the full event; PERF.md)
constexpr int kGroup = 8;
constexpr int kThreads = 64;     // threads per block: 64 / kGroup rows
// resident blocks the register allocation must allow: 8 caps a thread at
// 65536 / (8 * 64) = 128 registers (ptxas uses 122 at float64, no
// spills); caps of 9, 10 and 12 blocks spilled or ran slower (PERF.md)
constexpr int kMinBlocks = 8;
// per slot: j_sv 0:3 | j_cov 3:12 | inv(j_cov) 12:21, where 12:17 first
// hold the chi2 terms inv_b, tau, j5, sz^2, sr^2.  Per row, one more
// record: first inv(p_cov) 0:9 | p_sv 9:12 of the best pair's slot i0,
// the same of i1 at 12:24, their priors at 24:26; in the greedy loop the
// merged joint state jm 0:3 | jc 3:12 | inv(jc) 12:21.
constexpr int kSlotWords = 21;
constexpr int kRowWords = 26;

template <typename T>
__device__ __forceinline__ void inv3(const T* m, T* out) {
  const T a = m[0], b = m[1], c = m[2];
  const T d = m[3], e = m[4], f = m[5];
  const T g = m[6], h = m[7], i = m[8];
  const T det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
  out[0] = (e * i - f * h) / det;
  out[1] = (c * h - b * i) / det;
  out[2] = (b * f - c * e) / det;
  out[3] = (f * g - d * i) / det;
  out[4] = (a * i - c * g) / det;
  out[5] = (c * d - a * f) / det;
  out[6] = (d * h - e * g) / det;
  out[7] = (b * g - a * h) / det;
  out[8] = (a * e - b * d) / det;
}

template <typename T>
__device__ __forceinline__ void mat3_vec(const T* m, const T* v, T* out) {
  out[0] = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
  out[1] = m[3] * v[0] + m[4] * v[1] + m[5] * v[2];
  out[2] = m[6] * v[0] + m[7] * v[1] + m[8] * v[2];
}

// Inverse-variance merge from inverses i1, i2 and inverse-times-means
// mv1, mv2 (linalg.merge_gaussians): mc = inv3(i1 + i2), mm = mc (mv1 + mv2).
template <typename T>
__device__ __forceinline__ void merge_pre(const T* i1, const T* mv1,
                                          const T* i2, const T* mv2,
                                          T* mm, T* mc) {
  T s[9];
  for (int d = 0; d < 9; ++d) s[d] = i1[d] + i2[d];
  inv3(s, mc);
  T t[3];
  for (int d = 0; d < 3; ++d) t[d] = mv1[d] + mv2[d];
  mat3_vec(mc, t, mm);
}

// The inverse of cov and inverse-times-mean of one state.
template <typename T>
__device__ __forceinline__ void inv_ivm(const T* cov, const T* sv, T* inv,
                                        T* ivm) {
  inv3(cov, inv);
  mat3_vec(inv, sv, ivm);
}

// linalg.kl_distance(mean1, cov1, mean2, cov2) with i1 = inv3(cov1) and
// i2 = inv3(cov2) precomputed.
template <typename T>
__device__ __forceinline__ T kl_pre(const T* mean1, const T* cov1, const T* i1,
                                    const T* mean2, const T* cov2, const T* i2,
                                    bool bug_compat) {
  T dc[9], di[9];
  for (int d = 0; d < 9; ++d) {
    dc[d] = cov1[d] - cov2[d];
    di[d] = i2[d] - i1[d];
  }
  T trace;
  if (bug_compat) {
    trace = dc[0] * di[0] + dc[4] * di[4] + dc[8] * di[8];
  } else {
    trace = dc[0] * di[0];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        if (r || c) trace = trace + dc[3 * r + c] * di[3 * c + r];
  }
  const T d0 = mean1[0] - mean2[0];
  const T d1 = mean1[1] - mean2[1];
  const T d2 = mean1[2] - mean2[2];
  T s[9];
  for (int d = 0; d < 9; ++d) s[d] = i1[d] + i2[d];
  const T quad = d0 * (s[0] * d0 + s[1] * d1 + s[2] * d2) +
                 d1 * (s[3] * d0 + s[4] * d1 + s[5] * d2) +
                 d2 * (s[6] * d0 + s[7] * d1 + s[8] * d2);
  return trace + quad;
}

// (value, index) argmin over the G lanes of a group: the smaller value
// wins, ties go to the smaller index; every lane of the group ends with
// the result.
template <typename T, int G>
__device__ __forceinline__ void group_argmin(unsigned mask, T& val, int& idx) {
  for (int off = G / 2; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(mask, val, off, G);
    const int oi = __shfl_xor_sync(mask, idx, off, G);
    if (ov < val || (ov == val && oi < idx)) {
      val = ov;
      idx = oi;
    }
  }
}

template <typename T>
struct Params {
  const int64_t* tab;
  const T *p_sv, *p_cov, *j_sv, *j_cov, *prior, *xyzr, *nodex, *klthr;
  const int64_t* live;
  uint8_t* found;
  T *pm, *pc, *mprior;
  uint8_t* deact;
  long long tab_stride, p_sv_stride, p_cov_stride, j_sv_stride,
      j_cov_stride, prior_stride, xyzr_stride;
  int rows, kc;
  bool bug;
  T chi2_thr, endcap, s_rz, s_rz2;
};

template <typename T>
size_t smem_bytes(int kc) {
  return (size_t)(kThreads / kGroup) * (kc * kSlotWords + kRowWords) *
         sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gmr_cluster_kernel(const Params<T> p) {
  constexpr int G = kGroup;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kc = p.kc;
  const int lane = threadIdx.x & 31;
  const int l = lane & (G - 1);                    // lane in the group
  const int first = lane & ~(G - 1);               // group's first lane
  const unsigned gmask = ((1u << G) - 1u) << first;
  const int rib = threadIdx.x / G;                 // row in the block
  const int row = blockIdx.x * (kThreads / G) + rib;
  if (row >= p.rows) return;  // uniform across the group
  const bool bug = p.bug;
  T* slots = reinterpret_cast<T*>(smem_raw) +
             (size_t)rib * (kc * kSlotWords + kRowWords);
  T* pub = slots + kc * kSlotWords;                // the row record
  const int64_t* tab = p.tab + (size_t)row * p.tab_stride;

  // ---- member count: the leading non-negative ids; none past the live
  //      rows (such a row leaves through the not-found branch) ----
  int n = kc;
  if (p.live && row >= *p.live) n = 0;
  for (int base = 0; base < n; base += G) {
    const int s = base + l;
    const bool member = s < kc && tab[s] >= 0;
    const unsigned miss = (__ballot_sync(gmask, !member) & gmask) >> first;
    if (miss) {
      n = base + __ffs(miss) - 1;
      break;
    }
  }

  // ---- member slots into shared memory, with their chi2 terms ----
  const T* nx = p.nodex + (size_t)row * 4;
  const T xa = nx[0], za = nx[2], ra = nx[3];
  const T kl_thr = p.klthr[row];
  const T endcap = p.endcap, s_rz = p.s_rz, s_rz2 = p.s_rz2;
  for (int s = l; s < n; s += G) {
    const long long e = tab[s];
    T* d = slots + s * kSlotWords;
    const T* jsv = p.j_sv + e * p.j_sv_stride;
    const T* jcv = p.j_cov + e * p.j_cov_stride;
    const T* xyzr = p.xyzr + e * p.xyzr_stride;
    for (int c = 0; c < 3; ++c) d[c] = jsv[c];
    for (int c = 0; c < 9; ++c) d[3 + c] = jcv[c];
    const T cn = bug ? xyzr[0] : xyzr[2];
    const bool ec = fabs(cn) >= endcap;
    const T sz = ec ? s_rz : s_rz2;
    const T sr = ec ? s_rz2 : s_rz;
    const T inv_b = T(1) / (xyzr[3] - ra);
    const T dz = xyzr[2] - za;
    d[12] = inv_b;
    d[13] = dz * inv_b;              // tau
    d[14] = -dz * inv_b * inv_b;     // j5 of the slot as state i (-j6 as j)
    d[15] = sz * sz;
    d[16] = sr * sr;
  }
  __syncwarp(gmask);

  // ---- pairwise chi2 minimum over the n(n-1)/2 real pairs ----
  const T ca = bug ? xa : za;
  const bool ea = fabs(ca) >= endcap;
  const T sza = ea ? s_rz : s_rz2;
  const T sra = ea ? s_rz2 : s_rz;
  const T sza2 = sza * sza, sra2 = sra * sra;
  const T inf = (T)INFINITY;
  T best = inf;
  int best_idx = INT_MAX;
  bool any_nan = false;
  const int npairs = n * (n - 1) / 2;
  // pair q = i(i-1)/2 + j (j < i), in flat order; lane l takes q = l + tG
  int i = 1, j = l;
  while (j >= i) { j -= i; ++i; }
  for (int q = l; q < npairs; q += G) {
    const T* si = slots + i * kSlotWords;
    const T* sj = slots + j * kSlotWords;
    // [a, b] block of the joint states
    const T da = si[0] - sj[0];
    const T db = si[1] - sj[1];
    const T c00 = si[3] + sj[3];
    const T c01 = si[4] + sj[4];
    const T c10 = si[6] + sj[6];
    const T c11 = si[7] + sj[7];
    const T idet = T(1) / (c00 * c11 - c01 * c10);
    const T d1 = (da * (c11 * da - c01 * db) + db * (c00 * db - c10 * da)) * idet;
    // delta-tau
    const T j2 = si[12];
    const T j3 = -sj[12];
    const T j1 = -j3 - j2;
    const T j5 = si[14];
    const T j6 = -sj[14];
    const T j4 = -j5 - j6;
    const T var_dt = j1 * j1 * sza2 + j2 * j2 * si[15] + j3 * j3 * sj[15] +
                     j4 * j4 * sra2 + j5 * j5 * si[16] + j6 * j6 * sj[16];
    const T dt = si[13] - sj[13];
    T chi2 = d1 + dt * dt / var_dt;
    if (chi2 == T(0)) chi2 = inf;
    if (isnan(chi2)) {
      any_nan = true;
    } else if (chi2 < best) {
      best = chi2;
      best_idx = i * kc + j;
    }
    j += G;
    while (j >= i) { j -= i; ++i; }
  }
  group_argmin<T, G>(gmask, best, best_idx);
  any_nan = (__ballot_sync(gmask, any_nan) & gmask) != 0;
  const bool found = !any_nan && best < p.chi2_thr && isfinite(best);

  T* pm_row = p.pm + (size_t)row * 3;
  T* pc_row = p.pc + (size_t)row * 9;
  uint8_t* deact_row = p.deact + (size_t)row * kc;
  if (!found) {
    if (l == 0) {
      p.found[row] = 0;
      for (int d = 0; d < 3; ++d) pm_row[d] = T(0);
      for (int d = 0; d < 9; ++d) pc_row[d] = T(0);
      p.mprior[row] = T(0);
    }
    for (int s = l; s < kc; s += G) deact_row[s] = 0;
    return;
  }

  const int i0 = best_idx / kc;
  const int i1 = best_idx % kc;
  const long long e0 = tab[i0], e1 = tab[i1];

  // ---- inverses, one task per lane: the member joint covariances (the
  //      KL step's i1) and the best pair's parabolic covariances ----
  __syncwarp(gmask);  // the group is done with the chi2 terms
  for (int t = l; t < n + 2; t += G) {
    const long long e = t == n ? e0 : e1;
    const bool slot = t < n;
    inv3(slot ? slots + t * kSlotWords + 3 : p.p_cov + e * p.p_cov_stride,
         slot ? slots + t * kSlotWords + 12 : pub + 12 * (t - n));
    if (!slot) {
      for (int d = 0; d < 3; ++d)
        pub[12 * (t - n) + 9 + d] = p.p_sv[e * p.p_sv_stride + d];
      pub[24 + t - n] = p.prior[e * p.prior_stride];
    }
  }
  __syncwarp(gmask);

  // ---- merge of the best pair: even lanes parabolic, odd lanes joint ----
  const bool joint = l & 1;
  T m[3], c[9];
  {
    const T* ia = joint ? slots + i0 * kSlotWords + 12 : pub;
    const T* sa = joint ? slots + i0 * kSlotWords : pub + 9;
    const T* ib = joint ? slots + i1 * kSlotWords + 12 : pub + 12;
    const T* sb = joint ? slots + i1 * kSlotWords : pub + 21;
    T va[3], vb[3];
    mat3_vec(ia, sa, va);
    mat3_vec(ib, sb, vb);
    merge_pre(ia, va, ib, vb, m, c);
  }
  T mprior = pub[24] + pub[25];
  __syncwarp(gmask);  // the row record is read before the loop rewrites it
  auto cov_of = [&](int s, long long e) -> const T* {
    return joint ? slots + s * kSlotWords + 3 : p.p_cov + e * p.p_cov_stride;
  };
  auto sv_of = [&](int s, long long e) -> const T* {
    return joint ? slots + s * kSlotWords : p.p_sv + e * p.p_sv_stride;
  };
  unsigned remaining = (n == 32 ? 0xffffffffu : (1u << n) - 1u) &
                       ~(1u << i0) & ~(1u << i1);

  // ---- greedy KL absorption ----
  while (remaining) {
    T i2[9];
    inv3(c, i2);  // even lanes inv(pc), odd lanes inv(jc)
    if (l == 1) {
      for (int d = 0; d < 3; ++d) pub[d] = m[d];
      for (int d = 0; d < 9; ++d) pub[3 + d] = c[d];
      for (int d = 0; d < 9; ++d) pub[12 + d] = i2[d];
    }
    __syncwarp(gmask);
    T kl = inf;
    int kidx = INT_MAX;
    bool nan_here = false;
    for (int s = l; s < n; s += G) {
      if (!((remaining >> s) & 1u)) continue;
      const T* d = slots + s * kSlotWords;
      const T v = kl_pre(d, d + 3, d + 12, pub, pub + 3, pub + 12, bug);
      if (isnan(v)) {
        nan_here = true;
      } else if (v < kl || kidx == INT_MAX) {
        kl = v;
        kidx = s;
      }
    }
    group_argmin<T, G>(gmask, kl, kidx);
    const bool nan_any = (__ballot_sync(gmask, nan_here) & gmask) != 0;
    __syncwarp(gmask);  // pub is read before the next step rewrites it
    if (nan_any || !(kl < kl_thr) || !isfinite(kl)) break;
    const int kb = kidx;
    const long long ek = tab[kb];
    T ik[9], vk[3], mv[3];
    inv_ivm(cov_of(kb, ek), sv_of(kb, ek), ik, vk);
    mat3_vec(i2, m, mv);
    merge_pre(ik, vk, i2, mv, m, c);
    mprior = p.prior[ek * p.prior_stride] + mprior;
    remaining &= ~(1u << kb);
  }

  if (l == 0) {  // an even lane: the parabolic state
    p.found[row] = 1;
    for (int d = 0; d < 3; ++d) pm_row[d] = m[d];
    for (int d = 0; d < 9; ++d) pc_row[d] = c[d];
    p.mprior[row] = mprior;
  }
  for (int s = l; s < kc; s += G)
    deact_row[s] = (uint8_t)((remaining >> s) & 1u);
}

template <typename T>
cudaError_t set_smem(size_t bytes) {
  // above the 48 KB default only after raising the kernel's dynamic limit
  static size_t limit = 48 * 1024;
  if (bytes <= limit) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      gmr_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (rc == cudaSuccess) limit = bytes;
  return rc;
}

template <typename T>
int launch(const ClusterArgs* args, void* stream) {
  const ClusterArgs& a = *args;
  if (a.kc < 2 || a.kc > 32) return (int)cudaErrorInvalidValue;
  if (a.rows <= 0) return (int)cudaGetLastError();
  Params<T> p;
  p.tab = (const int64_t*)a.tab;
  p.p_sv = (const T*)a.p_sv;
  p.p_cov = (const T*)a.p_cov;
  p.j_sv = (const T*)a.j_sv;
  p.j_cov = (const T*)a.j_cov;
  p.prior = (const T*)a.prior;
  p.xyzr = (const T*)a.xyzr;
  p.nodex = (const T*)a.nodex;
  p.klthr = (const T*)a.klthr;
  p.live = (const int64_t*)a.live;
  p.found = (uint8_t*)a.found;
  p.pm = (T*)a.pm;
  p.pc = (T*)a.pc;
  p.mprior = (T*)a.mprior;
  p.deact = (uint8_t*)a.deact;
  p.tab_stride = a.tab_stride;
  p.p_sv_stride = a.p_sv_stride;
  p.p_cov_stride = a.p_cov_stride;
  p.j_sv_stride = a.j_sv_stride;
  p.j_cov_stride = a.j_cov_stride;
  p.prior_stride = a.prior_stride;
  p.xyzr_stride = a.xyzr_stride;
  p.rows = a.rows;
  p.kc = a.kc;
  p.bug = a.bug_compat != 0;
  p.chi2_thr = (T)a.chi2_thr;
  p.endcap = (T)a.endcap;
  p.s_rz = (T)a.s_rz;
  p.s_rz2 = (T)a.s_rz2;
  const size_t smem = smem_bytes<T>(a.kc);
  const cudaError_t rc = set_smem<T>(smem);
  if (rc != cudaSuccess) return (int)rc;
  const int rows_per_block = kThreads / kGroup;
  const int blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  gmr_cluster_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int kc, int* out) {
  if (kc < 2 || kc > 32) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(kc);
  int blocks = 0;
  cudaError_t rc = set_smem<T>(smem);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, gmr_cluster_kernel<T>, kThreads, smem);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = (int)smem;
  out[3] = kGroup;
  return (int)rc;
}

}  // namespace

extern "C" int gmr_cluster_f32(const ClusterArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int gmr_cluster_f64(const ClusterArgs* args, void* stream) {
  return launch<double>(args, stream);
}

extern "C" int gmr_cluster_occupancy_f32(int kc, int* out) {
  return occupancy<float>(kc, out);
}

extern "C" int gmr_cluster_occupancy_f64(int kc, int* out) {
  return occupancy<double>(kc, out);
}
