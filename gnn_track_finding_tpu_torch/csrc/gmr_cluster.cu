// GMR clustering core (Gaussian-mixture reduction per node), for Hopper (sm_90a).
//
// Replaces the TPU kernel gnn_track_finding_tpu/ops/pallas_cluster.py
// (_kernel, entered through cluster_tile).  Per compacted row (one node
// with 3..15 member edge states), over its kc slots:
//   (a) the pairwise chi2 of every slot pair i > j: Mahalanobis distance
//       on the joint [a, b] block plus a delta-tau term whose sigmas are
//       endcap dependent (the X coordinate is tested under bug_compat);
//       zero chi2 is excluded (clustering.py:11-141, 411-413);
//   (b) the minimum pair, first (i, j) in flat order on ties;
//   (c) found = gate & best < chi2_thr & isfinite(best);
//   (d) the inverse-variance merge of that pair for the parabolic and the
//       joint states, plus the sum of their priors;
//   (e) kc - 2 greedy steps, each absorbing the first-argmin KL slot while
//       KL < the row's threshold (elementwise trace under bug_compat);
//   (f) deact = slots left unabsorbed in a found row.
// The arithmetic is that of the plain version (cluster_kernel.py, the port
// of clustering._cluster_core_xla) operation for operation; with nvcc's
// -fmad=false nothing is contracted, so float64 results are bitwise those
// of the plain version on the card.
//
// Input layout, node-major as the packed gather produces it:
//   pk     (rows, kc, 29)  [p_sv 0:3 | p_cov 3:12 | j_sv 12:15 | j_cov 15:24 |
//                           prior 24 | nb_xyzr 25:29]
//   nodex  (rows, 4), gate (rows,) u8, klthr (rows,), valid (rows, kc) u8
// Outputs: found (rows,) u8, pm (rows, 3), pc (rows, 9), mprior (rows,),
//          deact (rows, kc) u8.  Rows not found get zero outputs.
//
// What bounds it on the card: float64 arithmetic and latency, not memory
// (a row is kc * 29 values read once; the work is ~120 pair chi2 plus up
// to 14 x 16 KL evaluations and 3x3 inverses, all dependent chains).
// Design: one warp per row, so rows run independently across the SMs.  The
// warp copies the row's slots into shared memory with coalesced loads;
// lane k < kc computes slot k's 3x3 inverses and inverse-times-means once
// (the hoisting of pallas_cluster.py:213-222); the kc(kc-1)/2 pairs spread
// over the lanes and a warp shuffle reduction on (chi2, flat index) gives
// the first-occurrence argmin; in each greedy step lane k evaluates slot
// k's KL against the running merged state (computed redundantly by every
// lane, so no broadcast is needed) and a warp argmin picks the slot.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowWidth = 29;          // packed floats per slot
constexpr int kSlotWords = 29 + 24;    // + inv_p, ivm_p, inv_j, ivm_j
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kStaticSmemLimit = 48 * 1024;

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

// Inverse-variance merge from precomputed inverses i1, i2 and
// inverse-times-means mv1, mv2 (linalg.merge_gaussians):
// mc = inv3(i1 + i2), mm = mc (mv1 + mv2).
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

// (value, index) argmin across the warp: the smaller value wins, ties go
// to the smaller index.  The result is broadcast to every lane.
template <typename T>
__device__ __forceinline__ void warp_argmin(T& val, int& idx) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, val, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (ov < val || (ov == val && oi < idx)) {
      val = ov;
      idx = oi;
    }
  }
  val = __shfl_sync(0xffffffffu, val, 0);
  idx = __shfl_sync(0xffffffffu, idx, 0);
}

struct Params {
  int rows, kc;
  double chi2_thr, endcap, s_rz, s_rz2;
  int bug_compat;
};

template <typename T>
__global__ void gmr_cluster_kernel(const T* __restrict__ pk,
                                   const T* __restrict__ nodex,
                                   const uint8_t* __restrict__ gate,
                                   const T* __restrict__ klthr,
                                   const uint8_t* __restrict__ valid,
                                   Params p, uint8_t* __restrict__ found_out,
                                   T* __restrict__ pm_out,
                                   T* __restrict__ pc_out,
                                   T* __restrict__ mprior_out,
                                   uint8_t* __restrict__ deact_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kc = p.kc;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + wib;
  if (row >= p.rows) return;  // uniform across the warp
  const bool bug = p.bug_compat != 0;

  T* sm = reinterpret_cast<T*>(smem_raw) + (size_t)wib * kc * kSlotWords;
  T* raw = sm;                          // kc * 29
  T* inv_p = raw + kc * kRowWidth;      // kc * 9
  T* ivm_p = inv_p + kc * 9;            // kc * 3
  T* inv_j = ivm_p + kc * 3;            // kc * 9
  T* ivm_j = inv_j + kc * 9;            // kc * 3

  // ---- the row's slots into shared memory (coalesced) ----
  const T* src = pk + (size_t)row * kc * kRowWidth;
  for (int t = lane; t < kc * kRowWidth; t += 32) raw[t] = src[t];
  const uint8_t* vrow = valid + (size_t)row * kc;
  const unsigned valid_bits =
      __ballot_sync(0xffffffffu, lane < kc && vrow[lane < kc ? lane : 0]);
  __syncwarp();
  // invalid slots carry identity covariances (clustering.py:406-410)
  if (lane < kc && !((valid_bits >> lane) & 1u)) {
    T* s = raw + lane * kRowWidth;
    for (int d = 0; d < 9; ++d) {
      const T e = (d == 0 || d == 4 || d == 8) ? T(1) : T(0);
      s[3 + d] = e;
      s[15 + d] = e;
    }
  }
  __syncwarp();

  // ---- pairwise chi2 minimum ----
  const T xa = nodex[(size_t)row * 4 + 0];
  const T za = nodex[(size_t)row * 4 + 2];
  const T ra = nodex[(size_t)row * 4 + 3];
  const T endcap = (T)p.endcap;
  const T s_rz = (T)p.s_rz, s_rz2 = (T)p.s_rz2;
  const T ca = bug ? xa : za;
  const bool ea = fabs(ca) >= endcap;
  const T sza = ea ? s_rz : s_rz2;
  const T sra = ea ? s_rz2 : s_rz;
  const T inf = (T)INFINITY;

  T best = inf;
  int best_idx = 0;
  bool any_nan = false;
  const int npairs = kc * (kc - 1) / 2;
  for (int q = lane; q < npairs; q += 32) {
    int i = 1;
    while ((i * (i + 1)) / 2 <= q) ++i;
    const int j = q - (i * (i - 1)) / 2;
    if (!(((valid_bits >> i) & 1u) && ((valid_bits >> j) & 1u))) continue;
    const T* si = raw + i * kRowWidth;
    const T* sj = raw + j * kRowWidth;
    // [a, b] block of the joint states
    const T da = si[12] - sj[12];
    const T db = si[13] - sj[13];
    const T c00 = si[15] + sj[15];
    const T c01 = si[16] + sj[16];
    const T c10 = si[18] + sj[18];
    const T c11 = si[19] + sj[19];
    const T idet = T(1) / (c00 * c11 - c01 * c10);
    const T d1 = (da * (c11 * da - c01 * db) + db * (c00 * db - c10 * da)) * idet;
    // delta-tau from raw coordinates
    const T ci = bug ? si[25] : si[27];
    const T cj = bug ? sj[25] : sj[27];
    const bool ei = fabs(ci) >= endcap;
    const bool ej = fabs(cj) >= endcap;
    const T szi = ei ? s_rz : s_rz2, sri = ei ? s_rz2 : s_rz;
    const T szj = ej ? s_rz : s_rz2, srj = ej ? s_rz2 : s_rz;
    const T inv_bi = T(1) / (si[28] - ra);
    const T inv_bj = T(1) / (sj[28] - ra);
    const T dzi = si[27] - za;
    const T dzj = sj[27] - za;
    const T tau_i = dzi * inv_bi;
    const T tau_j = dzj * inv_bj;
    const T j2 = inv_bi;
    const T j3 = -inv_bj;
    const T j1 = -j3 - j2;
    const T j5 = -dzi * inv_bi * inv_bi;
    const T j6 = dzj * inv_bj * inv_bj;
    const T j4 = -j5 - j6;
    const T var_dt = j1 * j1 * (sza * sza) + j2 * j2 * (szi * szi) +
                     j3 * j3 * (szj * szj) + j4 * j4 * (sra * sra) +
                     j5 * j5 * (sri * sri) + j6 * j6 * (srj * srj);
    const T dt = tau_i - tau_j;
    T chi2 = d1 + dt * dt / var_dt;
    if (chi2 == T(0)) chi2 = inf;
    if (isnan(chi2)) {
      any_nan = true;
    } else if (chi2 < best) {
      best = chi2;
      best_idx = i * kc + j;
    }
  }
  warp_argmin(best, best_idx);
  any_nan = __any_sync(0xffffffffu, any_nan);
  const bool found = gate[row] && !any_nan && best < (T)p.chi2_thr &&
                     isfinite(best);

  T* pm_row = pm_out + (size_t)row * 3;
  T* pc_row = pc_out + (size_t)row * 9;
  uint8_t* deact_row = deact_out + (size_t)row * kc;
  if (!found) {
    if (lane == 0) {
      found_out[row] = 0;
      for (int d = 0; d < 3; ++d) pm_row[d] = T(0);
      for (int d = 0; d < 9; ++d) pc_row[d] = T(0);
      mprior_out[row] = T(0);
    }
    if (lane < kc) deact_row[lane] = 0;
    return;
  }

  // ---- per-slot inverses and inverse-times-means, once ----
  if (lane < kc) {
    const T* s = raw + lane * kRowWidth;
    inv3(s + 3, inv_p + lane * 9);
    mat3_vec(inv_p + lane * 9, s + 0, ivm_p + lane * 3);
    inv3(s + 15, inv_j + lane * 9);
    mat3_vec(inv_j + lane * 9, s + 12, ivm_j + lane * 3);
  }
  __syncwarp();

  // ---- merge of the best pair ----
  const int i0 = best_idx / kc;
  const int i1 = best_idx % kc;
  T pm[3], pc[9], jm[3], jc[9];
  merge_pre(inv_p + i0 * 9, ivm_p + i0 * 3, inv_p + i1 * 9, ivm_p + i1 * 3,
            pm, pc);
  merge_pre(inv_j + i0 * 9, ivm_j + i0 * 3, inv_j + i1 * 9, ivm_j + i1 * 3,
            jm, jc);
  T mprior = raw[i0 * kRowWidth + 24] + raw[i1 * kRowWidth + 24];
  unsigned remaining = valid_bits & ~(1u << i0) & ~(1u << i1);

  // ---- greedy KL absorption ----
  const T kl_thr = klthr[row];
  for (int step = 0; step < kc - 2; ++step) {
    T i2j[9], i2p[9];
    inv3(jc, i2j);
    inv3(pc, i2p);
    T kl = inf;
    int kidx = 32;
    bool nan_here = false;
    if (lane < kc && ((remaining >> lane) & 1u)) {
      const T* s = raw + lane * kRowWidth;
      kl = kl_pre(s + 12, s + 15, inv_j + lane * 9, jm, jc, i2j, bug);
      kidx = lane;
      if (isnan(kl)) {
        nan_here = true;
        kl = inf;
      }
    }
    warp_argmin(kl, kidx);
    const bool nan_any = __any_sync(0xffffffffu, nan_here);
    if (nan_any || !(kl < kl_thr) || !isfinite(kl)) break;
    const int kb = kidx;
    T mv[3];
    mat3_vec(i2p, pm, mv);
    merge_pre(inv_p + kb * 9, ivm_p + kb * 3, i2p, mv, pm, pc);
    mat3_vec(i2j, jm, mv);
    merge_pre(inv_j + kb * 9, ivm_j + kb * 3, i2j, mv, jm, jc);
    mprior = raw[kb * kRowWidth + 24] + mprior;
    remaining &= ~(1u << kb);
  }

  if (lane == 0) {
    found_out[row] = 1;
    for (int d = 0; d < 3; ++d) pm_row[d] = pm[d];
    for (int d = 0; d < 9; ++d) pc_row[d] = pc[d];
    mprior_out[row] = mprior;
  }
  if (lane < kc) deact_row[lane] = (uint8_t)((remaining >> lane) & 1u);
}

template <typename T>
int launch(const void* pk, const void* nodex, const void* gate,
           const void* klthr, const void* valid, int rows, int kc,
           double chi2_thr, double endcap, double s_rz, double s_rz2,
           int bug_compat, void* found, void* pm, void* pc, void* mprior,
           void* deact, void* stream) {
  if (kc < 2 || kc > 32) return (int)cudaErrorInvalidValue;
  if (rows > 0) {
    const size_t per_warp = (size_t)kc * kSlotWords * sizeof(T);
    int warps = (int)(kStaticSmemLimit / per_warp);
    if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
    if (warps < 1) warps = 1;
    const int blocks = (rows + warps - 1) / warps;
    Params p{rows, kc, chi2_thr, endcap, s_rz, s_rz2, bug_compat};
    gmr_cluster_kernel<T><<<blocks, warps * 32, warps * per_warp,
                            (cudaStream_t)stream>>>(
        (const T*)pk, (const T*)nodex, (const uint8_t*)gate,
        (const T*)klthr, (const uint8_t*)valid, p, (uint8_t*)found,
        (T*)pm, (T*)pc, (T*)mprior, (uint8_t*)deact);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gmr_cluster_f32(const void* pk, const void* nodex,
                               const void* gate, const void* klthr,
                               const void* valid, int rows, int kc,
                               double chi2_thr, double endcap, double s_rz,
                               double s_rz2, int bug_compat, void* found,
                               void* pm, void* pc, void* mprior, void* deact,
                               void* stream) {
  return launch<float>(pk, nodex, gate, klthr, valid, rows, kc, chi2_thr,
                       endcap, s_rz, s_rz2, bug_compat, found, pm, pc, mprior,
                       deact, stream);
}

extern "C" int gmr_cluster_f64(const void* pk, const void* nodex,
                               const void* gate, const void* klthr,
                               const void* valid, int rows, int kc,
                               double chi2_thr, double endcap, double s_rz,
                               double s_rz2, int bug_compat, void* found,
                               void* pm, void* pc, void* mprior, void* deact,
                               void* stream) {
  return launch<double>(pk, nodex, gate, klthr, valid, rows, kc, chi2_thr,
                        endcap, s_rz, s_rz2, bug_compat, found, pm, pc,
                        mprior, deact, stream);
}
