// Innermost-edge rotation and two-plane Kalman track fit of extraction's
// candidate rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves this loop
// (gnn_track_finding_tpu/ops/extract.py, _rotate_tracks and _kf_fit) to
// XLA's fusion, which the port has no counterpart for: as torch ops it is
// an (H-1)-step loop of ~390 elementwise ops a step, 12,033 graph nodes
// an extraction of the full event (PERF.md).  Per candidate row (the rows
// of ops/extract.py's _compact_rows: hits radius-descending, the valid
// slots first, n_hits of them):
//   (a) the rotation (extract._rotate_tracks): the innermost edge from
//       the raw hits at slots n-1 and n-2 (n-3 in place of n-2 when those
//       two lie closer than the 3-D separation threshold), its xy and zr
//       angles, and every hit rotated as it is loaded; the rotated
//       coordinates are never stored.  Under bug_compat the reference's
//       r/z typo is kept (extract_track_candidates.py:190-191);
//   (b) the fit (extract._kf_fit): the xy plane, a 3-vector with a full
//       3x3 covariance, an Ornstein-Uhlenbeck transition and a Joseph
//       update; the zr plane, a 2-vector with a 2x2 covariance, the
//       multiple-scattering variance added to all four entries under
//       bug_compat (filterpy's scalar-Q broadcast) and to the (1, 1)
//       entry otherwise; each plane's chi2 summed over the row's n-1
//       steps.  The plain loop runs H-1 steps and masks those from n-1 on
//       (it keeps the state and adds 0.0), so stopping at n-1 gives the
//       same bits.
// Outputs: chi_xy, chi_rz (rows,).  The p-values (the chi2 survival
// function at max(n-2, 1) degrees of freedom) stay torch ops after the
// kernel (ops/extract.py, track_fit).
//
// Bitwise: every operation is the plain version's, in its order
// (ops/linalg.py's mat3_vec, sandwich3, mat2_vec and sandwich2 term by
// term, the literal 0 and 1 entries of F and I - K H included, which IEEE
// forbids the compiler to fold), each +, -, * and / rounded once, as each
// torch op is: they go through the _rn intrinsics (`R` below), which nvcc
// never contracts into a fused multiply-add.  The file builds with
// -fmad=true (_build.FMAD), as torch's kernels are built, so that the CUDA
// math library's atan2, sin, cos, sqrt, exp and pow, which torch's
// elementwise kernels call, round as there: under -fmad=false float64 pow
// rounds otherwise on 12 of 8.4 M inputs (PERF.md), and one such ulp in
// an ill-conditioned endcap row (dz == 0, so var_ms ~ |dr| / 1e-300) moved
// a chi2 sum by 1.4e-4 relative.  Two rules of torch's CUDA kernels are
// repeated: a Python scalar enters an op cast to the tensor's dtype, and
// a division by a Python scalar is a multiplication by its reciprocal,
// computed on the host in that dtype (ou_alpha here).
//
// What bounds it on the card: latency.  The compulsory bytes are 16 MB a
// full event (0.005 ms at 3.35 TB/s), but a row is a serial chain of up
// to H-1 steps, each a dozen float64 divisions, an exp, a pow and a sqrt
// deep, and a full event has 14,400 rows, ~3.4 warps an SM.
// Design: one thread per row, both planes' state in registers (their
// chains are independent and interleave); the next hit's raw coordinates
// are loaded one step ahead, so the load's latency hides behind the step.
// A row shorter than the longest of its warp idles for the rest.  Kept
// as measured on the H100 (PERF.md): 0.065-0.069 ms a full-event fit at
// float64 (0.035-0.038 at float32), under the ~0.1 ms at which the two
// planes would go to a lane pair; the uncoalesced per-thread row reads
// were left unstaged: the kernel is ~0.3% of the event's replay.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirrored field for field by fit_kernel._Args (ctypes).
struct FitArgs {
  const void *coords, *valid, *n_hits;
  void *chi_xy, *chi_rz;
  long long coords_stride, valid_stride;  // row strides, in elements
  int rows, h, bug_compat;
  double sep3d, endcap, ms_coef, ou_alpha, inv_alpha, sw2, sxy2, srz2, tiny;
};

namespace {

constexpr int kThreads = 64;

// The arithmetic of R<T> rounds op by op: the _rn intrinsics, which nvcc
// never fuses, whatever -fmad says.
template <typename T>
struct Rn;
template <>
struct Rn<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
};
template <>
struct Rn<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
};

template <typename T>
struct R {
  T v;
  __device__ __forceinline__ R() {}
  __device__ __forceinline__ R(T x) : v(x) {}
  friend __device__ __forceinline__ R operator+(R a, R b) { return Rn<T>::add(a.v, b.v); }
  friend __device__ __forceinline__ R operator-(R a, R b) { return Rn<T>::sub(a.v, b.v); }
  friend __device__ __forceinline__ R operator*(R a, R b) { return Rn<T>::mul(a.v, b.v); }
  friend __device__ __forceinline__ R operator/(R a, R b) { return Rn<T>::div(a.v, b.v); }
  friend __device__ __forceinline__ R operator-(R a) { return -a.v; }
  friend __device__ __forceinline__ bool operator==(R a, R b) { return a.v == b.v; }
  friend __device__ __forceinline__ bool operator<(R a, R b) { return a.v < b.v; }
  friend __device__ __forceinline__ bool operator>=(R a, R b) { return a.v >= b.v; }
};

// The math library's functions by dtype, as torch's kernels call them.
__device__ __forceinline__ R<double> m_sqrt(R<double> x) { return sqrt(x.v); }
__device__ __forceinline__ R<float> m_sqrt(R<float> x) { return sqrtf(x.v); }
__device__ __forceinline__ R<double> m_exp(R<double> x) { return exp(x.v); }
__device__ __forceinline__ R<float> m_exp(R<float> x) { return expf(x.v); }
__device__ __forceinline__ R<double> m_pow(R<double> x, double y) { return pow(x.v, y); }
__device__ __forceinline__ R<float> m_pow(R<float> x, float y) { return powf(x.v, y); }
__device__ __forceinline__ R<double> m_atan2(R<double> y, R<double> x) { return atan2(y.v, x.v); }
__device__ __forceinline__ R<float> m_atan2(R<float> y, R<float> x) { return atan2f(y.v, x.v); }
__device__ __forceinline__ R<double> m_sin(R<double> x) { return sin(x.v); }
__device__ __forceinline__ R<float> m_sin(R<float> x) { return sinf(x.v); }
__device__ __forceinline__ R<double> m_cos(R<double> x) { return cos(x.v); }
__device__ __forceinline__ R<float> m_cos(R<float> x) { return cosf(x.v); }
__device__ __forceinline__ R<double> m_abs(R<double> x) { return fabs(x.v); }
__device__ __forceinline__ R<float> m_abs(R<float> x) { return fabsf(x.v); }
// torch.clamp(x, min=lo): NaN stays NaN, else fmax
__device__ __forceinline__ R<double> m_clamp_min(R<double> x, R<double> lo) {
  return isnan(x.v) ? x.v : fmax(x.v, lo.v);
}
__device__ __forceinline__ R<float> m_clamp_min(R<float> x, R<float> lo) {
  return isnan(x.v) ? x.v : fmaxf(x.v, lo.v);
}

template <typename T>
struct Hit {
  R<T> x, y, z, r;
};

template <typename T>
__device__ __forceinline__ Hit<T> load_hit(const T* row, int slot) {
  const T* p = row + 4 * slot;
  return {p[0], p[1], p[2], p[3]};
}

// The innermost edge's rotation (extract._rotate_tracks).
template <typename T>
struct Rotation {
  R<T> cxy, sxy, czr, szr;
  bool bug_compat;

  __device__ __forceinline__ Hit<T> apply(const Hit<T>& p, bool valid) const {
    if (!valid) return {T(0), T(0), T(0), T(0)};
    Hit<T> o;
    o.x = p.x * cxy + p.y * sxy;
    o.y = -p.x * sxy + p.y * cxy;
    if (bug_compat) {
      o.r = p.r * czr + p.r * szr;  // ref :190 typo kept
      o.z = -p.z * szr + p.z * czr;  // ref :191 typo kept
    } else {
      o.r = p.r * czr + p.z * szr;
      o.z = -p.z * szr + p.r * czr;
    }
    return o;
  }
};

// linalg.mat3_vec, sandwich3 (F C F^T), mat2_vec, sandwich2.
template <typename V>
__device__ __forceinline__ void mat3_vec(const V* m, const V* v, V* out) {
  for (int i = 0; i < 3; ++i)
    out[i] = m[3 * i] * v[0] + m[3 * i + 1] * v[1] + m[3 * i + 2] * v[2];
}

template <typename V>
__device__ __forceinline__ void sandwich3(const V* f, const V* c, V* out) {
  V fc[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      fc[3 * i + j] = f[3 * i] * c[j] + f[3 * i + 1] * c[3 + j] +
                      f[3 * i + 2] * c[6 + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out[3 * i + j] = fc[3 * i] * f[3 * j] + fc[3 * i + 1] * f[3 * j + 1] +
                       fc[3 * i + 2] * f[3 * j + 2];
}

template <typename V>
__device__ __forceinline__ void mat2_vec(const V* m, const V* v, V* out) {
  out[0] = m[0] * v[0] + m[1] * v[1];
  out[1] = m[2] * v[0] + m[3] * v[1];
}

template <typename V>
__device__ __forceinline__ void sandwich2(const V* f, const V* c, V* out) {
  const V m00 = f[0] * c[0] + f[1] * c[2];
  const V m01 = f[0] * c[1] + f[1] * c[3];
  const V m10 = f[2] * c[0] + f[3] * c[2];
  const V m11 = f[2] * c[1] + f[3] * c[3];
  out[0] = m00 * f[0] + m01 * f[1];
  out[1] = m00 * f[2] + m01 * f[3];
  out[2] = m10 * f[0] + m11 * f[1];
  out[3] = m10 * f[2] + m11 * f[3];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) kf_fit_kernel(const FitArgs a) {
  using V = R<T>;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.rows) return;
  const int h = a.h;
  const T* row = static_cast<const T*>(a.coords) + (size_t)r * a.coords_stride;
  const uint8_t* vrow =
      static_cast<const uint8_t*>(a.valid) + (size_t)r * a.valid_stride;
  // n_hits <= H (the wrapper's contract); clamped so no read leaves the row
  const long long n_hits = static_cast<const long long*>(a.n_hits)[r];
  const int n = (int)(n_hits < h ? n_hits : h);
  // the steps the plain loop keeps: slots i, i + 1 with i + 1 < n
  const int steps = n - 1;
  V chi_xy = T(0);
  V chi_rz = T(0);

  if (steps > 0) {
    const V zero = T(0), one = T(1);
    const V tiny = (T)a.tiny;
    const V sxy2 = (T)a.sxy2;
    const V srz2 = (T)a.srz2;
    const V sw2 = (T)a.sw2;
    const V ms_coef = (T)a.ms_coef;
    const V endcap = (T)a.endcap;
    const V ou_alpha = (T)a.ou_alpha;
    const V inv_alpha = (T)a.inv_alpha;

    // (a) the innermost edge, from the raw hits (n >= 2 here)
    const Hit<T> p1 = load_hit(row, n - 1);
    const Hit<T> p2a = load_hit(row, n - 2);
    const Hit<T> p3 = load_hit(row, n >= 3 ? n - 3 : 0);
    const V dd0 = p1.x - p2a.x, dd1 = p1.y - p2a.y, dd2 = p1.z - p2a.z;
    const V d = m_sqrt(dd0 * dd0 + dd1 * dd1 + dd2 * dd2);
    const Hit<T> p2 = d < V((T)a.sep3d) ? p3 : p2a;
    const V angle_xy = m_atan2(p2.y - p1.y, p2.x - p1.x);
    const V angle_zr = m_atan2(p2.z - p1.z, p2.r - p1.r);
    const Rotation<T> rot{m_cos(angle_xy), m_sin(angle_xy), m_cos(angle_zr),
                          m_sin(angle_zr), a.bug_compat != 0};

    // (b) the fit: state and covariance of both planes
    Hit<T> prev = rot.apply(load_hit(row, 0), vrow[0] != 0);
    V x_xy[3] = {prev.y, zero, zero};
    V P_xy[9] = {sxy2, zero, zero, zero, one, zero, zero, zero, one};
    V x_rz[2] = {prev.r, zero};
    V P_rz[4] = {srz2, zero, zero, T(1000)};
    Hit<T> next = load_hit(row, 1);

    for (int i = 0; i < steps; ++i) {
      const Hit<T> cur = rot.apply(next, vrow[i + 1] != 0);
      if (i + 1 < steps) next = load_hit(row, i + 2);
      const V x2 = prev.x, y2 = prev.y, z2 = prev.z, r2 = prev.r;
      const V x3 = cur.x, y3 = cur.y, z3 = cur.z, r3 = cur.r;

      // parabola through the origin and both hits (ref :197-205,236-239)
      V denom = (zero - x2) * (zero - x3) * (x2 - x3);
      denom = denom == zero ? tiny : denom;
      const V pa = (x3 * y2 - x2 * y3) / denom;
      const V pb = (-(x3 * x3) * y2 + (x2 * x2) * y3) / denom;

      const V dr = r3 - r2;
      const V dz = z3 - z2;
      const V hyp = m_sqrt(dr * dr + dz * dz);
      const V sin_t = m_abs(dr) / m_clamp_min(hyp, tiny);
      const V u = V(T(2)) * pa * x3 + pb;
      const V kappa = (V(T(2)) * pa) / m_pow(one + u * u, T(1.5));
      V var_ms = sin_t * ms_coef * kappa * kappa;
      if (m_abs(z3) >= endcap)
        var_ms = var_ms * m_abs(dr / (dz == zero ? tiny : dz));

      // OU transition + process noise (ref :257-282)
      const V dx = x3 - x2;
      const V e1 = m_exp(-m_abs(dx) * ou_alpha);
      const V f1 = (one - e1) * inv_alpha;
      const V g1 = (m_abs(dx) - f1) * inv_alpha;
      const V st2 = var_ms;
      const V dx2 = dx * dx;
      const V dxw2 = dx2 * sw2;
      const V q02 = V(T(0.5)) * dxw2;
      const V q01 = dx * (st2 + q02);
      const V q12 = dx * sw2;
      const V F[9] = {one, dx, g1, zero, one, f1, zero, zero, e1};
      const V Q[9] = {dx2 * (st2 + V(T(0.25)) * dxw2), q01, q02,
                      q01, st2 + dxw2, q12,
                      q02, q12, sw2 * one};

      V xp[3], Pp[9];
      mat3_vec(F, x_xy, xp);
      sandwich3(F, P_xy, Pp);
      for (int k = 0; k < 9; ++k) Pp[k] = Pp[k] + Q[k];
      // Joseph update, H = [1, 0, 0]
      const V Sk = Pp[0] + sxy2;
      const V K[3] = {Pp[0] / Sk, Pp[3] / Sk, Pp[6] / Sk};
      const V res = y3 - xp[0];
      const V hxy[3] = {one, zero, zero};
      V xn[3], ikh[9], Pn[9];
      for (int k = 0; k < 3; ++k) xn[k] = xp[k] + K[k] * res;
      for (int k = 0; k < 3; ++k)
        for (int l = 0; l < 3; ++l)
          ikh[3 * k + l] = (k == l ? one : zero) - K[k] * hxy[l];
      sandwich3(ikh, Pp, Pn);
      for (int k = 0; k < 3; ++k)
        for (int l = 0; l < 3; ++l)
          Pn[3 * k + l] = Pn[3 * k + l] + sxy2 * K[k] * K[l];
      const V res_post = y3 - xn[0];
      const V S_post = Pn[0] + sxy2;
      const V c_xy = res_post * res_post / S_post;

      // zr plane: tracks r over dz steps (ref :299-316)
      const V Frz[4] = {one, dz, zero, one};
      V xrp[2], Prp[4];
      mat2_vec(Frz, x_rz, xrp);
      sandwich2(Frz, P_rz, Prp);
      if (a.bug_compat) {
        for (int k = 0; k < 4; ++k) Prp[k] = Prp[k] + var_ms;  // scalar-Q
      } else {
        Prp[3] = Prp[3] + var_ms;
      }
      const V Srz = Prp[0] + srz2;
      const V Krz[2] = {Prp[0] / Srz, Prp[2] / Srz};
      const V res_rz = r3 - xrp[0];
      const V hrz[2] = {one, zero};
      V xrn[2], ikh2[4], Prn[4];
      for (int k = 0; k < 2; ++k) xrn[k] = xrp[k] + Krz[k] * res_rz;
      for (int k = 0; k < 2; ++k)
        for (int l = 0; l < 2; ++l)
          ikh2[2 * k + l] = (k == l ? one : zero) - Krz[k] * hrz[l];
      sandwich2(ikh2, Prp, Prn);
      for (int k = 0; k < 2; ++k)
        for (int l = 0; l < 2; ++l)
          Prn[2 * k + l] = Prn[2 * k + l] + srz2 * Krz[k] * Krz[l];
      const V res_rz_post = r3 - xrn[0];
      const V S_rz_post = Prn[0] + srz2;
      const V c_rz = res_rz_post * res_rz_post / S_rz_post;

      for (int k = 0; k < 3; ++k) x_xy[k] = xn[k];
      for (int k = 0; k < 9; ++k) P_xy[k] = Pn[k];
      for (int k = 0; k < 2; ++k) x_rz[k] = xrn[k];
      for (int k = 0; k < 4; ++k) P_rz[k] = Prn[k];
      chi_xy = chi_xy + c_xy;
      chi_rz = chi_rz + c_rz;
      prev = cur;
    }
  }
  static_cast<T*>(a.chi_xy)[r] = chi_xy.v;
  static_cast<T*>(a.chi_rz)[r] = chi_rz.v;
}

template <typename T>
int launch(const FitArgs* args, void* stream) {
  if (args->rows > 0) {
    const int blocks = (args->rows + kThreads - 1) / kThreads;
    kf_fit_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* out) {
  int blocks = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kf_fit_kernel<T>, kThreads, 0);
  out[0] = blocks;
  out[1] = kThreads;
  out[2] = 0;
  return (int)rc;
}

}  // namespace

extern "C" int kf_fit_f32(const FitArgs* args, void* stream) {
  return launch<float>(args, stream);
}

extern "C" int kf_fit_f64(const FitArgs* args, void* stream) {
  return launch<double>(args, stream);
}

extern "C" int kf_fit_occupancy_f32(int* out) { return occupancy<float>(out); }

extern "C" int kf_fit_occupancy_f64(int* out) { return occupancy<double>(out); }
