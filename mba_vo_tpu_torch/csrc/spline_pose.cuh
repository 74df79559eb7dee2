// The spline's poses on the device: quaternion and pose-chain device
// functions shared by K2 (residual_rows.cu: warp_tangents, the virtual poses
// and their tangents) and K5 (frame_layout.cu: each frame's mid-exposure
// pose).
//
// Each function runs the plain version's torch operations in their order,
// one rounding each (the sources that include this header are built with
// -fmad=false, ops/cuda_build.py), so that a pose equals the one torch
// computes on the card:
//   * quaternions are xyzw (core/lie.py); qmul sums each component left to
//     right as quat_multiply does;
//   * quat_log_jvp and quat_exp_jvp are core/lie.py's forward-mode rules in
//     the primal's branch per element; their primal outputs are quat_log's
//     and quat_exp's (whose Taylor branches torch scales by a reciprocal,
//     which cannot move a result there: the term is below half an ulp of
//     the 0.5 and 1 it is added to);
//   * spline_segment is core/spline.py's segment clamp and bases;
//   * tap_sum and einsum_tap_sum are the translation's sum over a pose's
//     knots in the order of the einsum on the card (see each).

#pragma once

#include <cuda_runtime.h>

namespace spline {

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <typename T>
struct Quat {
  T x, y, z, w;
};

// core/lie.py::quat_multiply: each component qw p + three products, summed
// left to right
template <typename T>
__device__ __forceinline__ Quat<T> qmul(Quat<T> q, Quat<T> p) {
  return {((q.w * p.x + q.x * p.w) + q.y * p.z) + (-q.z) * p.y,
          ((q.w * p.y + q.y * p.w) + q.z * p.x) + (-q.x) * p.z,
          ((q.w * p.z + q.z * p.w) + q.x * p.y) + (-q.y) * p.x,
          ((q.w * p.w + (-q.x) * p.x) + (-q.y) * p.y) + (-q.z) * p.z};
}

template <typename T>
__device__ __forceinline__ Quat<T> qconj(Quat<T> q) {
  return {-q.x, -q.y, -q.z, q.w};
}

template <typename T>
__device__ __forceinline__ Quat<T> qadd(Quat<T> a, Quat<T> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w};
}

// core/lie.py::quat_log_jvp: the primal's branch per element (Taylor form
// below the squared-norm threshold `thr`, the w near-zero guard)
template <typename T>
__device__ __forceinline__ void quat_log_jvp(Quat<T> q, Quat<T> dq, T thr, V3<T>& out,
                                             V3<T>& dout) {
  const T sq = (q.x * q.x + q.y * q.y) + q.z * q.z;
  const T dsq = T(2) * ((q.x * dq.x + q.y * dq.y) + q.z * dq.z);
  const bool small = sq < thr;
  const T n = sqrt(small ? T(1) : sq);
  const T dn = (small ? T(0) : dsq) / (T(2) * n);
  const T at = atan2(n, q.w);
  const T lam_big = T(2) * at / n;
  const T dat = (q.w * dn - n * dq.w) / (n * n + q.w * q.w);
  const T dlam_big = T(2) * (dat * n - at * dn) / (n * n);
  const bool near0 = fabs(q.w) < T(1e-6);
  const T sgn = q.w > T(0) ? T(1) : (q.w < T(0) ? T(-1) : T(0));
  const T w_safe = near0 ? sgn + (q.w == T(0) ? T(1) : T(0)) : q.w;
  const T dw_safe = near0 ? T(0) : dq.w;
  const T w3 = (w_safe * w_safe) * w_safe;
  // 2 / w as torch takes a scalar over a tensor: the reciprocal, times 2
  const T lam_small = (T(1) / w_safe) * T(2) - (T(2.0 / 3.0) * sq) / w3;
  const T dlam_small = (T(-2) * dw_safe) / (w_safe * w_safe) -
                       (T(2.0 / 3.0) * (dsq * w3 - ((sq * T(3)) * w_safe) * w_safe * dw_safe)) /
                           (w3 * w3);
  const T lam = small ? lam_small : lam_big;
  const T dlam = small ? dlam_small : dlam_big;
  out = {lam * q.x, lam * q.y, lam * q.z};
  dout = {dlam * q.x + lam * dq.x, dlam * q.y + lam * dq.y, dlam * q.z + lam * dq.z};
}

// core/lie.py::quat_exp_jvp, in the primal's branch per element
template <typename T>
__device__ __forceinline__ void quat_exp_jvp(V3<T> o, V3<T> d, T thr, Quat<T>& out,
                                             Quat<T>& dout) {
  const T ts = (o.x * o.x + o.y * o.y) + o.z * o.z;
  const T dts = T(2) * ((o.x * d.x + o.y * d.y) + o.z * d.z);
  const bool small = ts < thr;
  const T th = sqrt(small ? T(1) : ts);
  const T dth = (small ? T(0) : dts) / (T(2) * th);
  const T sn = sin(T(0.5) * th), cs = cos(T(0.5) * th);
  const T tp4 = ts * ts;
  const T imag = small ? (T(0.5) - ts / T(48)) + tp4 / T(3840) : sn / th;
  const T real = small ? (T(1) - ts / T(8)) + tp4 / T(384) : cs;
  const T dimag = small ? (-dts) / T(48) + ((T(2) * ts) * dts) / T(3840)
                        : ((T(0.5) * cs) * th - sn) / (th * th) * dth;
  const T dreal = small ? (-dts) / T(8) + ((T(2) * ts) * dts) / T(384) : (T(-0.5) * sn) * dth;
  out = {imag * o.x, imag * o.y, imag * o.z, real};
  dout = {dimag * o.x + imag * d.x, dimag * o.y + imag * d.y, dimag * o.z + imag * d.z, dreal};
}

// core/lie.py::quat_exp alone, as the card's torch computes it: there a
// tensor over a Python float is a product with the float's reciprocal (the
// Taylor branch's / 48, / 3840, / 8 and / 384); the squared norm sums its
// three products in order. K6 (lm_step.cu) retracts the knots with it.
template <typename T>
__device__ __forceinline__ Quat<T> quat_exp(V3<T> o, T thr) {
  const T ts = (o.x * o.x + o.y * o.y) + o.z * o.z;
  const bool small = ts < thr;
  const T th = sqrt(small ? T(1) : ts);
  const T tp4 = ts * ts;
  const T imag = small ? (T(0.5) - ts * (T(1) / T(48))) + tp4 * (T(1) / T(3840))
                       : sin(T(0.5) * th) / th;
  const T real = small ? (T(1) - ts * (T(1) / T(8))) + tp4 * (T(1) / T(384)) : cos(T(0.5) * th);
  return {imag * o.x, imag * o.y, imag * o.z, real};
}

// core/spline.py::spline_interp_q's step j, the primal alone:
// exp(c_j log(conj(q_j) q_{j+1})), the factor by which the running product
// is multiplied on the right
template <typename T>
__device__ __forceinline__ Quat<T> segment_exp(Quat<T> qa, Quat<T> qb, T cj, T thr) {
  V3<T> lg, dlg;
  quat_log_jvp(qmul(qconj(qa), qb), Quat<T>{T(0), T(0), T(0), T(0)}, thr, lg, dlg);
  Quat<T> ex, dex;
  quat_exp_jvp(V3<T>{lg.x * cj, lg.y * cj, lg.z * cj}, V3<T>{T(0), T(0), T(0)}, thr, ex, dex);
  return ex;
}

// w[0] x[0] + w[1] x[1] + ... as the plain version's einsum sums on the
// card (cuBLAS's batched product): in float32 a fused multiply-add a term
// onto the first product, in float64 each product rounded and added in
// order (measured: the warped positions then equal the plain version's)
template <typename T, int n>
__device__ __forceinline__ T tap_sum(const T* w, const T* x) {
  T acc = w[0] * x[0];
#pragma unroll
  for (int j = 1; j < n; ++j) {
    if constexpr (sizeof(T) == 4)
      acc = fma(w[j], x[j], acc);
    else
      acc = acc + w[j] * x[j];
  }
  return acc;
}

// The same sum in the order the card's einsum takes at the batches of the
// patch layout's poses, found by experiments/pose_order.py (the card's sums
// against candidate orders computed exactly on the host): in float32 tap_sum's
// chain; in float64 two chains of fused multiply-adds, over the even and the
// odd taps, each from its first product, then their sum (at degree 2 tap_sum's
// order). K5 takes this one; K2 keeps tap_sum, whose bits its tests pin.
template <typename T, int n>
__device__ __forceinline__ T einsum_tap_sum(const T* w, const T* x) {
  if constexpr (sizeof(T) == 4) {
    return tap_sum<T, n>(w, x);
  } else {
    T even = w[0] * x[0], odd = w[1] * x[1];
#pragma unroll
    for (int j = 2; j < n; ++j) {
      if (j % 2 == 0)
        even = fma(w[j], x[j], even);
      else
        odd = fma(w[j], x[j], odd);
    }
    return even + odd;
  }
}

// The segment of the spline at time tau (core/spline.py's
// spline_segment_start_and_u, its clamp to [0, K - degree] included) and its
// position and cumulative rotation bases (_vec_basis, _rot_cum_basis).
template <typename T, int degree>
__device__ __forceinline__ int spline_segment(T tau, T t0, T dt, int K, T* wv, T* wc) {
  const T tn = (tau - t0) / dt;
  T idxf = floor(tn);
  if (idxf < T(0)) idxf = T(0);
  if (idxf > T(K - degree)) idxf = T(K - degree);
  const T u = tn - idxf;
  if constexpr (degree == 2) {
    wv[0] = T(1) - u;
    wv[1] = u;
    wc[0] = u;
  } else {
    const T uu = u * u, uuu = uu * u, os = T(1.0 / 6.0);
    wv[0] = ((os - T(0.5) * u) + T(0.5) * uu) - os * uuu;
    wv[1] = (T(4.0 * (1.0 / 6.0)) - uu) + T(0.5) * uuu;
    wv[2] = ((os + T(0.5) * u) + T(0.5) * uu) - T(0.5) * uuu;
    wv[3] = os * uuu;
    wc[0] = ((T(5.0 * (1.0 / 6.0)) + T(0.5) * u) - T(0.5) * uu) + os * uuu;
    wc[1] = ((os + T(0.5) * u) + T(0.5) * uu) - T(2.0 * (1.0 / 6.0)) * uuu;
    wc[2] = os * uuu;
  }
  return idxf == idxf ? (int)idxf : 0;   // a NaN time: NaN poses from knot 0 on
}

}  // namespace spline
