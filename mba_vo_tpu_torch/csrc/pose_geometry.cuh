// Pose geometry on the device, shared by K10-K12 (bundle_adjust.cu), K13
// (pnp.cu) and K14-K15 (pose_graph.cu): quaternion rotation, R^T, 3 x 3
// products, the relative-pose residual log(T_m^-1 (T_i^-1 T_j)) and its
// closed-form Jacobians (backend/ba.py's relative_pose_jacobians), and one
// pinhole observation: the camera point, the residual with the depth clamp
// and the Huber weight (backend/ba.py's _camera_points, _project,
// _huber_weight).
//
// Each function runs the plain version's torch operations in their order,
// one rounding each: the sources that include this header build with
// -fmad=false (ops/cuda_build.py).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "spline_pose.cuh"

namespace geo {

using spline::Quat;
using spline::V3;

// core/lie.py::quat_rotate: v + w t + xyz x t with t = 2 (xyz x v)
template <typename T>
__device__ __forceinline__ V3<T> qrot(Quat<T> q, V3<T> v) {
  const V3<T> xyz{q.x, q.y, q.z};
  V3<T> t = spline::cross(xyz, v);
  t = {T(2) * t.x, T(2) * t.y, T(2) * t.z};
  const V3<T> c = spline::cross(xyz, t);
  return {(v.x + q.w * t.x) + c.x, (v.y + q.w * t.y) + c.y, (v.z + q.w * t.z) + c.z};
}

template <typename T>
__device__ __forceinline__ Quat<T> load_q(const T* q, int i) {
  return {q[4 * i], q[4 * i + 1], q[4 * i + 2], q[4 * i + 3]};
}

template <typename T>
__device__ __forceinline__ V3<T> load_v(const T* v, int i) {
  return {v[3 * i], v[3 * i + 1], v[3 * i + 2]};
}

// R(q)^T [3 x 3] row-major, as backend/ba.py's _transposed_rotation:
// column j is q* rotating e_j
template <typename T>
__device__ __forceinline__ void rot_t(Quat<T> q, T* R) {
  const Quat<T> qc = spline::qconj(q);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const V3<T> e{T(j == 0), T(j == 1), T(j == 2)};
    const V3<T> c = qrot(qc, e);
    R[j] = c.x;
    R[3 + j] = c.y;
    R[6 + j] = c.z;
  }
}

// C = A B, 3 x 3 row-major, each entry's three products summed in order
template <typename T>
__device__ __forceinline__ void mm3(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = (A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]) + A[3 * i + 2] * B[6 + j];
}

template <typename T>
__device__ __forceinline__ void hat(V3<T> v, T* O) {
  O[0] = T(0);
  O[1] = -v.z;
  O[2] = v.y;
  O[3] = v.z;
  O[4] = T(0);
  O[5] = -v.x;
  O[6] = -v.y;
  O[7] = v.x;
  O[8] = T(0);
}

// torch.clamp(x, min=lo): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

template <typename T>
__device__ __forceinline__ T clamp_max(T x, T hi) {
  return x > hi ? hi : x;
}

// ------------------------------------------------- the odometry prior

// The squared-norm threshold of core/lie.py's Taylor branches
template <typename T>
__device__ __forceinline__ T small_threshold() {
  return sizeof(T) >= 8 ? T(1e-20) : T(1e-10);
}

// core/lie.py::_se3_V_inv(w) [3 x 3]
template <typename T>
__device__ __forceinline__ void se3_v_inv(V3<T> w, T* Vi) {
  const T th2 = (w.x * w.x + w.y * w.y) + w.z * w.z;
  const bool small = th2 < small_threshold<T>();
  const T th2s = small ? T(1) : th2;
  const T th = sqrt(th2s);
  const T half = T(0.5) * th;
  const T c_big = (T(1) - (half * cos(half)) / sin(half)) / th2s;
  const T c_small = T(1.0 / 12.0) + th2 * (T(1) / T(720));
  const T c = small ? c_small : c_big;
  T O[9], OO[9];
  hat(w, O);
  mm3(O, O, OO);
#pragma unroll
  for (int e = 0; e < 9; ++e) Vi[e] = (T(e % 4 == 0) - T(0.5) * O[e]) + c * OO[e];
}

// The relative-pose residual log(T_m^-1 (T_i^-1 T_j)) = [V^-1(w) t_err; w]
// (backend/ba.py's relative_pose_residuals and the r of
// relative_pose_jacobians); also returns what the Jacobians need
template <typename T>
struct EdgeParts {
  Quat<T> q_err;
  V3<T> t_rel, t_err, w;
  T Vi[9];
};

template <typename T>
__device__ __forceinline__ void edge_residual(V3<T> ti, Quat<T> qi, V3<T> tj, Quat<T> qj,
                                              V3<T> tm, Quat<T> qm, T* r, EdgeParts<T>& p) {
  const Quat<T> qi_inv = spline::qconj(qi);
  const Quat<T> q_rel = spline::qmul(qi_inv, qj);
  p.t_rel = qrot(qi_inv, V3<T>{tj.x - ti.x, tj.y - ti.y, tj.z - ti.z});
  const Quat<T> qm_inv = spline::qconj(qm);
  p.q_err = spline::qmul(qm_inv, q_rel);
  p.t_err = qrot(qm_inv, V3<T>{p.t_rel.x - tm.x, p.t_rel.y - tm.y, p.t_rel.z - tm.z});
  V3<T> dw;
  spline::quat_log_jvp(p.q_err, Quat<T>{T(0), T(0), T(0), T(0)}, small_threshold<T>(), p.w, dw);
  se3_v_inv(p.w, p.Vi);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = (p.Vi[3 * i] * p.t_err.x + p.Vi[3 * i + 1] * p.t_err.y) + p.Vi[3 * i + 2] * p.t_err.z;
  r[3] = p.w.x;
  r[4] = p.w.y;
  r[5] = p.w.z;
}

// backend/ba.py::relative_pose_jacobians: the residual r [6] and J_i, J_j
// [6 x 6] row-major of one edge
template <typename T>
__device__ void edge_jacobians(V3<T> ti, Quat<T> qi, V3<T> tj, Quat<T> qj, V3<T> tm, Quat<T> qm,
                               T* r, T* Ji, T* Jj) {
  EdgeParts<T> p;
  edge_residual(ti, qi, tj, qj, tm, qm, r, p);
  const V3<T> w = p.w, te = p.t_err;
  // _log_coefficients: c and c'/theta, Taylor below theta^2 = 1e-4 (float64)
  // or 1e-2
  const T th2 = (w.x * w.x + w.y * w.y) + w.z * w.z;
  const bool small = th2 < (sizeof(T) >= 8 ? T(1e-4) : T(1e-2));
  const T th2s = small ? T(1) : th2;
  const T th = sqrt(th2s);
  const T h = T(0.5) * th;
  const T sh = sin(h);
  const T cot = cos(h) / sh;
  const T f = T(1) - h * cot;
  const T df = T(-0.5) * cot + (T(0.5) * h) / (sh * sh);
  const T c = small ? (T(1.0 / 12.0) + th2 * (T(1) / T(720))) +
                          (th2 * th2) * (T(1) / T(30240))
                    : f / th2s;
  const T dc = small ? (T(1.0 / 360.0) + th2 * (T(1) / T(7560))) +
                           (th2 * th2) * (T(1) / T(201600))
                     : (df / th2s - (T(2) * f) / (th2s * th)) / th;
  T Wx[9], WW[9], Jr[9];
  hat(w, Wx);
  mm3(Wx, Wx, WW);
#pragma unroll
  for (int e = 0; e < 9; ++e) Jr[e] = (T(e % 4 == 0) + T(0.5) * Wx[e]) + c * WW[e];
  // D = d(V^-1(w) t)/dw = [t]x / 2 + c d([w]x^2 t)/dw + c' [w]x^2 t w^T
  const T wt = (w.x * te.x + w.y * te.y) + w.z * te.z;
  const T ww = (w.x * w.x + w.y * w.y) + w.z * w.z;
  const T wv[3] = {w.x, w.y, w.z}, tv[3] = {te.x, te.y, te.z};
  T WWt[3], Th[9], Dm[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) WWt[i] = wv[i] * wt - tv[i] * ww;
  hat(te, Th);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const T dW = (wt * T(i == j) + wv[i] * tv[j]) - (T(2) * tv[i]) * wv[j];
      Dm[3 * i + j] = (T(0.5) * Th[3 * i + j] + c * dW) + (dc * WWt[i]) * wv[j];
    }
  T RmT[9], RiT[9], ReT[9], A[9], B[9], Cm[9];
  rot_t(qm, RmT);
  rot_t(qi, RiT);
  rot_t(p.q_err, ReT);
  T dt_dti[9], dt_dwi[9], dth_dwi[9], DJ[9], Tr[9];
  mm3(RmT, RiT, A);
#pragma unroll
  for (int e = 0; e < 9; ++e) dt_dti[e] = -A[e];
  hat(p.t_rel, Tr);
  mm3(RmT, Tr, dt_dwi);
  mm3(ReT, RmT, A);
#pragma unroll
  for (int e = 0; e < 9; ++e) dth_dwi[e] = -A[e];
  mm3(Dm, Jr, DJ);
  mm3(p.Vi, dt_dti, A);    // V^-1 dt/dt_i
  mm3(p.Vi, dt_dwi, B);
  mm3(DJ, dth_dwi, Cm);
  T E[9];
  mm3(Jr, dth_dwi, E);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = 3 * i + j;
      Ji[6 * i + j] = A[e];
      Ji[6 * i + 3 + j] = B[e] + Cm[e];
      Ji[6 * (i + 3) + j] = T(0);
      Ji[6 * (i + 3) + 3 + j] = E[e];
      Jj[6 * i + j] = -A[e];
      Jj[6 * i + 3 + j] = DJ[e];
      Jj[6 * (i + 3) + j] = T(0);
      Jj[6 * (i + 3) + 3 + j] = Jr[e];
    }
}

// ------------------------------------------------- one observation

template <typename T>
struct Pose3 {
  Quat<T> q_inv;   // the camera's conjugate rotation
  V3<T> t;
};

// Pc = R^T (X - t) (backend/ba.py's _camera_points)
template <typename T>
__device__ __forceinline__ V3<T> camera_point(const Pose3<T>& P, V3<T> X) {
  return qrot(P.q_inv, V3<T>{X.x - P.t.x, X.y - P.t.y, X.z - P.t.z});
}

// the residual r [2] of a camera point against its observation
template <typename T>
__device__ __forceinline__ void residual(V3<T> Pc, const T* K, T ox, T oy, T* r) {
  const T z = clamp_min(Pc.z, T(1e-6));
  r[0] = ((Pc.x / z) * K[0] + K[2]) - ox;
  r[1] = ((Pc.y / z) * K[1] + K[3]) - oy;
}

// _huber_weight of x = r2 / 2: (rho, drho/dx)
template <typename T>
__device__ __forceinline__ void huber(const T* r, double a, T& rho, T& w2) {
  const T r2 = r[0] * r[0] + r[1] * r[1];
  const T aa = T(a * a);
  const T x = T(0.5) * r2;
  const T sx = sqrt(clamp_min(x, T(1e-24)));
  const bool big = x > aa;
  rho = big ? T(2.0 * a) * sx - aa : x;
  w2 = big ? T(a) / sx : T(1);
}

}  // namespace geo
