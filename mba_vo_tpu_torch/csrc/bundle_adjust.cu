// K10-K12: the backend's bundle-adjustment LM iteration on the card, three
// launches an iteration and one flag read by the host.
//
// Replaces the body of the LM lax.while_loop in
// mba_vo_tpu/backend/ba.py::run_bundle_adjustment (:345-364, the loop
// :366), which XLA compiles with the rest of the jitted BA into one device
// program (no Pallas source). Bound in ops/cuda_ba.py (BABinding); the plain
// versions are backend/ba.py's ba_build_plain, ba_step_plain and
// ba_commit_plain.
//
//   * K10 ba_build (build_normal_equations :185-218 with
//     _residuals_and_jacobians :90-114, _huber_weight :117-126 and
//     _odom_terms :155-182): per observation (w, m) the camera point
//     Pc = R^T (X - t), the pinhole projection with the depth clamp at 1e-6,
//     the residual, the closed-form 2 x 6 and 2 x 3 Jacobians (zero in depth
//     where the clamp is active), the Huber rho and weight, the mask
//     obs_mask * point_mask; per landmark V [M,3,3] and g_x [M,3], per
//     observation Wb [W,M,6,3]; across landmarks U [W,6,6], g_p [W,6], the
//     rho sum and the observation count n; the odometry prior's cost, g and
//     H [6W, 6W] over the W - 1 edges in the closed form of
//     relative_pose_jacobians. Writes the build's cost rho / max(n, 1) +
//     c_o / n and, at the loop's first iteration (the scalars' iteration
//     count 0), the cost of evaluate_cost at the state: the loop's initial
//     cost, so that no separate launch or plain stage computes it;
//   * K11 ba_step (schur_solve :232-294, _apply_step :297-304): the gauge
//     fix (pose 0 and the padded poses frozen), the damping by (1 + lambda)
//     and the landmark damping, each V's 3 x 3 inverse (NaN where LU meets a
//     zero pivot, as inv_ex), S = blockdiag(U) - sum_m W_m V_m^-1 W_m^T + He
//     and its right-hand side, the 6W x 6W Cholesky and the two triangular
//     solves (a NaN step where the factorisation fails, as cholesky_ex),
//     dx by back-substitution, and the candidate poses t + dt,
//     q (x) exp(dw) and points X + dx * point_mask;
//   * K12 ba_commit (evaluate_cost :221-229 at the candidate and the loop
//     body's decision and commit): the candidate's Huber cost plus the
//     prior's, ok = cost decrease and finite dp and dx, rel_decrease, the
//     select of poses and points in place, lambda down or up within its
//     clamps, the cost, the iteration count and the done flag the host
//     reads. A launch on a state already done changes nothing (the
//     reference's while_loop stops there).
//
// What bounds them: latency. At the default window (W = 7, M = 512) an
// iteration moves ~0.8 MB (W_blk [W,M,6,3] written once and read twice)
// and does ~5 MFLOP (the Schur sums W^2 36 M 3), a fraction of a
// microsecond at the card's rates; the time is three launches and the
// chains inside them: the cross-CTA reductions, and in K11 the 6W pivots
// of the Cholesky and the 2 x 6W rows of the solves.
//
// Design: the landmarks split into C = ceil(M / MB) contiguous slices of MB
// landmarks (ops/cuda_ba.py::ba_layout: MB <= 32, fewer where the window is
// wide), a CTA of 256 threads a slice, in all three kernels. A CTA stages
// its slice's per-observation quantities in shared memory, writes what is
// per landmark or per observation directly, and writes its partial sums of
// what is summed across landmarks (U and g_p; S's lower triangle and the
// right-hand side; the rho sum and n) to a scratch buffer [C, ...]. The
// last CTA to take an integer ticket adds the C partials in slice order,
// finishes the stage (the prior; the Cholesky, the solves and the
// back-substitution; the decision and the select) and resets the ticket.
// The ticket decides who combines, never in what order: every sum has one
// fixed order, so a run repeats bit for bit.
//
// Orders: a CTA's rho sum and count are lane l's observations l, l + 32,
// ... of the slice in order, then lane 0's butterfly of shuffles, the same
// in K10 and K12, so the cost K10 writes at the first iteration and K12's
// candidate costs are one function of the state. V, g_x sum over the poses
// in order; U, g_p, S and the right-hand side over a slice's landmarks in
// order, then the slices in order; each product rounded (this source builds
// with -fmad=false, ops/cuda_build.py), the terms of a Jacobian product
// taken as torch's elementwise ops take them. The Cholesky is
// right-looking (each entry of the factor updated once a pivot, in pivot
// order); the solves go row by row. Neither cuBLAS's nor LAPACK's orders can
// be followed: the kernels agree with the plain versions within the
// roundoff of a sum, not bit for bit.
//
// S lives in shared memory while it fits with K11's vectors, else in a
// global scratch matrix the wrapper allocates (ops/cuda_ba.py::ba_layout).

#include <cuda_runtime.h>
#include <math.h>

#include "spline_pose.cuh"

namespace {

using spline::Quat;
using spline::V3;

// the state's scalars (ops/cuda_ba.py's B_* constants)
enum {
  B_COST = 0,
  B_LAM,
  B_IT,
  B_DONE,
  B_COST0,
  B_BUILD_COST,
  B_CAND_COST,
  B_OK,
  B_REL,
  B_SIZE
};

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr size_t kSmemLimit = 232448;   // the 227 KiB a CTA may opt into

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

// whether this CTA is the last of the grid to finish (its partials
// written); the ticket is reset by that CTA at its end
__device__ __forceinline__ bool last_cta(unsigned* ticket, int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_flag = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  const bool last = *s_flag != 0;
  if (last) __threadfence();
  return last;
}

// the gauge of pose w: 0 for pose 0, else its pose mask (1 without one)
template <typename T>
__device__ __forceinline__ T gauge_of(const T* pose_mask, int w) {
  const T pm = pose_mask ? pose_mask[w] : T(1);
  return (w == 0 ? T(0) : T(1)) * pm;
}

// The problem's constant inputs
template <typename T>
struct Inputs {
  const T* obs;         // [W, M, 2]
  const T* obs_mask;    // [W, M]
  const T* point_mask;  // [M]
  const T* K;           // [4]
  const T* odom_t;      // [W - 1, 3], or null: no prior
  const T* odom_q;      // [W - 1, 4]
  const T* odom_w;      // [W - 1]
  const T* pose_mask;   // [W], or null: every pose live
  int W, M, MB;
};

// each edge's prior residual at poses (t, q) into r [W - 1, 6]; threads
// strided over the edges
template <typename T>
__device__ __forceinline__ void edge_residuals(const Inputs<T>& in, const T* t, const T* q,
                                               T* r) {
  for (int e = threadIdx.x; e < in.W - 1; e += blockDim.x) {
    EdgeParts<T> p;
    edge_residual(load_v(t, e), load_q(q, e), load_v(t, e + 1), load_q(q, e + 1),
                  load_v(in.odom_t, e), load_q(in.odom_q, e), r + 6 * e, p);
  }
}

// evaluate_cost's prior sum over the edges' residuals (6 at a stride of
// ``stride``): (weight r) r, in order; K10's initial cost and K12's
// candidate costs are this one function
template <typename T>
__device__ __forceinline__ T prior_eval_sum(const Inputs<T>& in, const T* r, int stride) {
  T s = T(0);
  for (int e = 0; e < in.W - 1; ++e)
    for (int k = 0; k < 6; ++k) s = s + (in.odom_w[e] * r[stride * e + k]) * r[stride * e + k];
  return s;
}

// ------------------------------------------------------------------ K10

// shared memory (elements of T): phase 1 the poses [W, 16] and the slice's
// observations [W MB, 23]; the last CTA's phase the edges [W - 1, 78], g_p
// [6W] and the rho sum and count
__host__ __device__ inline size_t build_smem_elems(int W, int MB) {
  const size_t p1 = size_t(16) * W + size_t(23) * W * MB;
  const size_t p3 = size_t(78) * (W > 1 ? W - 1 : 0) + size_t(6) * W + 4;
  return p1 > p3 ? p1 : p3;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ba_build_kernel(const T* __restrict__ t, const T* __restrict__ q, const T* __restrict__ X,
                    T* __restrict__ sc, Inputs<T> in, T* __restrict__ U, T* __restrict__ V,
                    T* __restrict__ Wb, T* __restrict__ g_p, T* __restrict__ g_x,
                    T* __restrict__ H_o, T* __restrict__ partials, unsigned* __restrict__ ticket,
                    double huber_a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_flag;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int W = in.W, M = in.M, tid = threadIdx.x;
  const int m0 = blockIdx.x * in.MB;
  const int mb = min(in.MB, M - m0);   // landmarks of this slice
  const int nobs = W * mb;
  // phase 1 layout
  T* qs = sm;                  // [W, 4] q^-1
  T* ts = qs + 4 * W;          // [W, 3]
  T* Rt = ts + 3 * W;          // [W, 9] R^T
  T* ob = Rt + 9 * W;          // [W mb, 23]: Jp 12, Jx 6, r 2, wgt, rho mask, mask

  for (int w = tid; w < W; w += blockDim.x) {
    const Quat<T> qi = spline::qconj(load_q(q, w));
    qs[4 * w] = qi.x;
    qs[4 * w + 1] = qi.y;
    qs[4 * w + 2] = qi.z;
    qs[4 * w + 3] = qi.w;
    ts[3 * w] = t[3 * w];
    ts[3 * w + 1] = t[3 * w + 1];
    ts[3 * w + 2] = t[3 * w + 2];
    // R^T: column j is q^-1 rotating e_j
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const V3<T> c = qrot(qi, V3<T>{T(j == 0), T(j == 1), T(j == 2)});
      Rt[9 * w + j] = c.x;
      Rt[9 * w + 3 + j] = c.y;
      Rt[9 * w + 6 + j] = c.z;
    }
  }
  __syncthreads();

  // 1. each observation: r, the Jacobians, the weight; W_blk written
  for (int o = tid; o < nobs; o += blockDim.x) {
    const int w = o / mb, m = m0 + (o - w * mb);
    const Pose3<T> P{Quat<T>{qs[4 * w], qs[4 * w + 1], qs[4 * w + 2], qs[4 * w + 3]},
                     V3<T>{ts[3 * w], ts[3 * w + 1], ts[3 * w + 2]}};
    const V3<T> Pc = camera_point(P, load_v(X, m));
    const size_t wm = size_t(w) * M + m;
    T r[2];
    residual(Pc, in.K, in.obs[2 * wm], in.obs[2 * wm + 1], r);
    T rho, w2;
    huber(r, huber_a, rho, w2);
    const T mask = in.obs_mask[wm] * in.point_mask[m];
    const T wgt = w2 * mask;
    // reprojection_jacobians: dproj [2 x 3] (zero in z where the clamp is
    // active), J_point = dproj R^T, J_pose = [-J_point, dproj [Pc]x]
    const T z = clamp_min(Pc.z, T(1e-6));
    const T inv_z = T(1) / z;
    const T live = Pc.z > T(1e-6) ? T(1) : T(0);
    const T K0 = in.K[0], K1 = in.K[1];
    const T dp[6] = {K0 * inv_z, T(0), (((-K0) * Pc.x) * inv_z) * inv_z * live,
                     T(0), K1 * inv_z, (((-K1) * Pc.y) * inv_z) * inv_z * live};
    T Ph[9];
    hat(Pc, Ph);
    T* s = ob + 23 * o;
    const T* R = Rt + 9 * w;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T jx = (dp[3 * i] * R[j] + dp[3 * i + 1] * R[3 + j]) + dp[3 * i + 2] * R[6 + j];
        const T jw = (dp[3 * i] * Ph[j] + dp[3 * i + 1] * Ph[3 + j]) + dp[3 * i + 2] * Ph[6 + j];
        s[6 * i + j] = -jx;     // Jp [2 x 6]
        s[6 * i + 3 + j] = jw;
        s[12 + 3 * i + j] = jx; // Jx [2 x 3]
      }
    }
    s[18] = r[0];
    s[19] = r[1];
    s[20] = wgt;
    s[21] = rho * mask;
    s[22] = mask;
    // W_blk[w, m] = Jp^T wgt Jx
    T* wb = Wb + 18 * wm;
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        wb[3 * a + b] = (s[a] * wgt) * s[12 + b] + (s[6 + a] * wgt) * s[15 + b];
  }
  __syncthreads();

  // 2. per landmark V and g_x (over the poses in order); per pose the
  // slice's partial U and g_p (over its landmarks in order)
  const int n_lm = 12 * mb, n_pose = 42 * W;
  const size_t stride = size_t(42) * W + 2;
  T* part = partials + blockIdx.x * stride;
  for (int e = tid; e < n_lm + n_pose; e += blockDim.x) {
    if (e < n_lm) {
      const int ml = e / 12, k = e - 12 * ml;
      T acc = T(0);
      for (int w = 0; w < W; ++w) {
        const T* s = ob + 23 * (w * mb + ml);
        if (k < 9) {
          const int a = k / 3, b = k - 3 * (k / 3);
          acc = acc + ((s[12 + a] * s[20]) * s[12 + b] + (s[15 + a] * s[20]) * s[15 + b]);
        } else {
          const int a = k - 9;
          acc = acc + ((s[12 + a] * s[20]) * s[18] + (s[15 + a] * s[20]) * s[19]);
        }
      }
      if (k < 9)
        V[9 * size_t(m0 + ml) + k] = acc;
      else
        g_x[3 * size_t(m0 + ml) + k - 9] = acc;
    } else {
      const int f = e - n_lm, w = f / 42, k = f - 42 * w;
      T acc = T(0);
      for (int ml = 0; ml < mb; ++ml) {
        const T* s = ob + 23 * (w * mb + ml);
        if (k < 36) {
          const int a = k / 6, b = k - 6 * (k / 6);
          acc = acc + ((s[a] * s[20]) * s[b] + (s[6 + a] * s[20]) * s[6 + b]);
        } else {
          const int a = k - 36;
          acc = acc + ((s[a] * s[20]) * s[18] + (s[6 + a] * s[20]) * s[19]);
        }
      }
      part[f] = acc;
    }
  }
  // the slice's rho sum and observation count (warp 0, lane order); the
  // observations' rho mask and mask sit at stride 23
  if (tid < kWarp) {
    T s_rho = T(0), s_n = T(0);
    for (int o = tid; o < nobs; o += kWarp) {
      s_rho = s_rho + ob[23 * o + 21];
      s_n = s_n + ob[23 * o + 22];
    }
#pragma unroll
    for (int k = kWarp / 2; k > 0; k >>= 1) {
      s_rho = s_rho + __shfl_xor_sync(0xffffffffu, s_rho, k);
      s_n = s_n + __shfl_xor_sync(0xffffffffu, s_n, k);
    }
    if (tid == 0) {
      part[n_pose] = s_rho;
      part[n_pose + 1] = s_n;
    }
  }
  if (!last_cta(ticket, &s_flag)) return;

  // 3. the last CTA: the slices' partials in slice order, the prior, the
  // costs
  const int C = gridDim.x, E = W - 1, D = 6 * W;
  T* edges = sm;                    // [E, 78]: r 6, J_i 36, J_j 36
  T* gps = edges + 78 * (E > 0 ? E : 0);   // [6W] the reprojection g_p
  T* tot = gps + 6 * W;             // rho sum, count, build cost's prior, eval prior
  for (int f = tid; f < n_pose + 2; f += blockDim.x) {
    T acc = T(0);
    for (int c = 0; c < C; ++c) acc = acc + __ldcg(partials + c * stride + f);
    if (f >= n_pose) {
      tot[f - n_pose] = acc;
    } else {
      const int w = f / 42, k = f - 42 * w;
      if (k < 36)
        U[36 * w + k] = acc;
      else
        gps[6 * w + k - 36] = acc;
    }
  }
  const bool prior = in.odom_t != nullptr;
  if (prior) {
    for (int e = tid; e < E; e += blockDim.x) {
      T* x = edges + 78 * e;
      edge_jacobians(load_v(t, e), load_q(q, e), load_v(t, e + 1), load_q(q, e + 1),
                     load_v(in.odom_t, e), load_q(in.odom_q, e), x, x + 6, x + 42);
    }
  }
  __syncthreads();
  // H_o = sum_e J_e^T w_e J_e over the edges that touch both poses, in edge
  // order; g_o likewise; every entry off the band 0
  for (int f = tid; f < D * D; f += blockDim.x) {
    const int i = f / D, j = f - D * (f / D);
    const int p = i / 6, a = i - 6 * p, pp = j / 6, b = j - 6 * pp;
    T acc = T(0);
    if (prior && abs(p - pp) <= 1) {
      for (int e = max(max(p, pp) - 1, 0); e <= min(min(p, pp), E - 1); ++e) {
        const T* x = edges + 78 * e;
        const T* Ja = x + (p == e ? 6 : 42);
        const T* Jb = x + (pp == e ? 6 : 42);
        const T we = in.odom_w[e];
        for (int k = 0; k < 6; ++k) acc = acc + (Ja[6 * k + a] * we) * Jb[6 * k + b];
      }
    }
    H_o[f] = acc;
  }
  for (int i = tid; i < D; i += blockDim.x) {
    const int p = i / 6, a = i - 6 * p;
    T acc = T(0);
    if (prior) {
      for (int e = max(p - 1, 0); e <= min(p, E - 1); ++e) {
        const T* x = edges + 78 * e;
        const T* Ja = x + (p == e ? 6 : 42);
        const T we = in.odom_w[e];
        for (int k = 0; k < 6; ++k) acc = acc + Ja[6 * k + a] * (we * x[k]);
      }
    }
    g_p[i] = gps[i] + acc;
  }
  if (tid == 0) {
    // the build's prior cost 0.5 sum(w r^2), evaluate_cost's 0.5 sum((w r) r)
    T c_b = T(0);
    if (prior) {
      for (int e = 0; e < E; ++e)
        for (int k = 0; k < 6; ++k) {
          const T re = edges[78 * e + k];
          c_b = c_b + in.odom_w[e] * (re * re);
        }
    }
    const T c_e = prior ? prior_eval_sum(in, edges, 78) : T(0);
    const T n = clamp_min(tot[1], T(1));
    sc[B_BUILD_COST] = tot[0] / n + (T(0.5) * c_b) / n;
    if (sc[B_IT] == T(0)) {
      const T cost0 = tot[0] / n + (T(0.5) * c_e) * (T(1) / n);
      sc[B_COST] = cost0;
      sc[B_COST0] = cost0;
    }
    *ticket = 0u;
  }
}

// ------------------------------------------------------------------ K11

// shared memory (elements of T): phase 1 the slice's W_blk and W V^-1 [W
// MB, 18] each, V^-1 [MB, 9] and g_x [MB, 3]; the last CTA's phase S [D,
// D] where it lives there, the right-hand side, the forward sweep, the
// solution and the pivots [D] each, dp [D] and the gauge [W]
__host__ __device__ inline size_t step_smem_elems(int W, int MB, bool s_shared) {
  const size_t D = size_t(6) * W;
  const size_t p1 = size_t(36) * W * MB + size_t(12) * MB;
  const size_t p2 = (s_shared ? D * D : 0) + 5 * D + W + 2;
  return p1 > p2 ? p1 : p2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ba_step_kernel(const T* __restrict__ t, const T* __restrict__ q, const T* __restrict__ X,
                   const T* __restrict__ sc, Inputs<T> in, const T* __restrict__ U,
                   const T* __restrict__ V, const T* __restrict__ Wb, const T* __restrict__ g_p,
                   const T* __restrict__ g_x, const T* __restrict__ H_o, T* __restrict__ dp,
                   T* __restrict__ dx, T* __restrict__ cand_t, T* __restrict__ cand_q,
                   T* __restrict__ cand_X, T* __restrict__ Vinv, T* __restrict__ partials,
                   T* __restrict__ S_global, unsigned* __restrict__ ticket,
                   double landmark_damping) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_flag;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int W = in.W, M = in.M, D = 6 * W, tid = threadIdx.x;
  const int m0 = blockIdx.x * in.MB;
  const int mb = min(in.MB, M - m0);
  const T lam = sc[B_LAM];
  T* Wg = sm;                  // [W, mb, 18] W_blk * gauge
  T* WV = Wg + 18 * W * mb;    // [W, mb, 18] W V^-1
  T* Vi = WV + 18 * W * mb;    // [mb, 9]
  T* gx = Vi + 9 * mb;         // [mb, 3]

  // 1. each landmark's damped V and its inverse (LU with partial pivoting,
  // NaN where a pivot is 0, as inv_ex and _nan_unless); the gauged W_blk
  for (int ml = tid; ml < mb; ml += blockDim.x) {
    const size_t m = size_t(m0 + ml);
    T A[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) A[e] = V[9 * m + e];
    // V + lam diag(V), then + landmark damping on the diagonal
#pragma unroll
    for (int a = 0; a < 3; ++a) A[4 * a] = (A[4 * a] + lam * A[4 * a]) + T(landmark_damping);
    int perm[3] = {0, 1, 2};
    bool ok = true;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      int p = k;
      for (int i = k + 1; i < 3; ++i)
        if (fabs(A[3 * i + k]) > fabs(A[3 * p + k])) p = i;
      if (p != k) {
        for (int j = 0; j < 3; ++j) {
          const T x = A[3 * k + j];
          A[3 * k + j] = A[3 * p + j];
          A[3 * p + j] = x;
        }
        const int x = perm[k];
        perm[k] = perm[p];
        perm[p] = x;
      }
      if (A[4 * k] == T(0)) ok = false;
      for (int i = k + 1; i < 3; ++i) {
        const T l = A[3 * i + k] / A[4 * k];
        A[3 * i + k] = l;
        for (int j = k + 1; j < 3; ++j) A[3 * i + j] = A[3 * i + j] - l * A[3 * k + j];
      }
    }
    // the inverse's column c solves L U x = P e_c
    T inv[9];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T y[3];
      for (int i = 0; i < 3; ++i) {
        T s = perm[i] == c ? T(1) : T(0);
        for (int j = 0; j < i; ++j) s = s - A[3 * i + j] * y[j];
        y[i] = s;
      }
      for (int i = 2; i >= 0; --i) {
        T s = y[i];
        for (int j = i + 1; j < 3; ++j) s = s - A[3 * i + j] * inv[3 * j + c];
        inv[3 * i + c] = s / A[4 * i];
      }
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      const T v = ok ? inv[e] : T(NAN);
      Vi[9 * ml + e] = v;
      Vinv[9 * m + e] = v;
    }
    gx[3 * ml] = g_x[3 * m];
    gx[3 * ml + 1] = g_x[3 * m + 1];
    gx[3 * ml + 2] = g_x[3 * m + 2];
  }
  for (int e = tid; e < 18 * W * mb; e += blockDim.x) {
    const int w = e / (18 * mb), r = e - 18 * mb * w, ml = r / 18, k = r - 18 * ml;
    Wg[e] = Wb[18 * (size_t(w) * M + m0 + ml) + k] * gauge_of(in.pose_mask, w);
  }
  __syncthreads();
  // 2. W V^-1
  for (int e = tid; e < 18 * W * mb; e += blockDim.x) {
    const int wm = e / 18, k = e - 18 * wm, a = k / 3, c = k - 3 * (k / 3);
    const int ml = wm - mb * (wm / mb);
    const T* x = Wg + 18 * wm + 3 * a;
    const T* y = Vi + 9 * ml + c;
    WV[e] = (x[0] * y[0] + x[1] * y[3]) + x[2] * y[6];
  }
  __syncthreads();
  // 3. the slice's partial sums of S's lower triangle (row-major) and of
  // the right-hand side's landmark term, over its landmarks in order
  const int nS = D * (D + 1) / 2;
  const size_t stride = size_t(nS) + D;
  T* part = partials + blockIdx.x * stride;
  for (int e = tid; e < nS + D; e += blockDim.x) {
    T acc = T(0);
    if (e < nS) {
      int i = int((sqrt(8.0 * e + 1.0) - 1.0) * 0.5);
      while (i * (i + 1) / 2 > e) --i;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      const int j = e - i * (i + 1) / 2;
      const int w = i / 6, a = i - 6 * w, v = j / 6, b = j - 6 * v;
      for (int ml = 0; ml < mb; ++ml) {
        const T* x = WV + 18 * (w * mb + ml) + 3 * a;
        const T* y = Wg + 18 * (v * mb + ml) + 3 * b;
        acc = acc + ((x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]);
      }
    } else {
      const int i = e - nS, w = i / 6, a = i - 6 * w;
      for (int ml = 0; ml < mb; ++ml) {
        const T* x = WV + 18 * (w * mb + ml) + 3 * a;
        const T* y = gx + 3 * ml;
        acc = acc + ((x[0] * y[0] + x[1] * y[1]) + x[2] * y[2]);
      }
    }
    part[e] = acc;
  }
  if (!last_cta(ticket, &s_flag)) return;

  // 4. the last CTA: S = (-sum + blockdiag(U_damped)) + He, the
  // right-hand side, the Cholesky, the solves, dp, the candidate poses
  const int C = gridDim.x;
  T* S = S_global ? S_global : sm;             // [D, D], the lower triangle used
  T* vec = S_global ? sm : sm + size_t(D) * D;
  T* rhs = vec;            // [D]
  T* z = rhs + D;          // [D] forward sweep
  T* x = z + D;            // [D] solution
  T* piv = x + D;          // [D] the factor's diagonal
  T* dps = piv + D;        // [D] dp
  T* gs = dps + D;         // [W] gauge
  int* fail = &s_flag;
  for (int w = tid; w < W; w += blockDim.x) gs[w] = gauge_of(in.pose_mask, w);
  __syncthreads();
  for (int e = tid; e < nS + D; e += blockDim.x) {
    T acc = T(0);
    for (int c = 0; c < C; ++c) acc = acc + __ldcg(partials + c * stride + e);
    if (e < nS) {
      int i = int((sqrt(8.0 * e + 1.0) - 1.0) * 0.5);
      while (i * (i + 1) / 2 > e) --i;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      const int j = e - i * (i + 1) / 2;
      const int w = i / 6, a = i - 6 * w, v = j / 6, b = j - 6 * v;
      T s = -acc;
      if (w == v) {
        // U * gauge, + lam diag, + (1 - gauge) on the diagonal
        const T g = gs[w];
        T u = U[36 * w + 6 * a + b] * g;
        if (a == b) u = (u + lam * u) + (T(1) - g);
        s = s + u;
      }
      // He = H_o gauged on both sides, + lam diag(He)
      T he = (H_o[size_t(i) * D + j] * gs[w]) * gs[v];
      if (i == j) he = he + lam * he;
      S[size_t(i) * D + j] = s + he;
    } else {
      const int i = e - nS, w = i / 6;
      rhs[i] = g_p[i] * gs[w] - acc;
    }
  }
  if (tid == 0) *fail = 0;
  __syncthreads();
  // right-looking Cholesky, two barriers a pivot; every thread takes the
  // pivot's square root itself
  for (int j = 0; j < D; ++j) {
    const T d = S[size_t(j) * D + j];
    if (!(d > T(0))) {
      if (tid == 0) *fail = 1;
      break;
    }
    const T p = sqrt(d);
    if (tid == 0) piv[j] = p;
    for (int i = j + 1 + tid; i < D; i += blockDim.x)
      S[size_t(i) * D + j] = S[size_t(i) * D + j] / p;
    __syncthreads();
    const int n = D - j - 1;
    for (int f = tid; f < n * n; f += blockDim.x) {
      const int i = j + 1 + f / n, k = j + 1 + (f - n * (f / n));
      if (k <= i)
        S[size_t(i) * D + k] = S[size_t(i) * D + k] - S[size_t(i) * D + j] * S[size_t(k) * D + j];
    }
    __syncthreads();
  }
  __syncthreads();
  const bool failed = *fail != 0;
  if (!failed && tid < kWarp) {
    // L z = rhs, then L^T x = z, row by row in warp 0
    for (int i = tid; i < D; i += kWarp) z[i] = rhs[i];
    __syncwarp();
    for (int j = 0; j < D; ++j) {
      const T zj = z[j] / piv[j];
      __syncwarp();
      if (tid == 0) z[j] = zj;
      for (int i = j + 1 + tid; i < D; i += kWarp) z[i] = z[i] - S[size_t(i) * D + j] * zj;
      __syncwarp();
    }
    for (int j = D - 1; j >= 0; --j) {
      const T xj = z[j] / piv[j];
      __syncwarp();
      if (tid == 0) x[j] = xj;
      for (int i = tid; i < j; i += kWarp) z[i] = z[i] - S[size_t(j) * D + i] * xj;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < D; i += blockDim.x) {
    const T v = failed ? T(NAN) : -x[i];
    const T d = v * gs[i / 6];
    dps[i] = d;
    dp[i] = d;
  }
  __syncthreads();
  // the candidate poses t + dt, q (x) exp(dw)
  for (int w = tid; w < W; w += blockDim.x) {
    const T* d = dps + 6 * w;
    cand_t[3 * w] = t[3 * w] + d[0];
    cand_t[3 * w + 1] = t[3 * w + 1] + d[1];
    cand_t[3 * w + 2] = t[3 * w + 2] + d[2];
    const Quat<T> cq =
        spline::qmul(load_q(q, w), spline::quat_exp(V3<T>{d[3], d[4], d[5]}, small_threshold<T>()));
    cand_q[4 * w] = cq.x;
    cand_q[4 * w + 1] = cq.y;
    cand_q[4 * w + 2] = cq.z;
    cand_q[4 * w + 3] = cq.w;
  }
  // dx = -V^-1 (g_x + sum_w W_blk^T dp), the candidate points
  for (int m = tid; m < M; m += blockDim.x) {
    T v[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) v[b] = T(0);
    for (int w = 0; w < W; ++w) {
      const T g = gs[w];
      const T* wb = Wb + 18 * (size_t(w) * M + m);
      for (int a = 0; a < 6; ++a) {
        const T d = dps[6 * w + a];
#pragma unroll
        for (int b = 0; b < 3; ++b) v[b] = v[b] + (wb[3 * a + b] * g) * d;
      }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) v[b] = g_x[3 * size_t(m) + b] + v[b];
    const T* vi = Vinv + 9 * size_t(m);
    const T pm = in.point_mask[m];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T d = -((__ldcg(vi + 3 * a) * v[0] + __ldcg(vi + 3 * a + 1) * v[1]) +
                    __ldcg(vi + 3 * a + 2) * v[2]);
      dx[3 * size_t(m) + a] = d;
      cand_X[3 * size_t(m) + a] = X[3 * size_t(m) + a] + d * pm;
    }
  }
  if (tid == 0) *ticket = 0u;
}

// ------------------------------------------------------------------ K12

// shared memory (elements of T): phase 1 the candidate poses [W, 7] and the
// slice's rho mask and mask [W MB] each; the last CTA's phase the edges'
// residuals [W - 1, 6] and the sums
__host__ __device__ inline size_t commit_smem_elems(int W, int MB) {
  const size_t p1 = size_t(7) * W + size_t(2) * W * MB;
  const size_t p2 = size_t(6) * (W > 1 ? W - 1 : 0) + 8;
  return p1 > p2 ? p1 : p2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ba_commit_kernel(T* __restrict__ t, T* __restrict__ q, T* __restrict__ X, T* __restrict__ sc,
                     Inputs<T> in, const T* __restrict__ dp, const T* __restrict__ dx,
                     const T* __restrict__ cand_t, const T* __restrict__ cand_q,
                     const T* __restrict__ cand_X, T* __restrict__ partials,
                     unsigned* __restrict__ ticket, double huber_a, double lambda_up,
                     double lambda_down, double min_lambda, double max_lambda,
                     double min_rel_decrease) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_flag;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int W = in.W, M = in.M, tid = threadIdx.x;
  const int m0 = blockIdx.x * in.MB;
  const int mb = min(in.MB, M - m0);
  const int nobs = W * mb;
  T* qs = sm;               // [W, 4] candidate q^-1
  T* ts = qs + 4 * W;       // [W, 3]
  T* rm = ts + 3 * W;       // [W mb] rho mask
  T* ms = rm + nobs;        // [W mb] mask
  for (int w = tid; w < W; w += blockDim.x) {
    const Quat<T> qi = spline::qconj(load_q(cand_q, w));
    qs[4 * w] = qi.x;
    qs[4 * w + 1] = qi.y;
    qs[4 * w + 2] = qi.z;
    qs[4 * w + 3] = qi.w;
    ts[3 * w] = cand_t[3 * w];
    ts[3 * w + 1] = cand_t[3 * w + 1];
    ts[3 * w + 2] = cand_t[3 * w + 2];
  }
  __syncthreads();
  // 1. the candidate's robust cost of each observation (K10's residual and
  // Huber, in K10's slice and lane order)
  for (int o = tid; o < nobs; o += blockDim.x) {
    const int w = o / mb, m = m0 + (o - w * mb);
    const Pose3<T> P{Quat<T>{qs[4 * w], qs[4 * w + 1], qs[4 * w + 2], qs[4 * w + 3]},
                     V3<T>{ts[3 * w], ts[3 * w + 1], ts[3 * w + 2]}};
    const V3<T> Pc = camera_point(P, load_v(cand_X, m));
    const size_t wm = size_t(w) * M + m;
    T r[2];
    residual(Pc, in.K, in.obs[2 * wm], in.obs[2 * wm + 1], r);
    T rho, w2;
    huber(r, huber_a, rho, w2);
    const T mask = in.obs_mask[wm] * in.point_mask[m];
    rm[o] = rho * mask;
    ms[o] = mask;
  }
  // whether any of the slice's dx is not finite
  bool bad = false;
  for (int e = tid; e < 3 * mb; e += blockDim.x) bad |= !isfinite(dx[3 * size_t(m0) + e]);
  const int any_bad = __syncthreads_or(bad);
  T* part = partials + 3 * blockIdx.x;
  if (tid < kWarp) {
    T s_rho = T(0), s_n = T(0);
    for (int o = tid; o < nobs; o += kWarp) {
      s_rho = s_rho + rm[o];
      s_n = s_n + ms[o];
    }
#pragma unroll
    for (int k = kWarp / 2; k > 0; k >>= 1) {
      s_rho = s_rho + __shfl_xor_sync(0xffffffffu, s_rho, k);
      s_n = s_n + __shfl_xor_sync(0xffffffffu, s_n, k);
    }
    if (tid == 0) {
      part[0] = s_rho;
      part[1] = s_n;
      part[2] = any_bad ? T(1) : T(0);
    }
  }
  if (!last_cta(ticket, &s_flag)) return;

  // 2. the last CTA: the candidate's cost, the decision, the select
  const int C = gridDim.x, E = W - 1, D = 6 * W;
  T* re = sm;               // [E, 6] the prior's residuals at the candidate
  T* tot = re + 6 * (E > 0 ? E : 0);   // rho, n, bad, ok
  if (tid < 3) {
    T acc = T(0);
    for (int c = 0; c < C; ++c) acc = acc + __ldcg(partials + 3 * c + tid);
    tot[tid] = acc;
  }
  const bool prior = in.odom_t != nullptr;
  if (prior) edge_residuals(in, cand_t, cand_q, re);
  bool dp_bad = false;
  for (int i = tid; i < D; i += blockDim.x) dp_bad |= !isfinite(dp[i]);
  const int any_dp_bad = __syncthreads_or(dp_bad);
  if (tid == 0) {
    const T c_e = prior ? prior_eval_sum(in, re, 6) : T(0);
    const T n = clamp_min(tot[1], T(1));
    const T cand_cost = tot[0] / n + (T(0.5) * c_e) * (T(1) / n);
    const T cost = sc[B_COST], lam = sc[B_LAM];
    const bool done_in = sc[B_DONE] != T(0);
    const bool ok = (cand_cost < cost) && !any_dp_bad && tot[2] == T(0) && !done_in;
    const T rel = (cost - cand_cost) / clamp_min(cost, T(1e-24));
    if (!done_in) {
      sc[B_CAND_COST] = cand_cost;
      sc[B_OK] = ok ? T(1) : T(0);
      sc[B_REL] = rel;
      sc[B_LAM] = ok ? clamp_min(lam * T(lambda_down), T(min_lambda))
                     : clamp_max(lam * T(lambda_up), T(max_lambda));
      sc[B_DONE] = (ok && rel < T(min_rel_decrease)) ? T(1) : T(0);
      sc[B_IT] = sc[B_IT] + T(1);
      if (ok) sc[B_COST] = cand_cost;
    }
    tot[3] = ok ? T(1) : T(0);
  }
  __syncthreads();
  if (tot[3] != T(0)) {
    for (int e = tid; e < 3 * W; e += blockDim.x) t[e] = cand_t[e];
    for (int e = tid; e < 4 * W; e += blockDim.x) q[e] = cand_q[e];
    for (int e = tid; e < 3 * M; e += blockDim.x) X[e] = cand_X[e];
  }
  if (tid == 0) *ticket = 0u;
}

// ------------------------------------------------------------ launchers

template <typename K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  return cudaSuccess;
}

template <typename T>
Inputs<T> inputs(const T* obs, const T* obs_mask, const T* point_mask, const T* K,
                 const T* odom_t, const T* odom_q, const T* odom_w, const T* pose_mask, int W,
                 int M, int MB) {
  return Inputs<T>{obs, obs_mask, point_mask, K, odom_t, odom_q, odom_w, pose_mask, W, M, MB};
}

int grid_of(int M, int MB) { return (M + MB - 1) / MB; }

bool bad_sizes(int W, int M, int MB) { return W < 1 || M < 1 || MB < 1; }

template <typename T>
int launch_build(const T* t, const T* q, const T* X, T* sc, Inputs<T> in, T* U, T* V, T* Wb,
                 T* g_p, T* g_x, T* H_o, T* partials, unsigned* ticket, double huber_a,
                 cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB)) return cudaErrorInvalidValue;
  const size_t smem = build_smem_elems(in.W, in.MB) * sizeof(T);
  cudaError_t err = opt_in(ba_build_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ba_build_kernel<T><<<grid_of(in.M, in.MB), kThreads, smem, stream>>>(
      t, q, X, sc, in, U, V, Wb, g_p, g_x, H_o, partials, ticket, huber_a);
  return cudaGetLastError();
}

template <typename T>
int launch_step(const T* t, const T* q, const T* X, const T* sc, Inputs<T> in, const T* U,
                const T* V, const T* Wb, const T* g_p, const T* g_x, const T* H_o, T* dp, T* dx,
                T* cand_t, T* cand_q, T* cand_X, T* Vinv, T* partials, T* S_global,
                unsigned* ticket, double landmark_damping, cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB)) return cudaErrorInvalidValue;
  const size_t smem = step_smem_elems(in.W, in.MB, S_global == nullptr) * sizeof(T);
  cudaError_t err = opt_in(ba_step_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ba_step_kernel<T><<<grid_of(in.M, in.MB), kThreads, smem, stream>>>(
      t, q, X, sc, in, U, V, Wb, g_p, g_x, H_o, dp, dx, cand_t, cand_q, cand_X, Vinv, partials,
      S_global, ticket, landmark_damping);
  return cudaGetLastError();
}

template <typename T>
int launch_commit(T* t, T* q, T* X, T* sc, Inputs<T> in, const T* dp, const T* dx,
                  const T* cand_t, const T* cand_q, const T* cand_X, T* partials,
                  unsigned* ticket, double huber_a, double lambda_up, double lambda_down,
                  double min_lambda, double max_lambda, double min_rel_decrease,
                  cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB)) return cudaErrorInvalidValue;
  const size_t smem = commit_smem_elems(in.W, in.MB) * sizeof(T);
  cudaError_t err = opt_in(ba_commit_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ba_commit_kernel<T><<<grid_of(in.M, in.MB), kThreads, smem, stream>>>(
      t, q, X, sc, in, dp, dx, cand_t, cand_q, cand_X, partials, ticket, huber_a, lambda_up,
      lambda_down, min_lambda, max_lambda, min_rel_decrease);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ba_scalars_size() { return B_SIZE; }

// shared bytes of each kernel at W poses, MB landmarks a CTA and the dtype's
// size (K11 with S in shared memory when s_shared)
long long ba_smem_bytes(int kernel, int W, int MB, int itemsize, int s_shared) {
  const size_t e = kernel == 10 ? build_smem_elems(W, MB)
                   : kernel == 11 ? step_smem_elems(W, MB, s_shared != 0)
                                  : commit_smem_elems(W, MB);
  return (long long)(e * size_t(itemsize));
}

#define BA_ENTRIES(T, SUFFIX)                                                                  \
  int ba_build_##SUFFIX(const T* t, const T* q, const T* X, T* sc, const T* obs,              \
                        const T* obs_mask, const T* point_mask, const T* K, const T* odom_t,  \
                        const T* odom_q, const T* odom_w, const T* pose_mask, T* U, T* V,     \
                        T* Wb, T* g_p, T* g_x, T* H_o, T* partials, unsigned* ticket, int W,  \
                        int M, int MB, double huber_a, cudaStream_t stream) {                 \
    return launch_build<T>(t, q, X, sc,                                                        \
                           inputs<T>(obs, obs_mask, point_mask, K, odom_t, odom_q, odom_w,     \
                                     pose_mask, W, M, MB),                                     \
                           U, V, Wb, g_p, g_x, H_o, partials, ticket, huber_a, stream);        \
  }                                                                                            \
  int ba_step_##SUFFIX(const T* t, const T* q, const T* X, const T* sc, const T* point_mask,  \
                       const T* pose_mask, const T* U, const T* V, const T* Wb, const T* g_p,  \
                       const T* g_x, const T* H_o, T* dp, T* dx, T* cand_t, T* cand_q,         \
                       T* cand_X, T* Vinv, T* partials, T* S_global, unsigned* ticket, int W,  \
                       int M, int MB, double landmark_damping, cudaStream_t stream) {          \
    return launch_step<T>(t, q, X, sc,                                                         \
                          inputs<T>(nullptr, nullptr, point_mask, nullptr, nullptr, nullptr,   \
                                    nullptr, pose_mask, W, M, MB),                             \
                          U, V, Wb, g_p, g_x, H_o, dp, dx, cand_t, cand_q, cand_X, Vinv,       \
                          partials, S_global, ticket, landmark_damping, stream);               \
  }                                                                                            \
  int ba_commit_##SUFFIX(T* t, T* q, T* X, T* sc, const T* obs, const T* obs_mask,            \
                         const T* point_mask, const T* K, const T* odom_t, const T* odom_q,   \
                         const T* odom_w, const T* dp, const T* dx, const T* cand_t,          \
                         const T* cand_q, const T* cand_X, T* partials, unsigned* ticket,     \
                         int W, int M, int MB, double huber_a, double lambda_up,              \
                         double lambda_down, double min_lambda, double max_lambda,            \
                         double min_rel_decrease, cudaStream_t stream) {                      \
    return launch_commit<T>(t, q, X, sc,                                                       \
                            inputs<T>(obs, obs_mask, point_mask, K, odom_t, odom_q, odom_w,    \
                                      nullptr, W, M, MB),                                      \
                            dp, dx, cand_t, cand_q, cand_X, partials, ticket, huber_a,         \
                            lambda_up, lambda_down, min_lambda, max_lambda, min_rel_decrease,  \
                            stream);                                                           \
  }

BA_ENTRIES(float, f32)
BA_ENTRIES(double, f64)

}  // extern "C"
