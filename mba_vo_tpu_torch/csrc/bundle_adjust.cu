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
// of the Cholesky (a square root and a division each) and the 6W
// divisions of each triangular solve.
//
// Design: the landmarks split into C = ceil(M / MB) contiguous slices of MB
// landmarks (ops/cuda_ba.py::ba_layout: MB <= 32, fewer where the window is
// wide), a CTA of 256 threads a slice in K10 and K11. A CTA stages its
// slice's per-observation quantities in shared memory, writes what is per
// landmark or per observation directly, and writes its partial sums of
// what is summed across landmarks (U and g_p; S's lower triangle and the
// right-hand side) to a scratch buffer [C, ...].
//
//   * K10 (band design): the last CTA to take an integer ticket adds the C
//     partials in slice order and finishes the stage; the prior's edges
//     come from one more CTA beside the slices', so the last CTA only sums
//     (ba_build_kernel);
//   * K11 (cooperative design, ba_step_kernel): one cooperative launch,
//     every CTA resident; a slice's partial S on the FP64 tensor cores;
//     grid barriers replace the ticket, the C partials are summed by all
//     CTAs (a share each), S is factored by 6 x 6 blocks (three barriers a
//     block, the right-hand side a row of the factor, so the forward sweep
//     falls out of the updates; reciprocal pivots) and every CTA
//     back-substitutes its own slice from shared memory;
//   * K12 (cluster design, ba_commit_kernel): one thread-block cluster of
//     min(C, 16) CTAs, rank k the slices k, k + G, ...; each slice's rho
//     sum, count and dx flag stored into every rank's shared memory before
//     the cluster's barrier, the prior on a warp of its own beside the
//     observations, every CTA summing the C partials in slice order and
//     deciding, each rank committing its own slices of X.
//
// The earlier ticket designs of K10, K11 and K12 (ba_build_ticket_kernel,
// ba_step_ticket_kernel, ba_commit_ticket_kernel) stay as sweep rows: the
// path launches none of them. The ticket decides who combines, never in
// what order: every sum has one fixed order, so a run repeats bit for bit.
// K10's two designs take every sum and rounding in the same order and
// agree bit for bit, and so do K12's. K11's
// cooperative design takes two new orders: in float64 a slice's partial S
// and right-hand side are summed by the FP64 tensor cores (mma.sync
// m8n8k4: over k = 3 ml + c in steps of four, the even steps and the odd
// steps in two running sums added at the end, each step's four products
// and its running sum combined as the hardware does; float32 keeps the
// ticket design's sums), and each column of the factor is scaled by its
// pivot's reciprocal square root where the ticket design divides by the
// square root (factor_solve).
//
// Orders: a CTA's rho sum and count are lane l's observations l, l + 32,
// ... of the slice in order, then lane 0's butterfly of shuffles, the same
// in K10 and K12, so the cost K10 writes at the first iteration and K12's
// candidate costs are one function of the state. V, g_x sum over the poses
// in order; U, g_p, S and the right-hand side over a slice's landmarks in
// order, then the slices in order; each product rounded (this source builds
// with -fmad=false, ops/cuda_build.py), the terms of a Jacobian product
// taken as torch's elementwise ops take them. The Cholesky is
// right-looking: each entry of the factor (and of the forward sweep)
// updated once a pivot, in pivot order, then scaled by its pivot (the
// ticket design divides by sqrt(d), the cooperative one multiplies by
// rsqrt(d)); the back-substitution takes each unknown in descending order. Neither
// cuBLAS's nor LAPACK's orders can be followed: the kernels agree with the
// plain versions within the roundoff of a sum, not bit for bit.
//
// S lives in shared memory while it fits with K11's vectors, else in a
// global scratch matrix the wrapper allocates (ops/cuda_ba.py::ba_layout).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "spline_pose.cuh"

namespace {

namespace cg = cooperative_groups;
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
constexpr int kBuildThreads = 384;    // K10's band design: U and g_p in one round at W = 7
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

// ------------------------------------------------------- phase stamps

// Where the time of a launch goes, by phase: in a build with BA_PHASE_CLOCKS
// defined (experiments/ba_kernels.py's phase split; never the library the
// path loads) thread 0 of each CTA stamps %globaltimer into
// g_stamps[kernel][cta][slot] at each phase's end, after a barrier of its
// CTA (stamp_by: one thread where the CTA's warps part, K12's cluster
// design); without the macro a stamp is nothing. Kernel ids: kStamp* below.
enum {
  kStampBuild = 0,
  kStampStep,
  kStampBuildTicket,
  kStampStepTicket,
  kStampCommit,
  kStampCommitTicket,
  kStampKernels
};
constexpr int kStampSlots = 20;
constexpr int kStampCtas = 1024;

#ifdef BA_PHASE_CLOCKS
__device__ unsigned long long g_stamps[kStampKernels][kStampCtas][kStampSlots];

// a stamp by the calling thread where ``me``, with no barrier (where the
// CTA's threads are not all on one path)
__device__ __forceinline__ void stamp_by(bool me, int kernel, int slot) {
  if (me && blockIdx.x < kStampCtas) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    g_stamps[kernel][blockIdx.x][slot] = now;
  }
}

__device__ __forceinline__ void stamp(int kernel, int slot) {
  __syncthreads();
  stamp_by(threadIdx.x == 0, kernel, slot);
}

// sub-phases in CTA 0: thread 0's clock64 cycles since ``since``, added
// into slot ``slot`` of ``kernel`` (K11's factorisation by sub-phase,
// summed over the block steps, in slots 12-15; K11's phase 3 in 16; K10's
// pose setup and observations in 16 and 17)
__device__ __forceinline__ void add_cycles(int slot, long long& since, int kernel = kStampStep) {
  const long long now = clock64();
  if (threadIdx.x == 0 && blockIdx.x == 0) g_stamps[kernel][0][slot] += now - since;
  since = now;
}
#else
__device__ __forceinline__ void stamp_by(bool, int, int) {}
__device__ __forceinline__ void stamp(int, int) {}
__device__ __forceinline__ void add_cycles(int, long long&, int = 0) {}
#endif

// ------------------------------------------------------------------ K10

// shared memory (elements of T), both designs: phase 1 the poses [W, 16]
// and the slice's observations [W MB, 23]; the last CTA's phase the edges
// [W - 1, 78], g_p [6W] and the rho sum and count
__host__ __device__ inline size_t build_smem_elems(int W, int MB) {
  const size_t p1 = size_t(16) * W + size_t(23) * W * MB;
  const size_t p3 = size_t(78) * (W > 1 ? W - 1 : 0) + size_t(6) * W + 4;
  return p1 > p3 ? p1 : p3;
}

// K10's phases 1 and 2 in one CTA: each observation's residual, Jacobians
// and weight, W_blk written; per landmark V and g_x written; the slice's
// partial U, g_p, rho sum and count into ``part``. Phase 2 in the ticket
// design a thread an entry; ``kTiled`` (the band design, 384 threads) a
// thread an entry of U and g_p, all in one round, and a thread a
// landmark's V and g_x, each entry summed in the same order, and the rho
// sum in the last warp
template <typename T, bool kTiled>
__device__ __forceinline__ void build_slice(const T* __restrict__ t, const T* __restrict__ q,
                                            const T* __restrict__ X, const Inputs<T>& in,
                                            T* __restrict__ V, T* __restrict__ Wb,
                                            T* __restrict__ g_x, T* __restrict__ part,
                                            double huber_a, T* sm, int stamp_id) {
  const int W = in.W, M = in.M, tid = threadIdx.x;
  const int m0 = blockIdx.x * in.MB;
  const int mb = min(in.MB, M - m0);   // landmarks of this slice
  const int nobs = W * mb;
  T* qs = sm;                  // [W, 4] q^-1
  T* ts = qs + 4 * W;          // [W, 3]
  T* Rt = ts + 3 * W;          // [W, 9] R^T
  T* ob = Rt + 9 * W;          // [W mb, 23]: Jp 12, Jx 6, r 2, wgt, rho mask, mask

  // kTiled: this thread's first observation's inputs (the point, the pixel
  // and both masks) loaded before the poses' barrier, one trip to memory
  // fewer on the way
  long long since = clock64();
  T pre[7];
  if (kTiled && tid < nobs) {
    const int w = tid / mb, m = m0 + (tid - w * mb);
    const size_t wm = size_t(w) * M + m;
    pre[0] = X[3 * m];
    pre[1] = X[3 * m + 1];
    pre[2] = X[3 * m + 2];
    pre[3] = in.obs[2 * wm];
    pre[4] = in.obs[2 * wm + 1];
    pre[5] = in.obs_mask[wm];
    pre[6] = in.point_mask[m];
  }
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
  if (kTiled) add_cycles(16, since, stamp_id);

  // 1. each observation: r, the Jacobians, the weight; W_blk written
  for (int o = tid; o < nobs; o += blockDim.x) {
    const int w = o / mb, m = m0 + (o - w * mb);
    const Pose3<T> P{Quat<T>{qs[4 * w], qs[4 * w + 1], qs[4 * w + 2], qs[4 * w + 3]},
                     V3<T>{ts[3 * w], ts[3 * w + 1], ts[3 * w + 2]}};
    const size_t wm = size_t(w) * M + m;
    const bool first = kTiled && o == tid;
    const V3<T> Pc = camera_point(P, first ? V3<T>{pre[0], pre[1], pre[2]} : load_v(X, m));
    T r[2];
    residual(Pc, in.K, first ? pre[3] : in.obs[2 * wm], first ? pre[4] : in.obs[2 * wm + 1], r);
    T rho, w2;
    huber(r, huber_a, rho, w2);
    const T mask = (first ? pre[5] : in.obs_mask[wm]) * (first ? pre[6] : in.point_mask[m]);
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
  if (kTiled) add_cycles(17, since, stamp_id);
  __syncthreads();
  stamp(stamp_id, 1);

  // 2. per landmark V and g_x (over the poses in order); per pose the
  // slice's partial U and g_p (over its landmarks in order)
  const int n_lm = 12 * mb, n_pose = 42 * W;
  if (kTiled) {
    const int lm0 = (n_pose + kWarp - 1) / kWarp * kWarp;
    for (int u = tid; u < lm0 + mb; u += blockDim.x) {
      if (u < n_pose) {
        const int w = u / 42, k = u - 42 * w;
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
        part[u] = acc;
      } else if (u >= lm0) {
        const int ml = u - lm0;
        T acc[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) acc[k] = T(0);
        for (int w = 0; w < W; ++w) {
          const T* s = ob + 23 * (w * mb + ml);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            const T pa = s[12 + a] * s[20], qa = s[15 + a] * s[20];
#pragma unroll
            for (int b = 0; b < 3; ++b)
              acc[3 * a + b] = acc[3 * a + b] + (pa * s[12 + b] + qa * s[15 + b]);
            acc[9 + a] = acc[9 + a] + (pa * s[18] + qa * s[19]);
          }
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) V[9 * size_t(m0 + ml) + k] = acc[k];
#pragma unroll
        for (int a = 0; a < 3; ++a) g_x[3 * size_t(m0 + ml) + a] = acc[9 + a];
      }
    }
  } else for (int e = tid; e < n_lm + n_pose; e += blockDim.x) {
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
  // the slice's rho sum and observation count (warp 0, or the last warp
  // where tiled; lane order); the observations' rho mask and mask sit at
  // stride 23
  const int lane = tid - (kTiled ? int(blockDim.x) - kWarp : 0);
  if (lane >= 0 && lane < kWarp) {
    T s_rho = T(0), s_n = T(0);
    for (int o = lane; o < nobs; o += kWarp) {
      s_rho = s_rho + ob[23 * o + 21];
      s_n = s_n + ob[23 * o + 22];
    }
#pragma unroll
    for (int k = kWarp / 2; k > 0; k >>= 1) {
      s_rho = s_rho + __shfl_xor_sync(0xffffffffu, s_rho, k);
      s_n = s_n + __shfl_xor_sync(0xffffffffu, s_n, k);
    }
    if (lane == 0) {
      part[n_pose] = s_rho;
      part[n_pose + 1] = s_n;
    }
  }
  stamp(stamp_id, 2);
}

// sum_c x[c stride] over c < C in order; ``kBatched``: the loads issued
// eight at a time before their adds (one trip to the L2 for eight)
template <typename T, bool kBatched>
__device__ __forceinline__ T sum_slices(const T* __restrict__ x, size_t stride, int C) {
  T acc = T(0);
  int c = 0;
  if (kBatched) {
    for (; c + 8 <= C; c += 8) {
      T v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldcg(x + (c + k) * stride);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = acc + v[k];
    }
  }
  for (; c < C; ++c) acc = acc + __ldcg(x + c * stride);
  return acc;
}

// the last CTA of either K10 design: the slices' partials in slice order
// into U, the reprojection g_p ``gps`` and ``tot`` (the rho sum and count)
template <typename T, bool kBatched>
__device__ __forceinline__ void build_partial_sums(const T* __restrict__ partials, int W, int C,
                                                   T* __restrict__ U, T* gps, T* tot) {
  const int n_pose = 42 * W;
  const size_t stride = size_t(42) * W + 2;
  for (int f = threadIdx.x; f < n_pose + 2; f += blockDim.x) {
    const T acc = sum_slices<T, kBatched>(partials + f, stride, C);
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
}

// H_o's entry (i, j) in block (p, pp), |p - pp| <= 1: sum_e J_e^T w_e J_e over
// the edges that touch both poses, in edge order
template <typename T>
__device__ __forceinline__ T prior_h_entry(const Inputs<T>& in, const T* edges, int p, int a,
                                           int pp, int b) {
  const int E = in.W - 1;
  T acc = T(0);
  for (int e = max(max(p, pp) - 1, 0); e <= min(min(p, pp), E - 1); ++e) {
    const T* x = edges + 78 * e;
    const T* Ja = x + (p == e ? 6 : 42);
    const T* Jb = x + (pp == e ? 6 : 42);
    const T we = in.odom_w[e];
    for (int k = 0; k < 6; ++k) acc = acc + (Ja[6 * k + a] * we) * Jb[6 * k + b];
  }
  return acc;
}

// the prior's g_o entry i (over the edges in order)
template <typename T>
__device__ __forceinline__ T prior_g_entry(const Inputs<T>& in, const T* edges, int i) {
  const int E = in.W - 1, p = i / 6, a = i - 6 * p;
  T acc = T(0);
  for (int e = max(p - 1, 0); e <= min(p, E - 1); ++e) {
    const T* x = edges + 78 * e;
    const T* Ja = x + (p == e ? 6 : 42);
    const T we = in.odom_w[e];
    for (int k = 0; k < 6; ++k) acc = acc + Ja[6 * k + a] * (we * x[k]);
  }
  return acc;
}

// g_p = the reprojection g_p + the prior's g_o
template <typename T>
__device__ __forceinline__ void prior_gradient(const Inputs<T>& in, const T* edges, bool prior,
                                               const T* gps, T* __restrict__ g_p) {
  for (int i = threadIdx.x; i < 6 * in.W; i += blockDim.x)
    g_p[i] = gps[i] + (prior ? prior_g_entry(in, edges, i) : T(0));
}

// the build's prior cost sum(w r^2), in edge order (evaluate_cost's is
// prior_eval_sum)
template <typename T>
__device__ __forceinline__ T prior_build_sum(const Inputs<T>& in, const T* r, int stride) {
  T s = T(0);
  for (int e = 0; e < in.W - 1; ++e)
    for (int k = 0; k < 6; ++k) {
      const T re = r[stride * e + k];
      s = s + in.odom_w[e] * (re * re);
    }
  return s;
}

// the build's cost and, at the loop's first iteration, the initial cost
template <typename T>
__device__ __forceinline__ void build_costs(T* __restrict__ sc, const T* tot, T c_b, T c_e) {
  const T n = clamp_min(tot[1], T(1));
  sc[B_BUILD_COST] = tot[0] / n + (T(0.5) * c_b) / n;
  if (sc[B_IT] == T(0)) {
    const T cost0 = tot[0] / n + (T(0.5) * c_e) * (T(1) / n);
    sc[B_COST] = cost0;
    sc[B_COST0] = cost0;
  }
}

// The earlier ticket design: the last CTA computes the prior's E edges on E
// threads after the ticket, writes H_o dense (a division an entry) and sums
// both prior costs on one thread
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ba_build_ticket_kernel(const T* __restrict__ t, const T* __restrict__ q,
                           const T* __restrict__ X, T* __restrict__ sc, Inputs<T> in,
                           T* __restrict__ U, T* __restrict__ V, T* __restrict__ Wb,
                           T* __restrict__ g_p, T* __restrict__ g_x, T* __restrict__ H_o,
                           T* __restrict__ partials, unsigned* __restrict__ ticket,
                           double huber_a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_flag;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int W = in.W, tid = threadIdx.x;
  stamp(kStampBuildTicket, 0);
  build_slice<T, false>(t, q, X, in, V, Wb, g_x, partials + blockIdx.x * (size_t(42) * W + 2),
                        huber_a, sm, kStampBuildTicket);
  if (!last_cta(ticket, &s_flag)) return;
  stamp(kStampBuildTicket, 3);

  // 3. the last CTA: the slices' partials in slice order, the prior, the
  // costs
  const int E = W - 1, D = 6 * W;
  T* edges = sm;                    // [E, 78]: r 6, J_i 36, J_j 36
  T* gps = edges + 78 * (E > 0 ? E : 0);   // [6W] the reprojection g_p
  T* tot = gps + 6 * W;             // rho sum, count
  build_partial_sums<T, false>(partials, W, int(gridDim.x), U, gps, tot);
  stamp(kStampBuildTicket, 4);
  const bool prior = in.odom_t != nullptr;
  if (prior) {
    for (int e = tid; e < E; e += blockDim.x) {
      T* x = edges + 78 * e;
      edge_jacobians(load_v(t, e), load_q(q, e), load_v(t, e + 1), load_q(q, e + 1),
                     load_v(in.odom_t, e), load_q(in.odom_q, e), x, x + 6, x + 42);
    }
  }
  __syncthreads();
  stamp(kStampBuildTicket, 5);
  // H_o = sum_e J_e^T w_e J_e over the edges that touch both poses, in edge
  // order; every entry off the band 0
  for (int f = tid; f < D * D; f += blockDim.x) {
    const int i = f / D, j = f - D * (f / D);
    const int p = i / 6, a = i - 6 * p, pp = j / 6, b = j - 6 * pp;
    H_o[f] = prior && abs(p - pp) <= 1 ? prior_h_entry(in, edges, p, a, pp, b) : T(0);
  }
  prior_gradient(in, edges, prior, gps, g_p);
  stamp(kStampBuildTicket, 6);
  if (tid == 0) {
    // the build's prior cost 0.5 sum(w r^2), evaluate_cost's 0.5 sum((w r) r)
    build_costs(sc, tot, prior ? prior_build_sum(in, edges, 78) : T(0),
                prior ? prior_eval_sum(in, edges, 78) : T(0));
    *ticket = 0u;
  }
  stamp(kStampBuildTicket, 7);
}

// The band design (launched): the prior depends on the poses and the
// odometry only, so one more CTA than the slices (C + 1 where there is a
// prior) computes all of it while the slices' CTAs run their phases 1 and
// 2 on other SMs: the E edges on E threads, H_o's block band |p - pp| <= 1
// (the blocks off it are zero from the binding's setup, and K11 reads only
// the band), g_o and the two prior costs (two warps at once, each in edge
// order) into a scratch [6W + 2]; it takes a ticket too. The slices' phase 2
// runs a thread a pose row and a thread a landmark (build_slice). The last
// CTA then only adds the slices' partials and the prior's g_o and writes
// the scalars. Every output equals the ticket design's bit for bit.
template <typename T>
__global__ void __launch_bounds__(kBuildThreads)
    ba_build_kernel(const T* __restrict__ t, const T* __restrict__ q, const T* __restrict__ X,
                    T* __restrict__ sc, Inputs<T> in, T* __restrict__ U, T* __restrict__ V,
                    T* __restrict__ Wb, T* __restrict__ g_p, T* __restrict__ g_x,
                    T* __restrict__ H_o, T* __restrict__ partials, T* __restrict__ prior_out,
                    unsigned* __restrict__ ticket, double huber_a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_flag;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int W = in.W, tid = threadIdx.x, E = W - 1, D = 6 * W;
  const int C = (in.M + in.MB - 1) / in.MB;   // the slices' CTAs
  const bool prior = in.odom_t != nullptr;
  stamp(kStampBuild, 0);
  if (int(blockIdx.x) >= C) {
    T* edges = sm;                  // [E, 78]: r 6, J_i 36, J_j 36
    for (int e = tid; e < E; e += blockDim.x) {
      T* x = edges + 78 * e;
      edge_jacobians(load_v(t, e), load_q(q, e), load_v(t, e + 1), load_q(q, e + 1),
                     load_v(in.odom_t, e), load_q(in.odom_q, e), x, x + 6, x + 42);
    }
    __syncthreads();
    // blocks (p, p - 1), (p, p), (p, p + 1) in order, 3W - 2 of them
    for (int f = tid; f < 36 * (3 * W - 2); f += blockDim.x) {
      const int blk = f / 36, ab = f - 36 * blk, a = ab / 6, b = ab - 6 * a;
      const int p = (blk + 1) / 3, pp = p - 1 + (blk + 1 - 3 * p);
      H_o[size_t(6 * p + a) * D + 6 * pp + b] = prior_h_entry(in, edges, p, a, pp, b);
    }
    for (int i = tid; i < D; i += blockDim.x) prior_out[i] = prior_g_entry(in, edges, i);
    if (tid == 0) prior_out[D] = prior_eval_sum(in, edges, 78);
    if (tid == kWarp) prior_out[D + 1] = prior_build_sum(in, edges, 78);
    stamp(kStampBuild, 2);
  } else {
    build_slice<T, true>(t, q, X, in, V, Wb, g_x, partials + blockIdx.x * (size_t(42) * W + 2),
                         huber_a, sm, kStampBuild);
  }
  if (!last_cta(ticket, &s_flag)) return;
  stamp(kStampBuild, 3);

  T* gps = sm;                      // [6W] the reprojection g_p
  T* tot = gps + 6 * W;             // rho sum, count
  build_partial_sums<T, true>(partials, W, C, U, gps, tot);
  __syncthreads();
  stamp(kStampBuild, 4);
  for (int i = tid; i < D; i += blockDim.x)
    g_p[i] = gps[i] + (prior ? __ldcg(prior_out + i) : T(0));
  if (tid == 0) {
    build_costs(sc, tot, prior ? __ldcg(prior_out + D + 1) : T(0),
                prior ? __ldcg(prior_out + D) : T(0));
    *ticket = 0u;
  }
  stamp(kStampBuild, 5);
}

// ------------------------------------------------------------------ K11

// each landmark of the slice: V damped, its inverse (LU with partial
// pivoting, NaN where a pivot is 0, as inv_ex and _nan_unless) into Vi [mb,
// 9] and Vinv, g_x into gx [mb, 3]; the gauged W_blk into Wg [W, mb, 18];
// then W V^-1 into WV [W, mb, 18] (both designs' phases 1 and 2). The
// ticket design a thread an entry; ``kTiled`` (the cooperative design) the
// W_blk loads eight at a time before their stores, and W V^-1 a thread a
// (pose, landmark) block, each entry rounded as there
template <typename T, bool kTiled>
__device__ __forceinline__ void step_slice(const Inputs<T>& in, T lam, double landmark_damping,
                                           const T* __restrict__ V, const T* __restrict__ Wb,
                                           const T* __restrict__ g_x, T* __restrict__ Vinv,
                                           T* Wg, T* WV, T* Vi, T* gx, int stamp_id) {
  const int W = in.W, M = in.M, tid = threadIdx.x;
  const int m0 = blockIdx.x * in.MB;
  const int mb = min(in.MB, M - m0);
  // the inverses' threads: all (ticket design), else the last warp, while
  // the others copy W_blk
  const int first = kTiled ? int(blockDim.x) - kWarp : 0;
  for (int ml = tid - first; ml >= 0 && ml < mb; ml += int(blockDim.x) - first) {
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
  if (kTiled) {
    // the slice's W_blk is W runs of 18 mb contiguous values
    const int n = 18 * mb, nt = first;
    constexpr int kBatch = 8;
    for (int e0 = tid; tid < nt && e0 < W * n; e0 += kBatch * nt) {
      T v[kBatch], g[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int e = e0 + k * nt;
        if (e < W * n) {
          const int w = e / n;
          v[k] = Wb[18 * (size_t(w) * M + m0) + (e - w * n)];
          g[k] = gauge_of(in.pose_mask, w);
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (e0 + k * nt < W * n) Wg[e0 + k * nt] = v[k] * g[k];
    }
  } else {
    for (int e = tid; e < 18 * W * mb; e += blockDim.x) {
      const int w = e / (18 * mb), r = e - 18 * mb * w, ml = r / 18, k = r - 18 * ml;
      Wg[e] = Wb[18 * (size_t(w) * M + m0 + ml) + k] * gauge_of(in.pose_mask, w);
    }
  }
  __syncthreads();
  stamp(stamp_id, 1);
  // 2. W V^-1
  if (kTiled) {
    for (int wm = tid; wm < W * mb; wm += blockDim.x) {
      const int ml = wm - mb * (wm / mb);
      T x[18], y[9];
#pragma unroll
      for (int k = 0; k < 18; ++k) x[k] = Wg[18 * wm + k];
#pragma unroll
      for (int k = 0; k < 9; ++k) y[k] = Vi[9 * ml + k];
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          WV[18 * wm + 3 * a + c] =
              (x[3 * a] * y[c] + x[3 * a + 1] * y[3 + c]) + x[3 * a + 2] * y[6 + c];
    }
  } else {
    for (int e = tid; e < 18 * W * mb; e += blockDim.x) {
      const int wm = e / 18, k = e - 18 * wm, a = k / 3, c = k - 3 * (k / 3);
      const int ml = wm - mb * (wm / mb);
      const T* x = Wg + 18 * wm + 3 * a;
      const T* y = Vi + 9 * ml + c;
      WV[e] = (x[0] * y[0] + x[1] * y[3]) + x[2] * y[6];
    }
  }
  __syncthreads();
  stamp(stamp_id, 2);
}

// shared memory (elements of T) of the ticket design: phase 1 the slice's
// W_blk and W V^-1 [W MB, 18] each, V^-1 [MB, 9] and g_x [MB, 3]; the last
// CTA's phase S [D, D] where it lives there, the right-hand side, the
// forward sweep, the solution and the pivots [D] each, dp [D] and the
// gauge [W]
__host__ __device__ inline size_t step_ticket_smem_elems(int W, int MB, bool s_shared) {
  const size_t D = size_t(6) * W;
  const size_t p1 = size_t(36) * W * MB + size_t(12) * MB;
  const size_t p2 = (s_shared ? D * D : 0) + 5 * D + W + 2;
  return p1 > p2 ? p1 : p2;
}

// The earlier ticket design: the last CTA alone sums the C slices' partials of
// S (decoding each entry's row with an f64 square root), factors S
// right-looking with two barriers a pivot, solves in one warp and
// back-substitutes every landmark from global memory
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ba_step_ticket_kernel(const T* __restrict__ t, const T* __restrict__ q,
                          const T* __restrict__ X, const T* __restrict__ sc, Inputs<T> in,
                          const T* __restrict__ U, const T* __restrict__ V,
                          const T* __restrict__ Wb, const T* __restrict__ g_p,
                          const T* __restrict__ g_x, const T* __restrict__ H_o,
                          T* __restrict__ dp, T* __restrict__ dx, T* __restrict__ cand_t,
                          T* __restrict__ cand_q, T* __restrict__ cand_X, T* __restrict__ Vinv,
                          T* __restrict__ partials, T* __restrict__ S_global,
                          unsigned* __restrict__ ticket, double landmark_damping) {
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
  stamp(kStampStepTicket, 0);
  step_slice<T, false>(in, lam, landmark_damping, V, Wb, g_x, Vinv, Wg, WV, Vi, gx,
                       kStampStepTicket);
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
  stamp(kStampStepTicket, 3);
  if (!last_cta(ticket, &s_flag)) return;
  stamp(kStampStepTicket, 4);

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
  stamp(kStampStepTicket, 5);
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
  stamp(kStampStepTicket, 6);
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
  stamp(kStampStepTicket, 7);
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
  stamp(kStampStepTicket, 8);
}

// A barrier of the whole grid, for a cooperative launch only (every CTA
// resident): bar[0] counts the CTAs' arrivals and is never reset; a CTA
// whose arrival made it n waits until it reaches the next multiple of the
// grid's size. One atomic a CTA. Every CTA of a launch passes the same
// barriers, so a launch leaves a multiple of its grid; the binding that
// owns the word (zeroed at its setup) would wrap it after 2^32 / C
// barriers.
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned n = atomicAdd(bar, 1u) + 1u;
    const unsigned target = (n + gridDim.x - 1) / gridDim.x * gridDim.x;
    volatile unsigned* count = bar;
    while (*count < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// d = a b + c on an 8 x 8 tile of a warp, FP64 tensor cores: lane l holds
// A[l / 4][l % 4], B[l % 4][l / 4] and C, D[l / 4][2 (l % 4) + {0, 1}]
__device__ __forceinline__ void dmma_8x8x4(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// K11's phase 3 on the FP64 tensor cores: the slice's partial S = WV Wg^T
// (WV [6W, 3 mb], row i = 6w + a holding WV[w, ml, 3a + c] at k = 3 ml + c;
// Wg likewise) and its right-hand side WV g_x, the latter as column 6W of
// the product; 8 x 8 tiles of the lower triangle and of column 6W, row by
// row, tile t to warp t mod warps; a warp runs up to four of its tiles at
// once, each over k in steps of four (zero past 3 mb) in two chains, the
// even steps' and the odd steps', added at the end; written into ``part``
// packed
__device__ __forceinline__ void mma_tile_of(int t, int cD, int& r, int& c) {
  int base = 0;
  for (r = 0;; ++r) {
    const int nc = r + 1 + (cD > r ? 1 : 0);
    if (t < base + nc) {
      c = t - base <= r ? t - base : cD;
      return;
    }
    base += nc;
  }
}

template <typename T>
__device__ __forceinline__ void slice_partials_mma(const T* WV, const T* Wg, const T* gx, int W,
                                                   int mb, T* __restrict__ part) {
  const int D = 6 * W, K = 3 * mb, nS = D * (D + 1) / 2;
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp, g = lane >> 2, q = lane & 3;
  const int R8 = (D + 7) / 8, cD = D / 8;   // row tiles; the tile column of column D
  const int tiles = R8 * (R8 + 1) / 2 + min(cD, R8);
  constexpr int kTiles = 4;
  for (int t0 = warp; t0 < tiles; t0 += kTiles * warps) {
    int r[kTiles], c[kTiles];
    const T* ab[kTiles];
    const T* bb[kTiles];
    double d[kTiles][2][2];
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      const int t = t0 + n * warps;
      r[n] = c[n] = 0;
      if (t < tiles) mma_tile_of(t, cD, r[n], c[n]);
      const int i = 8 * r[n] + g, j = 8 * c[n] + g;
      ab[n] = i < D ? WV + 18 * (i / 6) * mb + 3 * (i % 6) : nullptr;
      bb[n] = j < D ? Wg + 18 * (j / 6) * mb + 3 * (j % 6) : j == D ? gx : nullptr;
#pragma unroll
      for (int h = 0; h < 2; ++h) d[n][h][0] = d[n][h][1] = 0.0;
    }
    for (int k0 = 0; k0 < K; k0 += 8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + 4 * h + q, ml = k / 3, kc = k - 3 * ml;
        const bool in_k = k < K;
#pragma unroll
        for (int n = 0; n < kTiles; ++n) {
          if (t0 + n * warps >= tiles) continue;   // warp-uniform
          const double av = in_k && ab[n] ? double(ab[n][18 * ml + kc]) : 0.0;
          const double bv = !in_k || !bb[n] ? 0.0 : bb[n] == gx ? double(gx[k])
                                                                : double(bb[n][18 * ml + kc]);
          dmma_8x8x4(d[n][h][0], d[n][h][1], av, bv);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      if (t0 + n * warps >= tiles) continue;
      const int oi = 8 * r[n] + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int oj = 8 * c[n] + 2 * q + e;
        const T v = T(d[n][0][e] + d[n][1][e]);
        if (oi < D && oj <= oi) part[oi * (oi + 1) / 2 + oj] = v;
        else if (oi < D && oj == D) part[nS + oi] = v;
      }
    }
  }
}

// shared memory (elements of T) of the cooperative design: the slice's
// gauged W_blk [W MB, 18], V^-1 [MB, 9] and g_x [MB, 3], kept to the end
// for the back-substitution; then W V^-1 [W MB, 18] in phases 2-3, the
// same room after the grid's barrier holding S with its right-hand side as
// row D [D + 1, D] where S lives in shared memory, the reciprocal pivots
// and the solution [D] each and the gauge [W]
__host__ __device__ inline size_t step_smem_elems(int W, int MB, bool s_shared) {
  const size_t D = size_t(6) * W;
  const size_t keep = size_t(18) * W * MB + size_t(12) * MB;
  const size_t wv = size_t(18) * W * MB;
  const size_t solve = (s_shared ? (D + 1) * D : 0) + 2 * D + W;
  return keep + (wv > solve ? wv : solve);
}

// The Cholesky factor of S [D + 1, D] (row stride D, the lower triangle;
// row D the right-hand side) in place, in W block steps of 6 columns: one
// thread factors the diagonal block in registers, all threads solve the
// rows below it against that block (the right-hand side's row among them),
// and all threads update the trailing lower triangle, a warp a row. Each
// entry takes the updates of the pivots in pivot order (a rounded product,
// then a rounded difference), as the ticket design's; but each column is
// scaled by the reciprocal of its pivot, r_j = rsqrt(d_j), a product where
// the ticket design divides by sqrt(d_j): the chain of the 6W pivots is a
// reciprocal square root and a product each, not a square root and a
// division. The forward sweep z is row D after the last step. Then warp 0
// solves L^T x = z block by block from the last, x_j = z_j r_j, each z_i
// taking x_j L_ji in descending j. ``rp`` gets the reciprocal pivots, ``x``
// the solution; *fail 1 where a pivot is not > 0 (then x is not written).
template <typename T>
__device__ void factor_solve(T* S, int D, T* rp, T* x, int* fail) {
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int warps = blockDim.x / kWarp;
  long long since = clock64();
  for (int c0 = 0; c0 < D; c0 += 6) {
    if (tid == 0) {
      // L[l (l + 1) / 2 + m], m <= l < 6: the diagonal block
      T L[21];
#pragma unroll
      for (int l = 0; l < 6; ++l)
#pragma unroll
        for (int m = 0; m <= l; ++m) L[l * (l + 1) / 2 + m] = S[size_t(c0 + l) * D + c0 + m];
      bool ok = true;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const T d = L[a * (a + 1) / 2 + a];
        ok = ok && d > T(0);
        const T r = rsqrt(d);
        rp[c0 + a] = r;
#pragma unroll
        for (int l = a + 1; l < 6; ++l) L[l * (l + 1) / 2 + a] = L[l * (l + 1) / 2 + a] * r;
#pragma unroll
        for (int m = a + 1; m < 6; ++m)
#pragma unroll
          for (int l = m; l < 6; ++l)
            L[l * (l + 1) / 2 + m] =
                L[l * (l + 1) / 2 + m] - L[l * (l + 1) / 2 + a] * L[m * (m + 1) / 2 + a];
      }
      if (!ok) *fail = 1;
#pragma unroll
      for (int l = 1; l < 6; ++l)
#pragma unroll
        for (int m = 0; m < l; ++m) S[size_t(c0 + l) * D + c0 + m] = L[l * (l + 1) / 2 + m];
    }
    __syncthreads();
    add_cycles(12, since);
    if (*fail) return;
    // the rows below the block (the right-hand side's row D last)
    const T* L = S + size_t(c0) * D + c0;
    for (int i = c0 + 6 + tid; i <= D; i += blockDim.x) {
      T* r = S + size_t(i) * D + c0;
      T y[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        T s = r[a];
#pragma unroll
        for (int b = 0; b < a; ++b) s = s - y[b] * L[size_t(a) * D + b];
        y[a] = s * rp[c0 + a];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) r[a] = y[a];
    }
    __syncthreads();
    add_cycles(13, since);
    // the trailing lower triangle (and row D), a warp a row
    for (int i = c0 + 6 + warp; i <= D; i += warps) {
      const T* li = S + size_t(i) * D + c0;
      T l[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) l[a] = li[a];
      const int last = i < D ? i : D - 1;
      for (int m = c0 + 6 + lane; m <= last; m += kWarp) {
        const T* lm = S + size_t(m) * D + c0;
        T s = S[size_t(i) * D + m];
#pragma unroll
        for (int a = 0; a < 6; ++a) s = s - l[a] * lm[a];
        S[size_t(i) * D + m] = s;
      }
    }
    __syncthreads();
    add_cycles(14, since);
  }
  // L^T x = z: warp 0, a block at a time from the last; lane 0 the block's
  // six unknowns (its z, pivots and L entries loaded first, then the chain
  // in registers), then every lane the entries of z above the block
  if (warp == 0) {
    T* z = S + size_t(D) * D;
    for (int c0 = D - 6; c0 >= 0; c0 -= 6) {
      if (lane == 0) {
        T zb[6], rb[6], L[15];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          zb[a] = z[c0 + a];
          rb[a] = rp[c0 + a];
        }
#pragma unroll
        for (int a = 1; a < 6; ++a)
#pragma unroll
          for (int b = 0; b < a; ++b) L[a * (a - 1) / 2 + b] = S[size_t(c0 + a) * D + c0 + b];
#pragma unroll
        for (int a = 5; a >= 0; --a) {
          const T xj = zb[a] * rb[a];
          x[c0 + a] = xj;
#pragma unroll
          for (int b = 0; b < a; ++b) zb[b] = zb[b] - L[a * (a - 1) / 2 + b] * xj;
        }
      }
      __syncwarp();
      for (int i = lane; i < c0; i += kWarp) {
        T s = z[i];
        for (int a = 5; a >= 0; --a) s = s - S[size_t(c0 + a) * D + i] * x[c0 + a];
        z[i] = s;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  add_cycles(15, since);
}

// The cooperative design (launched), one launch with every CTA resident
// (ops/cuda_ba.py checks the grid against the occupancy API; the launch
// raises where it cannot be): each CTA runs phases 1-3 on its slice (phase
// 3, the slice's partial S, on the FP64 tensor cores in float64:
// slice_partials_mma) and keeps its gauged W_blk, V^-1 and g_x in shared
// memory;
// after a grid barrier each CTA sums its share of S's entries (entry e to
// CTA e mod C) over the C slices in slice order, assembles them and writes
// S [D + 1, D] to a global scratch; after a second barrier every CTA (CTA 0
// alone where S lives in global memory, then a third barrier) factors S,
// solves for dp (factor_solve), and back-substitutes its own slice's dx and
// candidate points; CTA 0 writes dp and the candidate poses. In float32
// S and its right-hand side equal the ticket design's bit for bit (every
// sum in its order); in float64 the tensor cores sum each slice's entries
// in their own order; the factor differs from the ticket design's by the
// reciprocal pivots (factor_solve): the step agrees with it within the
// roundoff of its sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ba_step_kernel(const T* __restrict__ t, const T* __restrict__ q, const T* __restrict__ X,
                   const T* __restrict__ sc, Inputs<T> in, const T* __restrict__ U,
                   const T* __restrict__ V, const T* __restrict__ Wb, const T* __restrict__ g_p,
                   const T* __restrict__ g_x, const T* __restrict__ H_o, T* __restrict__ dp,
                   T* __restrict__ dx, T* __restrict__ cand_t, T* __restrict__ cand_q,
                   T* __restrict__ cand_X, T* __restrict__ Vinv, T* __restrict__ partials,
                   T* __restrict__ S_g, unsigned* __restrict__ bar, int s_shared,
                   double landmark_damping) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_fail;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int W = in.W, M = in.M, D = 6 * W, tid = threadIdx.x, C = gridDim.x;
  const int m0 = blockIdx.x * in.MB;
  const int mb = min(in.MB, M - m0);
  const T lam = sc[B_LAM];
  T* Wg = sm;                  // [W, mb, 18] W_blk * gauge
  T* Vi = Wg + 18 * W * mb;    // [mb, 9]
  T* gx = Vi + 9 * mb;         // [mb, 3]
  T* WV = gx + 3 * mb;         // [W, mb, 18] W V^-1; then the solve's room
  stamp(kStampStep, 0);
  step_slice<T, true>(in, lam, landmark_damping, V, Wb, g_x, Vinv, Wg, WV, Vi, gx, kStampStep);
  // 3. the slice's partial sums of S's lower triangle (row-major) and of
  // the right-hand side's landmark term, over its landmarks in order: a
  // thread a 3 x 3 tile of rows 3r..3r+2 and columns 3c..3c+2, c <= r (the
  // tile's row and column each within one pose block), or the right-hand
  // side's rows 3r..3r+2; a tile's row r from a float32 square root and an
  // integer correction. Each entry sums as the ticket design's thread does.
  const int nS = D * (D + 1) / 2, R = 2 * W, nT = R * (R + 1) / 2;
  const size_t stride = size_t(nS) + D;
  T* part = partials + blockIdx.x * stride;
  long long since = clock64();
  if constexpr (std::is_same<T, double>::value)
    slice_partials_mma(WV, Wg, gx, W, mb, part);
  else
  for (int u = tid; u < nT + R; u += blockDim.x) {
    if (u < nT) {
      int r = int((sqrtf(float(8 * u + 1)) - 1.0f) * 0.5f);
      while (r * (r + 1) / 2 > u) --r;
      while ((r + 1) * (r + 2) / 2 <= u) ++r;
      const int c = u - r * (r + 1) / 2;
      const int w = r / 2, a0 = 3 * (r - 2 * w), v = c / 2, b0 = 3 * (c - 2 * v);
      T acc[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) acc[k] = T(0);
      for (int ml = 0; ml < mb; ++ml) {
        const T* xp = WV + 18 * (w * mb + ml) + 3 * a0;
        const T* yp = Wg + 18 * (v * mb + ml) + 3 * b0;
        T x[9], y[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          x[k] = xp[k];
          y[k] = yp[k];
        }
#pragma unroll
        for (int pa = 0; pa < 3; ++pa)
#pragma unroll
          for (int qb = 0; qb < 3; ++qb)
            acc[3 * pa + qb] = acc[3 * pa + qb] + ((x[3 * pa] * y[3 * qb] +
                                                    x[3 * pa + 1] * y[3 * qb + 1]) +
                                                   x[3 * pa + 2] * y[3 * qb + 2]);
      }
#pragma unroll
      for (int pa = 0; pa < 3; ++pa)
#pragma unroll
        for (int qb = 0; qb < 3; ++qb) {
          const int i = 3 * r + pa, j = 3 * c + qb;
          if (j <= i) part[i * (i + 1) / 2 + j] = acc[3 * pa + qb];
        }
    } else {
      const int r = u - nT, w = r / 2, a0 = 3 * (r - 2 * w);
      T acc[3] = {T(0), T(0), T(0)};
      for (int ml = 0; ml < mb; ++ml) {
        const T* x = WV + 18 * (w * mb + ml) + 3 * a0;
        const T* y = gx + 3 * ml;
#pragma unroll
        for (int pa = 0; pa < 3; ++pa)
          acc[pa] = acc[pa] + ((x[3 * pa] * y[0] + x[3 * pa + 1] * y[1]) + x[3 * pa + 2] * y[2]);
      }
#pragma unroll
      for (int pa = 0; pa < 3; ++pa) part[nS + 3 * r + pa] = acc[pa];
    }
  }
  add_cycles(16, since);
  stamp(kStampStep, 3);
  grid_barrier(bar);
  stamp(kStampStep, 4);

  // 4. this CTA's share of S = (-sum + blockdiag(U_damped)) + He and of the
  // right-hand side, each entry over the slices in order, into S_g
  for (int e = blockIdx.x + C * tid; e < nS + D; e += C * blockDim.x) {
    const T acc = sum_slices<T, true>(partials + e, stride, C);
    if (e < nS) {
      int i = int((sqrtf(float(8 * e + 1)) - 1.0f) * 0.5f);
      while (i * (i + 1) / 2 > e) --i;
      while ((i + 1) * (i + 2) / 2 <= e) ++i;
      const int j = e - i * (i + 1) / 2;
      const int w = i / 6, a = i - 6 * w, v = j / 6, b = j - 6 * v;
      const T gw = gauge_of(in.pose_mask, w), gv = gauge_of(in.pose_mask, v);
      T s = -acc;
      if (w == v) {
        // U * gauge, + lam diag, + (1 - gauge) on the diagonal
        T u = U[36 * w + 6 * a + b] * gw;
        if (a == b) u = (u + lam * u) + (T(1) - gw);
        s = s + u;
      }
      // He = H_o gauged on both sides, + lam diag(He); H_o's band only
      T he = abs(w - v) <= 1 ? (H_o[size_t(i) * D + j] * gw) * gv : T(0);
      if (i == j) he = he + lam * he;
      S_g[size_t(i) * D + j] = s + he;
    } else {
      const int i = e - nS;
      S_g[size_t(D) * D + i] = g_p[i] * gauge_of(in.pose_mask, i / 6) - acc;
    }
  }
  stamp(kStampStep, 5);
  grid_barrier(bar);
  stamp(kStampStep, 6);

  // 5. the factorisation and the solves: every CTA where S fits its shared
  // memory, else CTA 0 in S_g
  T* S = s_shared ? WV : S_g;
  T* rp = s_shared ? WV + size_t(D + 1) * D : WV;   // the reciprocal pivots
  T* xs = rp + D;          // the solution, then dp
  if (s_shared || blockIdx.x == 0) {
    if (s_shared) {
      // eight loads in flight a thread
      for (int e0 = tid; e0 < (D + 1) * D; e0 += 8 * blockDim.x) {
        T v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = e0 + k * blockDim.x;
          if (e < (D + 1) * D) v[k] = __ldcg(S_g + e);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = e0 + k * blockDim.x;
          if (e < (D + 1) * D) S[e] = v[k];
        }
      }
    }
    if (tid == 0) s_fail = 0;
    __syncthreads();
    stamp(kStampStep, 7);
    factor_solve(S, D, rp, xs, &s_fail);
    stamp(kStampStep, 8);
    const bool failed = s_fail != 0;
    for (int i = tid; i < D; i += blockDim.x) {
      const T v = failed ? T(NAN) : -xs[i];
      xs[i] = v * gauge_of(in.pose_mask, i / 6);
    }
    __syncthreads();
    if (blockIdx.x == 0) {
      for (int i = tid; i < D; i += blockDim.x) dp[i] = xs[i];
      // the candidate poses t + dt, q (x) exp(dw)
      for (int w = tid; w < W; w += blockDim.x) {
        const T* d = xs + 6 * w;
        cand_t[3 * w] = t[3 * w] + d[0];
        cand_t[3 * w + 1] = t[3 * w + 1] + d[1];
        cand_t[3 * w + 2] = t[3 * w + 2] + d[2];
        const Quat<T> cq = spline::qmul(
            load_q(q, w), spline::quat_exp(V3<T>{d[3], d[4], d[5]}, small_threshold<T>()));
        cand_q[4 * w] = cq.x;
        cand_q[4 * w + 1] = cq.y;
        cand_q[4 * w + 2] = cq.z;
        cand_q[4 * w + 3] = cq.w;
      }
    }
  }
  if (!s_shared) {
    grid_barrier(bar);
    for (int i = tid; i < D; i += blockDim.x) xs[i] = __ldcg(dp + i);
    __syncthreads();
  }
  stamp(kStampStep, 9);
  // 6. this slice's dx = -V^-1 (g_x + sum_w (W_blk gauge)^T dp), the
  // candidate points
  for (int ml = tid; ml < mb; ml += blockDim.x) {
    const size_t m = size_t(m0 + ml);
    T v[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) v[b] = T(0);
    for (int w = 0; w < W; ++w) {
      const T* wb = Wg + 18 * (w * mb + ml);
      for (int a = 0; a < 6; ++a) {
        const T d = xs[6 * w + a];
#pragma unroll
        for (int b = 0; b < 3; ++b) v[b] = v[b] + wb[3 * a + b] * d;
      }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) v[b] = gx[3 * ml + b] + v[b];
    const T* vi = Vi + 9 * ml;
    const T pm = in.point_mask[m];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const T d = -((vi[3 * a] * v[0] + vi[3 * a + 1] * v[1]) + vi[3 * a + 2] * v[2]);
      dx[3 * m + a] = d;
      cand_X[3 * m + a] = X[3 * m + a] + d * pm;
    }
  }
  stamp(kStampStep, 10);
}

// ------------------------------------------------------------------ K12

// the candidate's robust cost of one observation (K10's residual and Huber)
// from its camera's pose (q^-1 and t), the candidate point, the pixel and
// both masks: rho * mask and the mask
template <typename T>
__device__ __forceinline__ void observation_cost(const Pose3<T>& P, V3<T> X, const T* K, T ox,
                                                 T oy, T obs_mask, T point_mask, double huber_a,
                                                 T& rho_mask, T& mask) {
  const V3<T> Pc = camera_point(P, X);
  T r[2];
  residual(Pc, K, ox, oy, r);
  T rho, w2;
  huber(r, huber_a, rho, w2);
  mask = obs_mask * point_mask;
  rho_mask = rho * mask;
}

// a slice's rho sum and observation count in one warp: lane l's
// observations l, l + 32, ... in order, then the butterfly (K10's order);
// every lane ends with the same bits (each step adds the same two values)
template <typename T>
__device__ __forceinline__ void slice_sums(const T* rm, const T* ms, int nobs, int lane, T& s_rho,
                                           T& s_n) {
  s_rho = T(0);
  s_n = T(0);
  for (int o = lane; o < nobs; o += kWarp) {
    s_rho = s_rho + rm[o];
    s_n = s_n + ms[o];
  }
#pragma unroll
  for (int k = kWarp / 2; k > 0; k >>= 1) {
    s_rho = s_rho + __shfl_xor_sync(0xffffffffu, s_rho, k);
    s_n = s_n + __shfl_xor_sync(0xffffffffu, s_n, k);
  }
}

// the LM's constants of the decision (BAOptions)
struct CommitOptions {
  double huber_a, lambda_up, lambda_down, min_lambda, max_lambda, min_rel_decrease;
};

// the loop body's decision from the candidate's sums (rho sum, count, the
// slices whose dx is not finite, in slice order) and the prior's evaluate_cost
// sum c_e at the candidate, on the scalars' cost, lambda, iteration count and
// done flag as they stood at the launch; writes the next scalars into ``sc``
// (null: decide only); returns ok
template <typename T>
__device__ __forceinline__ bool commit_decision(T rho, T count, T bad, T c_e, bool dp_bad,
                                                T cost, T lam, T it, T done, T* sc,
                                                const CommitOptions& o) {
  const T n = clamp_min(count, T(1));
  const T cand_cost = rho / n + (T(0.5) * c_e) * (T(1) / n);
  const bool done_in = done != T(0);
  const bool ok = (cand_cost < cost) && !dp_bad && bad == T(0) && !done_in;
  const T rel = (cost - cand_cost) / clamp_min(cost, T(1e-24));
  if (sc != nullptr && !done_in) {
    sc[B_CAND_COST] = cand_cost;
    sc[B_OK] = ok ? T(1) : T(0);
    sc[B_REL] = rel;
    sc[B_LAM] = ok ? clamp_min(lam * T(o.lambda_down), T(o.min_lambda))
                   : clamp_max(lam * T(o.lambda_up), T(o.max_lambda));
    sc[B_DONE] = (ok && rel < T(o.min_rel_decrease)) ? T(1) : T(0);
    sc[B_IT] = it + T(1);
    if (ok) sc[B_COST] = cand_cost;
  }
  return ok;
}

// The cluster design (launched): one thread-block cluster of G = min(C, 16)
// CTAs (kMaxCluster, H100's non-portable size) and no ticket. Rank k takes
// the slices k, k + G, ... of ba_layout's C on its first 256 threads: each
// observation's inputs (its pose among them, read directly), dx and the
// candidate points of the slice in one trip to memory, the costs, then
// warp 0's sums in the lane and butterfly order, which lane r stores into
// rank r's shared memory (every rank gets every slice's sums). Beside them
// its last warp checks dp and computes the prior: a lane an edge's residual
// at the candidate and its terms (w r) r, then lane 0's sum of the terms in
// edge order. The cluster's barrier has two phases: the first (arrived at
// the start, awaited before the first store into another rank) makes sure
// every rank has started; the second publishes the stores. After it each
// CTA sums the C partials in slice order from its own shared memory and
// decides, each the same bits; rank 0 writes the scalars and t and q, every
// rank its own slices of X, from the copies it loaded before the barrier.
// Every CTA reads the scalars it decides on before it arrives, and no CTA
// touches another's shared memory after the second phase, so none waits at
// its end. Every output equals the ticket design's bit for bit.
constexpr int kMaxCluster = 16;
constexpr int kCommitObsThreads = 256;
constexpr int kCommitThreads = kCommitObsThreads + kWarp;   // + the prior's warp

__host__ __device__ inline int commit_cluster(int C) { return C < kMaxCluster ? C : kMaxCluster; }

// shared memory (elements of T): a slice's rho mask and mask [W MB] each, the
// prior's terms [W - 1, 6], the candidate points of the rank's slices
// [ceil(C / G), 3 MB], the candidate poses t and q [7W] (rank 0's commit)
// and every slice's sums [C, 3]
__host__ __device__ inline size_t commit_smem_elems(int W, int MB, int C) {
  const int G = commit_cluster(C);
  return size_t(2) * W * MB + size_t(6) * (W > 1 ? W - 1 : 0) +
         size_t(3) * MB * ((C + G - 1) / G) + size_t(7) * W + size_t(3) * C;
}

// named barrier 1 over the observations' 256 threads (the prior's warp not
// among them)
__device__ __forceinline__ void obs_barrier() {
  static_assert(kCommitObsThreads == 256, "bar.sync's count");
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// the cluster's barrier in its two halves: arrive (``release``: this
// thread's stores into other ranks' shared memory made visible to them;
// else relaxed) and wait
__device__ __forceinline__ void cluster_arrive(bool release) {
  if (release)
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

template <typename T>
__global__ void __launch_bounds__(kCommitThreads)
    ba_commit_kernel(T* __restrict__ t, T* __restrict__ q, T* __restrict__ X,
                     T* __restrict__ sc, Inputs<T> in, const T* __restrict__ dp,
                     const T* __restrict__ dx, const T* __restrict__ cand_t,
                     const T* __restrict__ cand_q, const T* __restrict__ cand_X,
                     CommitOptions opt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_bad[kCommitObsThreads / kWarp];
  __shared__ int s_dp_bad, s_ok;
  __shared__ T s_c_e;
  cg::cluster_group cluster = cg::this_cluster();
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int W = in.W, M = in.M, MB = in.MB, tid = threadIdx.x, lane = tid % kWarp;
  const int E = W - 1, D = 6 * W;
  const int C = (M + MB - 1) / MB, G = int(gridDim.x), rank = int(blockIdx.x);
  T* rm = sm;                          // [W MB] rho mask
  T* ms = rm + W * MB;                 // [W MB] mask
  T* terms = ms + W * MB;              // [E, 6] the prior's (w r) r
  T* xs = terms + 6 * (E > 0 ? E : 0); // [ceil(C / G), 3 MB] candidate points
  T* pq = xs + 3 * MB * ((C + G - 1) / G);   // [7W] candidate t, then q
  T* stage = pq + 7 * W;               // [C, 3] every slice's sums
  // phase 1 of the cluster's barrier: this CTA has started
  cluster_arrive(false);
  // the scalars the decision reads, before this CTA arrives at phase 2
  // (rank 0 writes them after it)
  T cost = T(0), lam = T(0), it = T(0), done = T(0);
  if (tid == 0) {
    cost = sc[B_COST];
    lam = sc[B_LAM];
    it = sc[B_IT];
    done = sc[B_DONE];
  }
  stamp(kStampCommit, 0);
  if (tid < kCommitObsThreads) {
    // 1. this rank's slices: the observations, dx's check, the slice's sums
    for (int c = rank, j = 0; c < C; c += G, ++j) {
      const int m0 = c * MB, mb = min(MB, M - m0), nobs = W * mb;
      bool bad = false;
      for (int base = 0; base < max(nobs, 3 * mb); base += kCommitObsThreads) {
        // one trip: the observation's pose, point, pixel and masks, dx and
        // the candidate point's entry
        const int o = base + tid, e = base + tid;
        T dxv = T(0), xv = T(0);
        if (e < 3 * mb) {
          dxv = dx[3 * size_t(m0) + e];
          xv = cand_X[3 * size_t(m0) + e];
        }
        if (o < nobs) {
          const int w = o / mb, m = m0 + (o - w * mb);
          const size_t wm = size_t(w) * M + m;
          const Pose3<T> P{spline::qconj(load_q(cand_q, w)), load_v(cand_t, w)};
          observation_cost(P, load_v(cand_X, m), in.K, in.obs[2 * wm], in.obs[2 * wm + 1],
                           in.obs_mask[wm], in.point_mask[m], opt.huber_a, rm[o], ms[o]);
        }
        if (e < 3 * mb) {
          bad |= !isfinite(dxv);
          xs[3 * MB * j + e] = xv;
        }
      }
      bad = __any_sync(0xffffffffu, bad);
      if (lane == 0) s_bad[tid / kWarp] = bad;
      if (j == 0) cluster_wait();   // every rank has started: it may be stored into
      obs_barrier();
      stamp_by(tid == 0, kStampCommit, 1);
      if (tid < kWarp) {
        T s_rho, s_n;
        slice_sums(rm, ms, nobs, lane, s_rho, s_n);
        bool any_bad = false;
#pragma unroll
        for (int k = 0; k < kCommitObsThreads / kWarp; ++k) any_bad |= s_bad[k] != 0;
        if (lane < G) {
          T* dst = cluster.map_shared_rank(stage, lane) + 3 * c;
          dst[0] = s_rho;
          dst[1] = s_n;
          dst[2] = any_bad ? T(1) : T(0);
        }
      }
      stamp_by(tid == 0, kStampCommit, 2);
      if (c + G < C) obs_barrier();   // the next slice reuses rm, ms and s_bad
    }
    cluster_arrive(true);
  } else {
    // 2. the last warp: dp's check, rank 0's copy of the candidate poses and
    // the prior at the candidate, their loads first
    const bool prior = in.odom_t != nullptr;
    // dp's and (rank 0) the poses' first two rounds into registers, used
    // after the edges (the rest, past W = 9, read there)
    T dpv[2], pv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + kWarp * k;
      dpv[k] = i < D ? dp[i] : T(0);
      pv[k] = rank == 0 && i < 7 * W ? (i < 3 * W ? cand_t[i] : cand_q[i - 3 * W]) : T(0);
    }
    if (prior) {
      for (int e = lane; e < E; e += kWarp) {
        T r[6];
        EdgeParts<T> p;
        edge_residual(load_v(cand_t, e), load_q(cand_q, e), load_v(cand_t, e + 1),
                      load_q(cand_q, e + 1), load_v(in.odom_t, e), load_q(in.odom_q, e), r, p);
        const T we = in.odom_w[e];
#pragma unroll
        for (int k = 0; k < 6; ++k) terms[6 * e + k] = (we * r[k]) * r[k];
      }
    }
    bool bad = false;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + kWarp * k;
      bad |= !isfinite(dpv[k]);
      if (rank == 0 && i < 7 * W) pq[i] = pv[k];
    }
    for (int i = lane + 2 * kWarp; i < D; i += kWarp) bad |= !isfinite(dp[i]);
    if (rank == 0)
      for (int i = lane + 2 * kWarp; i < 7 * W; i += kWarp)
        pq[i] = i < 3 * W ? cand_t[i] : cand_q[i - 3 * W];
    bad = __any_sync(0xffffffffu, bad);
    __syncwarp();
    stamp_by(lane == 0, kStampCommit, 3);
    // nothing of this warp's is read by another rank: it arrives before its
    // sum, which only this CTA reads (after the barrier and a CTA barrier)
    cluster_wait();
    cluster_arrive(false);
    if (lane == 0) {
      // prior_eval_sum's order: the edges in order, each edge's six terms
      T s = T(0);
      if (prior) {
        int k = 0;
        for (; k + 8 <= 6 * E; k += 8) {
          T v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = terms[k + u];
#pragma unroll
          for (int u = 0; u < 8; ++u) s = s + v[u];
        }
        for (; k < 6 * E; ++k) s = s + terms[k];
      }
      s_c_e = s;
      s_dp_bad = bad;
      stamp_by(true, kStampCommit, 4);
    }
  }
  // phase 2: every slice's sums are in every rank's stage
  cluster_wait();
  __syncthreads();   // and the prior's sum in this CTA's
  stamp(kStampCommit, 5);
  if (tid == 0) {
    T rho = T(0), count = T(0), bad = T(0);
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      rho = rho + stage[3 * c];
      count = count + stage[3 * c + 1];
      bad = bad + stage[3 * c + 2];
    }
    s_ok = commit_decision(rho, count, bad, s_c_e, s_dp_bad != 0, cost, lam, it, done,
                           rank == 0 ? sc : static_cast<T*>(nullptr), opt);
  }
  __syncthreads();
  stamp(kStampCommit, 6);
  // 3. the select: this rank's slices of X, and rank 0 the poses
  if (s_ok) {
    for (int c = rank, j = 0; c < C; c += G, ++j) {
      const int n = 3 * min(MB, M - c * MB);
      for (int e = tid; e < n; e += kCommitThreads)
        X[3 * size_t(c) * MB + e] = xs[3 * MB * j + e];
    }
    if (rank == 0)
      for (int i = tid; i < 7 * W; i += kCommitThreads) {
        if (i < 3 * W)
          t[i] = pq[i];
        else
          q[i - 3 * W] = pq[i];
      }
  }
  stamp(kStampCommit, 7);
}

// shared memory of the ticket design (elements of T): phase 1 the candidate
// poses [W, 7] and the slice's rho mask and mask [W MB] each; the last CTA's
// phase the edges' residuals [W - 1, 6] and the sums
__host__ __device__ inline size_t commit_ticket_smem_elems(int W, int MB) {
  const size_t p1 = size_t(7) * W + size_t(2) * W * MB;
  const size_t p2 = size_t(6) * (W > 1 ? W - 1 : 0) + 8;
  return p1 > p2 ? p1 : p2;
}

// The earlier ticket design: a CTA a slice writes its sums to ``partials``;
// the last CTA to take the ticket sums them in slice order, computes the
// prior's residuals at the candidate (a thread an edge) and their sum (one
// thread), decides and copies the whole candidate
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ba_commit_ticket_kernel(T* __restrict__ t, T* __restrict__ q, T* __restrict__ X,
                            T* __restrict__ sc, Inputs<T> in, const T* __restrict__ dp,
                            const T* __restrict__ dx, const T* __restrict__ cand_t,
                            const T* __restrict__ cand_q, const T* __restrict__ cand_X,
                            T* __restrict__ partials, unsigned* __restrict__ ticket,
                            CommitOptions opt) {
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
  stamp(kStampCommitTicket, 0);
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
    const size_t wm = size_t(w) * M + m;
    const Pose3<T> P{Quat<T>{qs[4 * w], qs[4 * w + 1], qs[4 * w + 2], qs[4 * w + 3]},
                     V3<T>{ts[3 * w], ts[3 * w + 1], ts[3 * w + 2]}};
    observation_cost(P, load_v(cand_X, m), in.K, in.obs[2 * wm], in.obs[2 * wm + 1],
                     in.obs_mask[wm], in.point_mask[m], opt.huber_a, rm[o], ms[o]);
  }
  stamp(kStampCommitTicket, 1);
  // whether any of the slice's dx is not finite
  bool bad = false;
  for (int e = tid; e < 3 * mb; e += blockDim.x) bad |= !isfinite(dx[3 * size_t(m0) + e]);
  const int any_bad = __syncthreads_or(bad);
  T* part = partials + 3 * blockIdx.x;
  if (tid < kWarp) {
    T s_rho, s_n;
    slice_sums(rm, ms, nobs, tid, s_rho, s_n);
    if (tid == 0) {
      part[0] = s_rho;
      part[1] = s_n;
      part[2] = any_bad ? T(1) : T(0);
    }
  }
  stamp(kStampCommitTicket, 2);
  if (!last_cta(ticket, &s_flag)) return;
  stamp(kStampCommitTicket, 3);

  // 2. the last CTA: the candidate's cost, the decision, the select
  const int C = gridDim.x, E = W - 1, D = 6 * W;
  T* re = sm;               // [E, 6] the prior's residuals at the candidate
  T* tot = re + 6 * (E > 0 ? E : 0);   // rho, n, bad, ok
  if (tid < 3) {
    T acc = T(0);
    for (int c = 0; c < C; ++c) acc = acc + __ldcg(partials + 3 * c + tid);
    tot[tid] = acc;
  }
  stamp(kStampCommitTicket, 4);
  const bool prior = in.odom_t != nullptr;
  if (prior) edge_residuals(in, cand_t, cand_q, re);
  bool dp_bad = false;
  for (int i = tid; i < D; i += blockDim.x) dp_bad |= !isfinite(dp[i]);
  const int any_dp_bad = __syncthreads_or(dp_bad);
  stamp(kStampCommitTicket, 5);
  T c_e = T(0);
  if (tid == 0 && prior) c_e = prior_eval_sum(in, re, 6);
  stamp(kStampCommitTicket, 6);
  if (tid == 0) {
    const bool ok = commit_decision(tot[0], tot[1], tot[2], c_e, any_dp_bad != 0, sc[B_COST],
                                    sc[B_LAM], sc[B_IT], sc[B_DONE], sc, opt);
    tot[3] = ok ? T(1) : T(0);
  }
  __syncthreads();
  stamp(kStampCommitTicket, 7);
  if (tot[3] != T(0)) {
    for (int e = tid; e < 3 * W; e += blockDim.x) t[e] = cand_t[e];
    for (int e = tid; e < 4 * W; e += blockDim.x) q[e] = cand_q[e];
    for (int e = tid; e < 3 * M; e += blockDim.x) X[e] = cand_X[e];
  }
  if (tid == 0) *ticket = 0u;
  stamp(kStampCommitTicket, 8);
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
                 T* g_p, T* g_x, T* H_o, T* partials, T* edges, unsigned* ticket, double huber_a,
                 cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB)) return cudaErrorInvalidValue;
  const size_t smem = build_smem_elems(in.W, in.MB) * sizeof(T);
  cudaError_t err = opt_in(ba_build_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  // one more CTA for the prior's edges where there are any
  const int extra = in.odom_t != nullptr && in.W > 1 ? 1 : 0;
  ba_build_kernel<T><<<grid_of(in.M, in.MB) + extra, kBuildThreads, smem, stream>>>(
      t, q, X, sc, in, U, V, Wb, g_p, g_x, H_o, partials, edges, ticket, huber_a);
  return cudaGetLastError();
}

template <typename T>
int launch_build_ticket(const T* t, const T* q, const T* X, T* sc, Inputs<T> in, T* U, T* V,
                        T* Wb, T* g_p, T* g_x, T* H_o, T* partials, unsigned* ticket,
                        double huber_a, cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB)) return cudaErrorInvalidValue;
  const size_t smem = build_smem_elems(in.W, in.MB) * sizeof(T);
  cudaError_t err = opt_in(ba_build_ticket_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ba_build_ticket_kernel<T><<<grid_of(in.M, in.MB), kThreads, smem, stream>>>(
      t, q, X, sc, in, U, V, Wb, g_p, g_x, H_o, partials, ticket, huber_a);
  return cudaGetLastError();
}

// the cooperative design's CTAs one SM holds at once (the occupancy API,
// with the kernel's dynamic shared memory), or minus a CUDA error
template <typename T>
int step_blocks_per_sm(int W, int MB, bool s_shared) {
  const size_t smem = step_smem_elems(W, MB, s_shared) * sizeof(T);
  cudaError_t err = opt_in(ba_step_kernel<T>, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ba_step_kernel<T>, kThreads, smem);
  return err == cudaSuccess ? n : -int(err);
}

// a cooperative launch (cudaLaunchAttributeCooperative): the runtime refuses
// a grid that cannot be resident at once, which grid_barrier needs
template <typename T>
int launch_step(const T* t, const T* q, const T* X, const T* sc, Inputs<T> in, const T* U,
                const T* V, const T* Wb, const T* g_p, const T* g_x, const T* H_o, T* dp, T* dx,
                T* cand_t, T* cand_q, T* cand_X, T* Vinv, T* partials, T* S_g, unsigned* bar,
                int s_shared, double landmark_damping, cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB) || S_g == nullptr) return cudaErrorInvalidValue;
  const size_t smem = step_smem_elems(in.W, in.MB, s_shared != 0) * sizeof(T);
  cudaError_t err = opt_in(ba_step_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_of(in.M, in.MB));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, ba_step_kernel<T>, t, q, X, sc, in, U, V, Wb, g_p, g_x, H_o, dp,
                           dx, cand_t, cand_q, cand_X, Vinv, partials, S_g, bar, s_shared,
                           landmark_damping);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left for the next launch's check
    return err;
  }
  return cudaGetLastError();
}

template <typename T>
int launch_step_ticket(const T* t, const T* q, const T* X, const T* sc, Inputs<T> in,
                       const T* U, const T* V, const T* Wb, const T* g_p, const T* g_x,
                       const T* H_o, T* dp, T* dx, T* cand_t, T* cand_q, T* cand_X, T* Vinv,
                       T* partials, T* S_global, unsigned* ticket, double landmark_damping,
                       cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB)) return cudaErrorInvalidValue;
  const size_t smem = step_ticket_smem_elems(in.W, in.MB, S_global == nullptr) * sizeof(T);
  cudaError_t err = opt_in(ba_step_ticket_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ba_step_ticket_kernel<T><<<grid_of(in.M, in.MB), kThreads, smem, stream>>>(
      t, q, X, sc, in, U, V, Wb, g_p, g_x, H_o, dp, dx, cand_t, cand_q, cand_X, Vinv, partials,
      S_global, ticket, landmark_damping);
  return cudaGetLastError();
}

// K12's cluster design launched by cudaLaunchKernelEx with a cluster of G
// = min(C, 16) CTAs over the whole grid; 16 is past the portable size of 8,
// which the kernel opts out of once a device (as normal_equations.cu's K3)
template <typename T>
cudaError_t commit_config(const Inputs<T>& in, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                          cudaLaunchAttribute* attr) {
  const int C = grid_of(in.M, in.MB);
  const size_t smem = commit_smem_elems(in.W, in.MB, C) * sizeof(T);
  static int ready_on = -1;   // the device whose attribute is set
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != ready_on) {
    err = cudaFuncSetAttribute(ba_commit_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready_on = device;
  }
  err = opt_in(ba_commit_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(commit_cluster(C));
  cfg->blockDim = dim3(kCommitThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = commit_cluster(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// the clusters of K12's cluster design the current device holds at once
// (the occupancy API; 0: it cannot be scheduled), or minus a CUDA error
template <typename T>
int commit_clusters(int W, int M, int MB) {
  if (bad_sizes(W, M, MB)) return -int(cudaErrorInvalidValue);
  const Inputs<T> in = inputs<T>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 nullptr, W, M, MB);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = commit_config(in, nullptr, &cfg, attr);
  int n = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&n, ba_commit_kernel<T>, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -int(err);
  }
  return n;
}

template <typename T>
int launch_commit(T* t, T* q, T* X, T* sc, Inputs<T> in, const T* dp, const T* dx,
                  const T* cand_t, const T* cand_q, const T* cand_X, CommitOptions opt,
                  cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB)) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = commit_config(in, stream, &cfg, attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, ba_commit_kernel<T>, t, q, X, sc, in, dp, dx, cand_t, cand_q,
                             cand_X, opt);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left for the next launch's check
    return err;
  }
  return cudaGetLastError();
}

template <typename T>
int launch_commit_ticket(T* t, T* q, T* X, T* sc, Inputs<T> in, const T* dp, const T* dx,
                         const T* cand_t, const T* cand_q, const T* cand_X, T* partials,
                         unsigned* ticket, CommitOptions opt, cudaStream_t stream) {
  if (bad_sizes(in.W, in.M, in.MB)) return cudaErrorInvalidValue;
  const size_t smem = commit_ticket_smem_elems(in.W, in.MB) * sizeof(T);
  cudaError_t err = opt_in(ba_commit_ticket_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  ba_commit_ticket_kernel<T><<<grid_of(in.M, in.MB), kThreads, smem, stream>>>(
      t, q, X, sc, in, dp, dx, cand_t, cand_q, cand_X, partials, ticket, opt);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int ba_scalars_size() { return B_SIZE; }

// shared bytes of kernel 10, 11 or 12 (``ticket``: the earlier design of K10,
// K11 or K12; K12 only that one) at W poses, MB landmarks a CTA and the dtype's size (K11 with S in
// shared memory when s_shared)
long long ba_smem_bytes(int kernel, int ticket, int W, int MB, int itemsize, int s_shared) {
  const size_t e = kernel == 10   ? build_smem_elems(W, MB)
                   : kernel == 11 ? (ticket ? step_ticket_smem_elems(W, MB, s_shared != 0)
                                            : step_smem_elems(W, MB, s_shared != 0))
                                  : commit_ticket_smem_elems(W, MB);
  return (long long)(e * size_t(itemsize));
}

// K12's cluster design: its CTAs (the cluster's size) and dynamic shared
// bytes at W poses, M landmark slots, MB a slice and the dtype's size
int ba_commit_cluster(int W, int M, int MB) { return commit_cluster(grid_of(M, MB)); }

long long ba_commit_smem_bytes(int W, int M, int MB, int itemsize) {
  return (long long)(commit_smem_elems(W, MB, grid_of(M, MB)) * size_t(itemsize));
}

// the clusters of K12's cluster design one device holds at once, or minus a
// CUDA error
int ba_commit_clusters(int W, int M, int MB, int itemsize) {
  return itemsize == 8 ? commit_clusters<double>(W, M, MB) : commit_clusters<float>(W, M, MB);
}

// K11's CTAs one SM of the current device holds at once, or minus a CUDA
// error
int ba_step_blocks_per_sm(int W, int MB, int itemsize, int s_shared) {
  return itemsize == 8 ? step_blocks_per_sm<double>(W, MB, s_shared != 0)
                       : step_blocks_per_sm<float>(W, MB, s_shared != 0);
}

// whether this build stamps its phases (BA_PHASE_CLOCKS), and the stamps'
// dimensions: kernels, CTAs, slots
int ba_phase_clocks(int which) {
#ifdef BA_PHASE_CLOCKS
  const int on = 1;
#else
  const int on = 0;
#endif
  return which == 0 ? on : which == 1 ? kStampKernels : which == 2 ? kStampCtas : kStampSlots;
}

#ifdef BA_PHASE_CLOCKS
// the stamps zeroed (reset) or copied to ``out`` [kernels, CTAs, slots]
int ba_stamps(unsigned long long* out, int reset, cudaStream_t stream) {
  void* at = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&at, g_stamps);
  if (err != cudaSuccess) return err;
  if (reset) return cudaMemsetAsync(at, 0, sizeof(g_stamps), stream);
  err = cudaMemcpyAsync(out, at, sizeof(g_stamps), cudaMemcpyDeviceToHost, stream);
  return err != cudaSuccess ? err : cudaStreamSynchronize(stream);
}
#endif

#define BA_ENTRIES(T, SUFFIX)                                                                  \
  int ba_build_##SUFFIX(const T* t, const T* q, const T* X, T* sc, const T* obs,              \
                        const T* obs_mask, const T* point_mask, const T* K, const T* odom_t,  \
                        const T* odom_q, const T* odom_w, const T* pose_mask, T* U, T* V,     \
                        T* Wb, T* g_p, T* g_x, T* H_o, T* partials, T* edges,                 \
                        unsigned* ticket, int W, int M, int MB, double huber_a,               \
                        cudaStream_t stream) {                                                \
    return launch_build<T>(t, q, X, sc,                                                        \
                           inputs<T>(obs, obs_mask, point_mask, K, odom_t, odom_q, odom_w,     \
                                     pose_mask, W, M, MB),                                     \
                           U, V, Wb, g_p, g_x, H_o, partials, edges, ticket, huber_a, stream); \
  }                                                                                            \
  int ba_build_ticket_##SUFFIX(const T* t, const T* q, const T* X, T* sc, const T* obs,       \
                               const T* obs_mask, const T* point_mask, const T* K,            \
                               const T* odom_t, const T* odom_q, const T* odom_w,             \
                               const T* pose_mask, T* U, T* V, T* Wb, T* g_p, T* g_x, T* H_o, \
                               T* partials, unsigned* ticket, int W, int M, int MB,           \
                               double huber_a, cudaStream_t stream) {                         \
    return launch_build_ticket<T>(t, q, X, sc,                                                 \
                                  inputs<T>(obs, obs_mask, point_mask, K, odom_t, odom_q,      \
                                            odom_w, pose_mask, W, M, MB),                      \
                                  U, V, Wb, g_p, g_x, H_o, partials, ticket, huber_a, stream); \
  }                                                                                            \
  int ba_step_##SUFFIX(const T* t, const T* q, const T* X, const T* sc, const T* point_mask,  \
                       const T* pose_mask, const T* U, const T* V, const T* Wb, const T* g_p,  \
                       const T* g_x, const T* H_o, T* dp, T* dx, T* cand_t, T* cand_q,         \
                       T* cand_X, T* Vinv, T* partials, T* S_g, unsigned* bar, int W, int M,   \
                       int MB, int s_shared, double landmark_damping, cudaStream_t stream) {   \
    return launch_step<T>(t, q, X, sc,                                                         \
                          inputs<T>(nullptr, nullptr, point_mask, nullptr, nullptr, nullptr,   \
                                    nullptr, pose_mask, W, M, MB),                             \
                          U, V, Wb, g_p, g_x, H_o, dp, dx, cand_t, cand_q, cand_X, Vinv,       \
                          partials, S_g, bar, s_shared, landmark_damping, stream);             \
  }                                                                                            \
  int ba_step_ticket_##SUFFIX(const T* t, const T* q, const T* X, const T* sc,                \
                              const T* point_mask, const T* pose_mask, const T* U, const T* V, \
                              const T* Wb, const T* g_p, const T* g_x, const T* H_o, T* dp,    \
                              T* dx, T* cand_t, T* cand_q, T* cand_X, T* Vinv, T* partials,    \
                              T* S_global, unsigned* ticket, int W, int M, int MB,             \
                              double landmark_damping, cudaStream_t stream) {                  \
    return launch_step_ticket<T>(t, q, X, sc,                                                  \
                                 inputs<T>(nullptr, nullptr, point_mask, nullptr, nullptr,     \
                                           nullptr, nullptr, pose_mask, W, M, MB),             \
                                 U, V, Wb, g_p, g_x, H_o, dp, dx, cand_t, cand_q, cand_X,      \
                                 Vinv, partials, S_global, ticket, landmark_damping, stream);  \
  }                                                                                            \
  int ba_commit_##SUFFIX(T* t, T* q, T* X, T* sc, const T* obs, const T* obs_mask,            \
                         const T* point_mask, const T* K, const T* odom_t, const T* odom_q,   \
                         const T* odom_w, const T* dp, const T* dx, const T* cand_t,          \
                         const T* cand_q, const T* cand_X, int W, int M, int MB,              \
                         double huber_a, double lambda_up, double lambda_down,                \
                         double min_lambda, double max_lambda, double min_rel_decrease,       \
                         cudaStream_t stream) {                                               \
    return launch_commit<T>(t, q, X, sc,                                                       \
                            inputs<T>(obs, obs_mask, point_mask, K, odom_t, odom_q, odom_w,    \
                                      nullptr, W, M, MB),                                      \
                            dp, dx, cand_t, cand_q, cand_X,                                    \
                            CommitOptions{huber_a, lambda_up, lambda_down, min_lambda,         \
                                          max_lambda, min_rel_decrease},                       \
                            stream);                                                           \
  }                                                                                            \
  int ba_commit_ticket_##SUFFIX(T* t, T* q, T* X, T* sc, const T* obs, const T* obs_mask,     \
                                const T* point_mask, const T* K, const T* odom_t,             \
                                const T* odom_q, const T* odom_w, const T* dp, const T* dx,   \
                                const T* cand_t, const T* cand_q, const T* cand_X,            \
                                T* partials, unsigned* ticket, int W, int M, int MB,          \
                                double huber_a, double lambda_up, double lambda_down,         \
                                double min_lambda, double max_lambda,                         \
                                double min_rel_decrease, cudaStream_t stream) {               \
    return launch_commit_ticket<T>(t, q, X, sc,                                                \
                                   inputs<T>(obs, obs_mask, point_mask, K, odom_t, odom_q,     \
                                             odom_w, nullptr, W, M, MB),                       \
                                   dp, dx, cand_t, cand_q, cand_X, partials, ticket,           \
                                   CommitOptions{huber_a, lambda_up, lambda_down, min_lambda,  \
                                                 max_lambda, min_rel_decrease},                \
                                   stream);                                                    \
  }

BA_ENTRIES(float, f32)
BA_ENTRIES(double, f64)

}  // extern "C"
