// K6-K8: the body of the LM iteration on the card, as three launches of one
// CTA each around the residual evaluation.
//
// Replaces the stage XLA fuses in mba_vo_tpu/solver/lm.py (optimize_level's
// `body`, :373-465, with its two lax.conds; no Pallas source). Bound in
// ops/cuda_lm.py; the plain versions are solver/lm.py's lm_step_plain,
// lm_decide_plain and lm_commit_plain.
//
//   * K6 lm_step (:375-378, :390): H1 = H + diag(diag(H)) / radius, H1 x = g
//     by Cholesky, step = -x, the model cost change, the invalid flag, and
//     the candidate knots: t + dt and q * exp(omega) (core/spline.py's
//     spline_retract_flat, core/lie.py's quat_exp), or the knots themselves
//     when the step is invalid, so that the evaluation that follows never
//     sees a NaN position;
//   * K7 lm_decide (:408-415, _step_quality :159-166, detect_outliers
//     :214-241, assemble's scaling mba_vo_tpu/ops/residual.py:601-608): the
//     candidate's cost from K3's raw sum, the step quality, success, the cost
//     decrease and the outlier mask re-detected from the candidate's patch
//     costs;
//   * K8 lm_commit (:380-386, :424-446, :448-461, _step_accepted
//     :168-196): the accepted, rejected or invalid state chosen by selects,
//     written in place, and the loop's continue flag.
//
// What bounds them: latency. D = 6K is 12 at the frame and 42 at a degree-4
// joint chunk of 4 frames, N <= 512 keypoints: each kernel moves a few
// kilobytes and does a few thousand operations, far below a microsecond of
// the card's memory or arithmetic rate; the time is the launch and, in K6,
// the chain of D pivots and of the triangular sweeps' rows, each a stage
// that waits for the one before. One CTA each, so every decision is made
// where its inputs are, without a second launch or an atomic, and the host
// reads one flag an iteration (K8's continue flag).
//
// Two designs of each. The LM launches the shuffle design of K6, the
// keypoint design of K7 and the staged design of K8 (below, after PR
// 12's). K6's time is the chain
// of its stages (D pivots, then three sweeps of D rows), and on this card a
// stage costs what its dependent round trips cost (shared-memory loads and
// stores, a division, a square root, a barrier and the wait for the
// slowest warp), not its arithmetic. The shuffle design keeps round trips
// through one thread off the chain: every thread takes a pivot's square
// root itself, the factorisation runs on all eight warps (two barriers a
// pivot), and up to D = 64 the three sweeps run in one warp whose lanes
// pass each row's entry by shuffles while each row's factor entries stay
// with its lane; the parallel work (the load of H, the refinement's
// residual, H1 times the step) runs on all 256 threads, the load's reads
// issued together, H1 read back from a copy in shared memory.
// K7's keypoint design: a thread a keypoint, each cost computed once,
// three one-barrier sums. K8's staged design: every load in one first
// batch, each warp's own residual count, no barrier, the scalar tail while
// the stores drain (its note below). The earlier block designs
// (lm_step_block_*, lm_decide_block_*, lm_commit_block_*) stay callable for
// the harness's comparisons and timings.
//
// Orders of the sums (not cuSOLVER's or torch.sum's, which cannot be
// followed bit for bit): the factorisation is the right-looking Cholesky,
// each entry of the factor updated once per pivot in pivot order, each
// product rounded before its difference (this source builds with
// -fmad=false); the solves go row by row (forward) and back, then once
// more on the residual g - H1 x summed in double the working precision (one
// step of refinement: the step is then close to the exact solution's
// rounding, so it stays near LAPACK's and cuSOLVER's whatever the order);
// the model change's two sums are each thread's strided elements in order,
// then a tree over 256 slots. Any schedule that keeps each entry's order
// keeps the bits: both K6 designs give the same, and that order is written
// out in torch in experiments/residual_kernels.py (lm_step_kernel_order),
// to which the card's checks hold K6's step and model change bit for bit.
// The retraction follows the card's torch in its order of operations, so
// the candidate knots equal spline_retract_flat of K6's own step on the
// card bit for bit, and K5 anchors the candidate's patches exactly as it
// anchors the plain retraction's. K7's and K8's residual counts and K7's
// live count sum 0/1 values, exact in any order; K7's mu and sigma follow
// no fixed order.
//
// The factor lives in shared memory while it fits (ops/cuda_lm.py's
// step_layout and, for the block design, step_smem_bytes), else in a
// global scratch matrix in the same kernel: no D leaves the kernel.

#include <cuda_runtime.h>
#include <math.h>

#include "spline_pose.cuh"

namespace {

using spline::Quat;
using spline::V3;

// solver/lm.py's scalars vector (ops/cuda_lm.py's S_*)
enum : int {
  S_COST = 0,
  S_MIN,
  S_CUR,
  S_REF,
  S_CAND,
  S_ACC_REF,
  S_ACC_CAND,
  S_NONMONO,
  S_RADIUS,
  S_DECREASE,
  S_ACD,
  S_MCC,
  S_INVALID,
  S_CAND_COST,
  S_QUALITY,
  S_SUCCESS,
  S_ACD_NEW,
  S_MU,
  S_SIGMA,
  S_CONTINUE,
  S_SIZE
};

constexpr int kThreads = 256;   // ops/cuda_lm.py's LM_THREADS: K6's and K8's, K7's block design's

// the sum of one value a thread over the block: a tree in shared memory,
// the same order every call
template <typename T>
__device__ T block_sum(T v, T* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + s];
    __syncthreads();
  }
  const T out = red[0];
  __syncthreads();
  return out;
}

// assemble's scale: 1 / max(sum(w) F P, 1) (ops/residual.py's
// inverse_residual_count; NaN stays NaN as torch.clamp leaves it)
template <typename T>
__device__ T inverse_count(const T* w, int N, int F, int P, T* red) {
  T part = T(0);
  for (int n = threadIdx.x; n < N; n += kThreads) part = part + w[n];
  T n_res = (block_sum(part, red) * T(F)) * T(P);
  n_res = n_res < T(1) ? T(1) : n_res;
  return T(1) / n_res;
}

// torch.clamp(r, lo, hi), NaN through
template <typename T>
__device__ __forceinline__ T clamp(T r, T lo, T hi) {
  return r < lo ? lo : (r > hi ? hi : r);
}

// L L^T x = b in place, with L in A's lower triangle: row by row forward,
// then back (every thread of the block calls it)
template <typename T>
__device__ void solve_factored(const T* A, T* b, int D) {
  const int tid = threadIdx.x;
  for (int j = 0; j < D; ++j) {   // L y = b
    if (tid == 0) b[j] = b[j] / A[j * D + j];
    __syncthreads();
    const T y = b[j];
    for (int i = j + 1 + tid; i < D; i += kThreads) b[i] = b[i] - A[i * D + j] * y;
    __syncthreads();
  }
  for (int j = D - 1; j >= 0; --j) {   // L^T x = y
    if (tid == 0) b[j] = b[j] / A[j * D + j];
    __syncthreads();
    const T x = b[j];
    for (int i = tid; i < j; i += kThreads) b[i] = b[i] - A[j * D + i] * x;
    __syncthreads();
  }
}

// Veltkamp's split and Dekker's product without a fused multiply-add (this
// source builds with -fmad=false): a b rounded, and its rounding error
template <typename T>
__device__ __forceinline__ T two_product(T a, T b, T& err) {
  const T split = sizeof(T) >= 8 ? T(134217729.0) : T(4097.0);
  const T p = a * b;
  const T ca = split * a, cb = split * b;
  const T ah = ca - (ca - a), bh = cb - (cb - b);
  const T al = a - ah, bl = b - bh;
  err = (((ah * bh - p) + ah * bl) + al * bh) + al * bl;
  return p;
}

// the candidate knots: the steps [all t; all omega] retracted (t + dt, q
// exp(omega), spline_retract_flat's order), or the knots themselves where
// the step is invalid; a knot a thread
template <typename T>
__device__ void retract(const T* __restrict__ knot_t, const T* __restrict__ knot_q,
                        const T* step, bool invalid, T* __restrict__ cand_t,
                        T* __restrict__ cand_q, int K, int tid, int nt) {
  const T thr = sizeof(T) >= 8 ? T(1e-20) : T(1e-10);
  for (int k = tid; k < K; k += nt) {
    const Quat<T> qk{knot_q[4 * k], knot_q[4 * k + 1], knot_q[4 * k + 2], knot_q[4 * k + 3]};
    if (invalid) {
      for (int c = 0; c < 3; ++c) cand_t[3 * k + c] = knot_t[3 * k + c];
      cand_q[4 * k] = qk.x, cand_q[4 * k + 1] = qk.y, cand_q[4 * k + 2] = qk.z,
      cand_q[4 * k + 3] = qk.w;
      continue;
    }
    for (int c = 0; c < 3; ++c) cand_t[3 * k + c] = knot_t[3 * k + c] + step[3 * k + c];
    const T* w = step + 3 * K + 3 * k;
    const Quat<T> r = spline::qmul(qk, spline::quat_exp(V3<T>{w[0], w[1], w[2]}, thr));
    cand_q[4 * k] = r.x, cand_q[4 * k + 1] = r.y, cand_q[4 * k + 2] = r.z,
    cand_q[4 * k + 3] = r.w;
  }
}

// K6, PR 12's block design (lm_step_block_*): 256 threads; thread 0 takes
// each pivot's square root and each row's division, the others wait at a
// block barrier (three a pivot, two a row of each of the four sweeps)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_step_block_kernel(const T* __restrict__ H, const T* __restrict__ g, T* sc,
                   const T* __restrict__ knot_t, const T* __restrict__ knot_q, T* H1,
                   T* __restrict__ step, T* __restrict__ cand_t, T* __restrict__ cand_q,
                   T* scratch, int D, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* b = reinterpret_cast<T*>(smem_raw);   // [D] the right-hand side, then x
  T* rr = b + D;                           // [D] the refinement's residual
  T* red = rr + D;                         // [kThreads]
  T* A = scratch != nullptr ? scratch : red + kThreads;   // [D, D] the factor
  __shared__ int failed;
  const int tid = threadIdx.x;

  // damp: H + diag(diag(H)) / radius (the off-diagonal adds a zero)
  const T radius = sc[S_RADIUS];
  for (int e = tid; e < D * D; e += kThreads) {
    const int i = e / D, j = e - i * D;
    const T h = H[e];
    const T v = h + (i == j ? h / radius : T(0));
    H1[e] = v;
    A[e] = v;
  }
  for (int i = tid; i < D; i += kThreads) b[i] = g[i];
  if (tid == 0) failed = 0;
  __syncthreads();

  // right-looking Cholesky in the lower triangle of A; a pivot that is not
  // positive (or NaN) fails the factorisation: a NaN step, as
  // jnp.linalg.cholesky gives and cholesky_ex's info flags
  for (int k = 0; k < D; ++k) {
    if (tid == 0) {
      const T p = A[k * D + k];
      if (!(p > T(0))) failed = 1;
      A[k * D + k] = sqrt(p);
    }
    __syncthreads();
    if (failed) break;
    const T d = A[k * D + k];
    for (int i = k + 1 + tid; i < D; i += kThreads) A[i * D + k] = A[i * D + k] / d;
    __syncthreads();
    const int m = D - k - 1;
    for (int e = tid; e < m * m; e += kThreads) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      if (j <= i) A[i * D + j] = A[i * D + j] - A[i * D + k] * A[j * D + k];
    }
    __syncthreads();
  }
  if (!failed) {
    solve_factored(A, b, D);
    // one step of refinement: r = g - H1 x in double the working precision
    // (Dekker's exact products, the sums' errors kept; a row a thread in
    // column order), solved with the same factor, x += d
    for (int i = tid; i < D; i += kThreads) {
      T s = g[i], c = T(0);
      for (int j = 0; j < D; ++j) {
        T pe;
        const T p = two_product(H1[i * D + j], b[j], pe);
        const T t = s - p;
        const T bb = t - s;
        c = c + (((s - (t - bb)) + (-p - bb)) - pe);
        s = t;
      }
      rr[i] = s + c;
    }
    __syncthreads();
    solve_factored(A, rr, D);
    for (int i = tid; i < D; i += kThreads) b[i] = b[i] + rr[i];
    __syncthreads();
  }
  const bool nan_step = failed != 0;
  __syncthreads();
  bool nonfinite = false;
  for (int i = tid; i < D; i += kThreads) {
    const T s = nan_step ? T(NAN) : -b[i];
    b[i] = s;
    step[i] = s;
    nonfinite |= !isfinite(s);
  }
  nonfinite = __syncthreads_or(nonfinite);

  // model cost change: -(g . step + 0.5 step . (H1 step)), H1 step a row a
  // thread in column order
  T gs = T(0), shs = T(0);
  for (int i = tid; i < D; i += kThreads) {
    T acc = T(0);
    for (int j = 0; j < D; ++j) acc = acc + H1[i * D + j] * b[j];
    gs = gs + g[i] * b[i];
    shs = shs + b[i] * acc;
  }
  gs = block_sum(gs, red);
  shs = block_sum(shs, red);
  const T mcc = -(gs + T(0.5) * shs);
  const bool invalid = mcc < T(0) || nonfinite;

  retract(knot_t, knot_q, b, invalid, cand_t, cand_q, K, tid, kThreads);
  if (tid == 0) {
    sc[S_MCC] = mcc;
    sc[S_INVALID] = invalid ? T(1) : T(0);
  }
}

// K7, PR 12's block design (lm_decide_block_*): 256 threads, four block
// sums of nine barriers each, each keypoint's cost computed in each of
// three passes
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_decide_block_kernel(const T* __restrict__ cost, const T* __restrict__ patch,
                     const T* __restrict__ kp_w, const T* __restrict__ kp_mask, T* sc,
                     const T* __restrict__ prior_cost, T* __restrict__ mask_out,
                     T* __restrict__ w_out, int F, int N, int P, double chi_k,
                     double min_step_quality) {
  __shared__ T red[kThreads];
  const int tid = threadIdx.x;
  const T c0 = sc[S_COST], cur = sc[S_CUR], ref = sc[S_REF], acc_ref = sc[S_ACC_REF],
          mcc = sc[S_MCC];
  const T inv_n = inverse_count(kp_w, N, F, P, red);

  T cand = cost[0] * inv_n;
  if (prior_cost != nullptr) cand = cand + prior_cost[0];
  // _step_quality; torch.maximum passes a NaN through
  const T rel = (cur - cand) / mcc;
  const T hist = (ref - cand) / (acc_ref + mcc);
  const T quality = rel != rel ? rel : (hist != hist ? hist : (rel > hist ? rel : hist));
  const bool success = quality > T(min_step_quality) && cand < c0;
  const T acd = c0 - cand;

  // detect_outliers on the candidate's scaled patch costs: a keypoint's
  // cost is its frames' in frame order; mu and sigma over the live ones
  T live_n = T(0), live_c = T(0);
  for (int n = tid; n < N; n += kThreads) {
    T c = T(0);
    for (int f = 0; f < F; ++f) c = c + patch[f * N + n] * inv_n;
    const T live = (c >= T(1e-8) && kp_mask[n] > T(0)) ? T(1) : T(0);
    live_n = live_n + live;
    live_c = live_c + c * live;
  }
  T n_live = block_sum(live_n, red);
  n_live = n_live < T(1) ? T(1) : n_live;
  const T mu = block_sum(live_c, red) / n_live;
  T dev = T(0);
  for (int n = tid; n < N; n += kThreads) {
    T c = T(0);
    for (int f = 0; f < F; ++f) c = c + patch[f * N + n] * inv_n;
    const T live = (c >= T(1e-8) && kp_mask[n] > T(0)) ? T(1) : T(0);
    const T d = c - mu;
    dev = dev + live * (d * d);
  }
  const T sigma = sqrt(block_sum(dev, red) / n_live);
  const T thresh = T(chi_k) * sigma;
  for (int n = tid; n < N; n += kThreads) {
    T c = T(0);
    for (int f = 0; f < F; ++f) c = c + patch[f * N + n] * inv_n;
    const bool outlier = fabs(c - mu) > thresh && kp_mask[n] > T(0);
    const T m = outlier ? T(0) : T(1);
    mask_out[n] = m;
    w_out[n] = kp_mask[n] * m;
  }
  if (tid == 0) {
    sc[S_CAND_COST] = cand;
    sc[S_QUALITY] = quality;
    sc[S_SUCCESS] = success ? T(1) : T(0);
    sc[S_ACD_NEW] = acd;
    sc[S_MU] = mu;
    sc[S_SIGMA] = sigma;
  }
}

// ------------------------------------------------------------------------
// K6's shuffle design and K7's keypoint design, which the LM launches (the
// block designs above, PR 12's, stay callable as sweep rows).

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// the width of the tree both K6 designs sum the model change over
// (ops/cuda_lm.py's LM_TREE): the block design's threads
constexpr int kTree = kThreads;
// K6's shuffle design runs its sweeps in one warp up to this many unknowns,
// two rows a lane (ops/cuda_lm.py's WARP_STEP_MAX_D)
constexpr int kWarpStepMaxD = 2 * 32;
// K7's keypoint design: a keypoint a thread up to this many
// (ops/cuda_lm.py's DECIDE_MAX_THREADS), and the costs a thread keeps in
// registers (past kDecideKeep x 512 keypoints the rest are computed again,
// in the same order)
constexpr int kDecideThreads = 512;
constexpr int kDecideKeep = 4;

// the factor's row stride (ops/cuda_lm.py's step_ld): odd, so that the
// lanes of a warp, on consecutive rows of one column, hit distinct banks
__host__ __device__ __forceinline__ int factor_ld(int D) { return D | 1; }

// K6's shuffle design's dynamic shared memory (ops/cuda_lm.py's
// step_layout): the factor [D, LD] where it lives there, the copy of H1
// [D, LD] where it fits too, then b, y, x and the pivots [D]
template <typename T>
size_t step_bytes(int D, bool shared_factor, bool shared_h1) {
  const size_t m = size_t(D) * size_t(factor_ld(D));
  return ((shared_factor ? m : 0) + (shared_h1 ? m : 0) + 4 * size_t(D)) * sizeof(T);
}

// block_sum's order in one warp: the kTree slots' strided sums from 0
// (slots lane + 32 m kept by the lane), the tree's levels 128, 64 and 32
// inside the lane, then 16 ... 1 by shuffles; lane 0's is the sum. The same
// operands meet in the same order as in block_sum, so the bits are its
// (a -0 entry becomes +0 at its slot's first sum there and here). Eight
// named slots, not an array, so that nothing goes to local memory.
template <typename T>
__device__ T tree_sum(const T* v, int D, int lane) {
  auto slot = [&](int m) {
    T p = T(0);
    for (int i = lane + kWarp * m; i < D; i += kTree) p = p + v[i];
    return p;
  };
  static_assert(kTree == 8 * kWarp, "eight slots a lane");
  T q0 = slot(0), q1 = slot(1), q2 = slot(2), q3 = slot(3);
  const T q4 = slot(4), q5 = slot(5), q6 = slot(6), q7 = slot(7);
  q0 = q0 + q4, q1 = q1 + q5, q2 = q2 + q6, q3 = q3 + q7;   // level 128
  q0 = q0 + q2, q1 = q1 + q3;                               // level 64
  q0 = q0 + q1;                                             // level 32
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) q0 = q0 + __shfl_down_sync(kFull, q0, s);
  return q0;
}

// The sweeps for D <= 64, in warp 0, lane l holding the entries of rows l
// and l + 32 (v0, v1, and the pivots' square roots d0, d1) in registers:
// each row's entry passes to every lane by a shuffle, every lane divides it
// by the pivot itself, and the factor entries a lane needs next are loaded
// a row ahead. L y = v forward (each lane's own factor row, column j), and
// L^T x = v back (row j's factor entry in the lane's column, stored by
// row j's lane before the warp's barrier); the back sweep writes x, or adds
// to it (the refinement's x + d).
template <typename T>
__device__ void forward_sweep(const T* A, int LD, int D, int lane, T d0, T d1, T v0, T v1,
                              T& y0, T& y1) {
  const int r0 = lane, r1 = lane + kWarp;
  const T* row0 = A + r0 * LD;
  const T* row1 = A + r1 * LD;
  T a0 = r0 > 0 && r0 < D ? row0[0] : T(0), a1 = r1 < D ? row1[0] : T(0);
  for (int j = 0; j < D; ++j) {
    const int src = j & (kWarp - 1);
    const T dj = __shfl_sync(kFull, j < kWarp ? d0 : d1, src);
    const T c0 = a0, c1 = a1;
    if (j + 1 < D) {   // the next column's entries of the own rows
      a0 = r0 > j + 1 && r0 < D ? row0[j + 1] : T(0);
      a1 = r1 > j + 1 && r1 < D ? row1[j + 1] : T(0);
    }
    const T yj = __shfl_sync(kFull, j < kWarp ? v0 : v1, src) / dj;
    if (r0 == j) y0 = yj;
    if (r1 == j) y1 = yj;
    if (r0 > j) v0 = v0 - c0 * yj;
    if (r1 > j) v1 = v1 - c1 * yj;
  }
}

template <typename T>
__device__ void back_sweep(const T* A, int LD, int D, int lane, T d0, T d1, T v0, T v1, T& x0,
                           T& x1, bool add) {
  const int r0 = lane, r1 = lane + kWarp;
  int j = D - 1;
  T a0 = r0 < j ? A[j * LD + r0] : T(0), a1 = r1 < j ? A[j * LD + r1] : T(0);
  for (; j >= 0; --j) {
    const int src = j & (kWarp - 1);
    const T dj = __shfl_sync(kFull, j < kWarp ? d0 : d1, src);
    const T c0 = a0, c1 = a1;
    if (j > 0) {   // row j - 1's entries in the own columns
      a0 = r0 < j - 1 ? A[(j - 1) * LD + r0] : T(0);
      a1 = r1 < j - 1 ? A[(j - 1) * LD + r1] : T(0);
    }
    const T xj = __shfl_sync(kFull, j < kWarp ? v0 : v1, src) / dj;
    if (r0 == j) x0 = add ? x0 + xj : xj;
    if (r1 == j) x1 = add ? x1 + xj : xj;
    if (r0 < j) v0 = v0 - c0 * xj;
    if (r1 < j) v1 = v1 - c1 * xj;
  }
}

// K6's chains of stages on the factor A (shared or global memory: the
// caller passes a pointer the compiler can see is shared where it is):
// the factorisation on the eight warps, entry (i, j) updated by lane
// i mod 32 of warp j mod 8, every thread taking the pivot's square root
// itself, two block barriers a pivot, the forward sweep L y = g folded in
// (y_k = b_k / L_kk, then b_i - L_ik y_k); then L^T x = y. D <= 64: the
// sweep in warp 0 by shuffles; above, on the eight warps, a barrier a row.
// Returns whether a pivot failed (not positive, or NaN: a NaN step, as
// jnp.linalg.cholesky gives and cholesky_ex's info flags).
template <typename T>
__device__ bool factor_and_back(T* A, int LD, int D, T* b, T* y, T* x, T* dg) {
  constexpr int nw = kThreads / kWarp;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  for (int k = 0; k < D; ++k) {
    const T p = A[k * LD + k];
    if (!(p > T(0))) return true;   // every thread read the same pivot: all leave here
    const T d = sqrt(p);
    const T yk = b[k] / d;
    if (tid == 0) {
      dg[k] = d;
      y[k] = yk;
    }
    const int first = k + 1 + ((lane - k - 1) & (kWarp - 1));   // this lane's first row below k
    if (warp == (k & (nw - 1))) {
      for (int i = first; i < D; i += kWarp) {
        const T l = A[i * LD + k] / d;
        A[i * LD + k] = l;
        b[i] = b[i] - l * yk;
      }
    }
    __syncthreads();
    const int col = k + 1 + ((warp - k - 1) & (nw - 1));   // this warp's first column
    for (int i = first; i < D; i += kWarp) {
      const T l = A[i * LD + k];
      for (int j = col; j <= i; j += nw) A[i * LD + j] = A[i * LD + j] - l * A[j * LD + k];
    }
    __syncthreads();
  }
  if (D <= kWarpStepMaxD) {
    if (warp == 0) {
      const int r0 = lane, r1 = lane + kWarp;
      T x0 = T(0), x1 = T(0);
      back_sweep(A, LD, D, lane, r0 < D ? dg[r0] : T(0), r1 < D ? dg[r1] : T(0),
                 r0 < D ? y[r0] : T(0), r1 < D ? y[r1] : T(0), x0, x1, false);
      if (r0 < D) x[r0] = x0;
      if (r1 < D) x[r1] = x1;
    }
  } else {
    // y_j's last update came a row earlier, before its barrier
    for (int j = D - 1; j >= 0; --j) {
      const T xj = y[j] / dg[j];
      if (tid == 0) x[j] = xj;
      for (int i = tid; i < j; i += kThreads) y[i] = y[i] - A[j * LD + i] * xj;
      __syncthreads();
    }
  }
  return false;
}

// the refinement's sweeps on the residual in b: L w = r, L^T d = w, x += d
template <typename T>
__device__ void refine_sweeps(const T* A, int LD, int D, T* b, T* y, T* x, const T* dg) {
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  if (D <= kWarpStepMaxD) {
    if (warp == 0) {
      const int r0 = lane, r1 = lane + kWarp;
      const T d0 = r0 < D ? dg[r0] : T(0), d1 = r1 < D ? dg[r1] : T(0);
      T w0 = T(0), w1 = T(0);
      T x0 = r0 < D ? x[r0] : T(0), x1 = r1 < D ? x[r1] : T(0);
      forward_sweep(A, LD, D, lane, d0, d1, r0 < D ? b[r0] : T(0), r1 < D ? b[r1] : T(0), w0,
                    w1);
      back_sweep(A, LD, D, lane, d0, d1, w0, w1, x0, x1, true);
      if (r0 < D) x[r0] = x0;
      if (r1 < D) x[r1] = x1;
    }
    return;
  }
  for (int j = 0; j < D; ++j) {
    const T yj = b[j] / dg[j];
    if (tid == 0) y[j] = yj;
    for (int i = tid; i < D; i += kThreads) {
      if (i > j) b[i] = b[i] - A[i * LD + j] * yj;
    }
    __syncthreads();
  }
  for (int j = D - 1; j >= 0; --j) {
    const T dj = y[j] / dg[j];
    if (tid == 0) x[j] = x[j] + dj;
    for (int i = tid; i < j; i += kThreads) y[i] = y[i] - A[j * LD + i] * dj;
    __syncthreads();
  }
}

// K6, the shuffle design. 256 threads. The work that is parallel over rows
// or entries runs on every thread: the damped load (four rows' reads
// issued before their first store), the refinement's residual and H1 times
// the step (a row a thread, H1 read from its copy in shared memory where it
// fits). The chains of stages (factor_and_back, refine_sweeps) take no
// round trip through one thread: every thread takes a pivot's square root
// itself, and up to D = 64 the sweeps pass each row's entry by shuffles in
// one warp. Every entry of the factor and of the right-hand side takes its
// products in pivot order, each rounded before its difference, so this
// design and PR 12's block design give the same bits.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_step_shfl_kernel(const T* __restrict__ H, const T* __restrict__ g, T* sc,
                        const T* __restrict__ knot_t, const T* __restrict__ knot_q, T* H1,
                        T* __restrict__ step, T* __restrict__ cand_t, T* __restrict__ cand_q,
                        T* scratch, int D, int K, int shared_h1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LD = factor_ld(D);
  T* base = reinterpret_cast<T*>(smem_raw);
  T* const As = base;                                     // [D, LD] the factor, when shared
  T* const A = scratch != nullptr ? scratch : As;
  if (scratch == nullptr) base += D * LD;
  T* const Hs = shared_h1 ? base : nullptr;               // [D, LD] H1's copy
  if (shared_h1) base += D * LD;
  const T* const Hr = shared_h1 ? Hs : H1;                // H1 as the residual reads it
  const int hld = shared_h1 ? LD : D;
  T* const b = base;                                      // [D] g, then the residual
  T* const y = b + D;                                     // [D] the forward sweeps' results
  T* const x = y + D;                                     // [D] the solution, then the step
  T* const dg = x + D;                                    // [D] the pivots' square roots
  __shared__ int s_invalid;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & (kWarp - 1), warp = tid / kWarp, nw = nt / kWarp;
  // the retraction's knots, on their way to L1 while the chains run
  for (int k = tid; k < K; k += nt) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(knot_t + 3 * k));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(knot_q + 4 * k));
  }

  // damp: H + diag(diag(H)) / radius (the off-diagonal adds a zero); rows
  // over the warps, four rows' loads issued before their first store, lanes
  // along the row
  const T radius = sc[S_RADIUS];
  for (int j0 = 0; j0 < D; j0 += 2 * kWarp) {
    for (int i0 = warp; i0 < D; i0 += 4 * nw) {
      T v[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = i0 + r * nw, j = j0 + lane + c * kWarp;
          v[r][c] = (i < D && j < D) ? H[i * D + j] : T(0);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = i0 + r * nw, j = j0 + lane + c * kWarp;
          if (i < D && j < D) {
            const T h = v[r][c];
            const T val = h + (i == j ? h / radius : T(0));
            H1[i * D + j] = val;
            A[i * LD + j] = val;
            if (shared_h1) Hs[i * LD + j] = val;
          }
        }
      }
    }
  }
  const T g_own = tid < D ? g[tid] : T(0);   // the rows a thread owns below, when D <= 256
  for (int i = tid; i < D; i += nt) b[i] = g[i];
  __syncthreads();

  const bool failed = scratch == nullptr ? factor_and_back(As, LD, D, b, y, x, dg)
                                         : factor_and_back(scratch, LD, D, b, y, x, dg);
  __syncthreads();
  if (!failed) {
    // one step of refinement: r = g - H1 x in double the working precision
    // (Dekker's exact products, the sums' errors kept; a row a thread in
    // column order), solved with the same factor, x += d
    for (int i = tid; i < D; i += nt) {
      T s = i == tid ? g_own : g[i], c = T(0);
      const T* hrow = Hr + i * hld;
      for (int j = 0; j < D; ++j) {
        T pe;
        const T p = two_product(hrow[j], x[j], pe);
        const T t = s - p;
        const T bb = t - s;
        c = c + (((s - (t - bb)) + (-p - bb)) - pe);
        s = t;
      }
      b[i] = s + c;
    }
    __syncthreads();
    if (scratch == nullptr) {
      refine_sweeps(As, LD, D, b, y, x, dg);
    } else {
      refine_sweeps(scratch, LD, D, b, y, x, dg);
    }
    __syncthreads();
  }

  // the step (NaN where the factorisation failed), then the model cost
  // change: -(g . step + 0.5 step . (H1 step)), H1 step a row a thread in
  // column order, both dot products by warp 0 in block_sum's order
  for (int i = tid; i < D; i += nt) {
    const T s = failed ? T(NAN) : -x[i];
    x[i] = s;
    step[i] = s;
  }
  __syncthreads();
  for (int i = tid; i < D; i += nt) {
    const T* hrow = Hr + i * hld;
    T acc = T(0);
    for (int j = 0; j < D; ++j) acc = acc + hrow[j] * x[j];
    b[i] = (i == tid ? g_own : g[i]) * x[i];
    y[i] = x[i] * acc;
  }
  __syncthreads();
  if (warp == 0) {
    const T gs = tree_sum(b, D, lane);
    const T shs = tree_sum(y, D, lane);
    bool nonfinite = false;
    for (int i = lane; i < D; i += kWarp) nonfinite |= !isfinite(x[i]);
    nonfinite = __any_sync(kFull, nonfinite);
    if (lane == 0) {
      const T mcc = -(gs + T(0.5) * shs);
      const bool invalid = mcc < T(0) || nonfinite;
      s_invalid = invalid ? 1 : 0;
      sc[S_MCC] = mcc;
      sc[S_INVALID] = invalid ? T(1) : T(0);
    }
  }
  __syncthreads();
  retract(knot_t, knot_q, x, s_invalid != 0, cand_t, cand_q, K, tid, nt);
}

// the sum of one value a thread, every lane of the warp getting it (the
// butterfly's two operands commute, so each lane's bits are the same)
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s >>= 1) v = v + __shfl_xor_sync(kFull, v, s);
  return v;
}

// the sum over the block of one value a thread (two with block_allsum2),
// read by every thread: each warp's by shuffles, then the warps' partials
// in warp order; one barrier, each call with slots of its own, so no later
// sum overwrites them while they are read
template <typename T>
__device__ T block_allsum(T v, T* slots) {
  v = warp_allsum(v);
  if ((threadIdx.x & (kWarp - 1)) == 0) slots[threadIdx.x / kWarp] = v;
  __syncthreads();
  v = T(0);
  for (int w = 0; w < int(blockDim.x) / kWarp; ++w) v = v + slots[w];
  return v;
}

template <typename T>
__device__ void block_allsum2(T& a, T& b, T* sa, T* sb) {
  a = warp_allsum(a);
  b = warp_allsum(b);
  if ((threadIdx.x & (kWarp - 1)) == 0) {
    sa[threadIdx.x / kWarp] = a;
    sb[threadIdx.x / kWarp] = b;
  }
  __syncthreads();
  a = b = T(0);
  for (int w = 0; w < int(blockDim.x) / kWarp; ++w) {
    a = a + sa[w];
    b = b + sb[w];
  }
}

// K7, the keypoint design: a thread a keypoint (up to 512; more loop), each
// keypoint's scaled cost computed once in frame order and kept in
// registers; three sums over the block, each one shuffle tree and one
// barrier: the residual count, then the live count and the live sum
// together, then the squared deviations (PR 12's design: four 256-thread
// trees of nine barriers each and three passes over the patch costs)
template <typename T>
__global__ void __launch_bounds__(kDecideThreads)
    lm_decide_keypoint_kernel(const T* __restrict__ cost, const T* __restrict__ patch,
                              const T* __restrict__ kp_w, const T* __restrict__ kp_mask, T* sc,
                              const T* __restrict__ prior_cost, T* __restrict__ mask_out,
                              T* __restrict__ w_out, int F, int N, int P, double chi_k,
                              double min_step_quality) {
  constexpr int kSlots = kDecideThreads / kWarp;
  __shared__ T s_count[kSlots], s_live[kSlots], s_sum[kSlots], s_dev[kSlots];
  const int tid = threadIdx.x, nt = blockDim.x;
  const T c0 = sc[S_COST], cur = sc[S_CUR], ref = sc[S_REF], acc_ref = sc[S_ACC_REF],
          mcc = sc[S_MCC];

  // assemble's scale: 1 / max(sum(w) F P, 1). The weights are 0 or 1, so
  // their sum is an integer, exact in any order: the plain version's bits
  T count = T(0);
  for (int n = tid; n < N; n += nt) count = count + kp_w[n];
  T n_res = (block_allsum(count, s_count) * T(F)) * T(P);
  n_res = n_res < T(1) ? T(1) : n_res;   // NaN stays NaN, as torch.clamp leaves it
  const T inv_n = T(1) / n_res;

  // a keypoint's cost: its frames' in frame order
  auto cost_of = [&](int n) {
    T c = T(0);
    for (int f = 0; f < F; ++f) c = c + patch[f * N + n] * inv_n;
    return c;
  };
  // detect_outliers: mu and sigma over the live keypoints (cost >= 1e-8,
  // not padded); the live count is exact in any order as well
  T kept[kDecideKeep], km[kDecideKeep];
  T live_n = T(0), live_c = T(0);
#pragma unroll
  for (int m = 0; m < kDecideKeep; ++m) {
    const int n = tid + m * nt;
    kept[m] = km[m] = T(0);
    if (n < N) {
      kept[m] = cost_of(n);
      km[m] = kp_mask[n];
      const T live = (kept[m] >= T(1e-8) && km[m] > T(0)) ? T(1) : T(0);
      live_n = live_n + live;
      live_c = live_c + kept[m] * live;
    }
  }
  for (int n = tid + kDecideKeep * nt; n < N; n += nt) {
    const T c = cost_of(n);
    const T live = (c >= T(1e-8) && kp_mask[n] > T(0)) ? T(1) : T(0);
    live_n = live_n + live;
    live_c = live_c + c * live;
  }
  block_allsum2(live_n, live_c, s_live, s_sum);
  const T n_live = live_n < T(1) ? T(1) : live_n;
  const T mu = live_c / n_live;
  T dev = T(0);
#pragma unroll
  for (int m = 0; m < kDecideKeep; ++m) {
    if (tid + m * nt < N) {
      const T live = (kept[m] >= T(1e-8) && km[m] > T(0)) ? T(1) : T(0);
      const T d = kept[m] - mu;
      dev = dev + live * (d * d);
    }
  }
  for (int n = tid + kDecideKeep * nt; n < N; n += nt) {
    const T c = cost_of(n);
    const T live = (c >= T(1e-8) && kp_mask[n] > T(0)) ? T(1) : T(0);
    const T d = c - mu;
    dev = dev + live * (d * d);
  }
  const T sigma = sqrt(block_allsum(dev, s_dev) / n_live);
  const T thresh = T(chi_k) * sigma;
#pragma unroll
  for (int m = 0; m < kDecideKeep; ++m) {
    const int n = tid + m * nt;
    if (n < N) {
      const bool outlier = fabs(kept[m] - mu) > thresh && km[m] > T(0);
      const T mk = outlier ? T(0) : T(1);
      mask_out[n] = mk;
      w_out[n] = km[m] * mk;
    }
  }
  for (int n = tid + kDecideKeep * nt; n < N; n += nt) {
    const T c = cost_of(n);
    const bool outlier = fabs(c - mu) > thresh && kp_mask[n] > T(0);
    const T mk = outlier ? T(0) : T(1);
    mask_out[n] = mk;
    w_out[n] = kp_mask[n] * mk;
  }
  if (tid == 0) {
    T cand = cost[0] * inv_n;
    if (prior_cost != nullptr) cand = cand + prior_cost[0];
    // _step_quality; torch.maximum passes a NaN through
    const T rel = (cur - cand) / mcc;
    const T hist = (ref - cand) / (acc_ref + mcc);
    const T quality = rel != rel ? rel : (hist != hist ? hist : (rel > hist ? rel : hist));
    sc[S_CAND_COST] = cand;
    sc[S_QUALITY] = quality;
    sc[S_SUCCESS] = (quality > T(min_step_quality) && cand < c0) ? T(1) : T(0);
    sc[S_ACD_NEW] = c0 - cand;
    sc[S_MU] = mu;
    sc[S_SIGMA] = sigma;
  }
}

// what K8's scalar tail reads: the scalars of the state and of K6 and K7,
// K3's raw cost at the candidate and the prior's cost (0 without a prior)
template <typename T>
struct CommitScalars {
  T radius, decrease, mcc, acd, acd_new, quality, minimum, reference, candidate, acc_ref,
      acc_cand, nonmono, cost, prior_cost;
  bool has_prior;
};

template <typename T>
__device__ __forceinline__ CommitScalars<T> commit_scalars(const T* sc, const T* cost,
                                                           const T* prior_cost) {
  CommitScalars<T> s;
  s.radius = sc[S_RADIUS], s.decrease = sc[S_DECREASE], s.mcc = sc[S_MCC], s.acd = sc[S_ACD];
  s.acd_new = sc[S_ACD_NEW], s.quality = sc[S_QUALITY], s.minimum = sc[S_MIN];
  s.reference = sc[S_REF], s.candidate = sc[S_CAND], s.acc_ref = sc[S_ACC_REF];
  s.acc_cand = sc[S_ACC_CAND], s.nonmono = sc[S_NONMONO], s.cost = cost[0];
  s.has_prior = prior_cost != nullptr;
  s.prior_cost = s.has_prior ? prior_cost[0] : T(0);
  return s;
}

// K8's scalar tail (one thread): the radius, the decrease factor, the step
// evaluator advanced on success (_step_accepted: Conn-Gould-Toint with
// Ceres' always-check step 3d), the cost decrease and the continue flag,
// written into sc
template <typename T>
__device__ void commit_tail(T* sc, const CommitScalars<T>& s, T inv_n, bool success,
                            bool invalid, int max_nonmono, int retry, int more,
                            double min_radius, double max_radius, double min_acd) {
  const T lo = T(min_radius), hi = T(max_radius);
  T acd = s.acd;
  if (success) {
    T cost_f = s.cost * inv_n;
    if (s.has_prior) cost_f = cost_f + s.prior_cost;
    const T x = T(2) * s.quality - T(1);
    T den = T(1) - (x * x) * x;
    den = den < T(1.0 / 3.0) ? T(1.0 / 3.0) : den;
    const T current = cost_f;
    T acc_cand = s.acc_cand + s.mcc;
    T acc_ref = s.acc_ref + s.mcc;
    const bool improved = current < s.minimum;
    const T minimum = improved ? current : s.minimum;
    const T nonmono = improved ? T(0) : s.nonmono + T(1);
    const bool worse = current > s.candidate;
    const T candidate = improved ? current : (worse ? current : s.candidate);
    if (improved || worse) acc_cand = T(0);
    const bool hit = nonmono == T(max_nonmono);
    const T reference = hit ? candidate : s.reference;
    if (hit) acc_ref = acc_cand;
    sc[S_COST] = cost_f;
    sc[S_RADIUS] = clamp(s.radius / den, lo, hi);
    sc[S_DECREASE] = T(2);
    sc[S_MIN] = minimum;
    sc[S_CUR] = current;
    sc[S_REF] = reference;
    sc[S_CAND] = candidate;
    sc[S_ACC_REF] = acc_ref;
    sc[S_ACC_CAND] = acc_cand;
    sc[S_NONMONO] = nonmono;
    acd = s.acd_new;
  } else {
    sc[S_RADIUS] = clamp(s.radius / s.decrease, lo, hi);
    sc[S_DECREASE] = s.decrease * T(2);
    if (!invalid && !retry) acd = s.acd_new;
  }
  sc[S_ACD] = acd;
  sc[S_CONTINUE] = (more && acd >= T(min_acd)) ? T(1) : T(0);
}

// K8, the earlier block design (lm_commit_block_*): 256 threads; the flags
// read, then the residual count by block_sum's nine-barrier tree, then the
// accepted branch's loads, then thread 0 reads the scalars again for the
// step evaluator's tail: three dependent trips to memory
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_commit_block_kernel(T* t, T* q, T* H, T* g, T* sc, T* mask, T* kp_w, T* patch_costs,
                           const T* __restrict__ H1, const T* __restrict__ cand_t,
                           const T* __restrict__ cand_q, const T* __restrict__ cost,
                           const T* __restrict__ g_raw, const T* __restrict__ H_raw,
                           const T* __restrict__ patch, const T* __restrict__ new_mask,
                           const T* __restrict__ new_w, const T* __restrict__ prior_cost,
                           const T* __restrict__ prior_g, const T* __restrict__ prior_H,
                           int D, int K, int F, int N, int P, int max_nonmono, int retry,
                           int more, double min_radius, double max_radius, double min_acd) {
  __shared__ T red[kThreads];
  const int tid = threadIdx.x;
  const bool invalid = sc[S_INVALID] != T(0);
  const bool success = sc[S_SUCCESS] != T(0) && !invalid;
  const T inv_n = inverse_count(new_w, N, F, P, red);   // its barriers order the reads of sc

  // the state's arrays: each entry read and written by one thread
  for (int e = tid; e < D * D; e += kThreads) {
    T h = H1[e];
    if (success) {
      h = H_raw[e] * inv_n;
      if (prior_H != nullptr) h = h + prior_H[e];
    }
    H[e] = h;
  }
  if (success) {
    for (int i = tid; i < D; i += kThreads) {
      T v = g_raw[i] * inv_n;
      if (prior_g != nullptr) v = v + prior_g[i];
      g[i] = v;
    }
    for (int i = tid; i < 3 * K; i += kThreads) t[i] = cand_t[i];
    for (int i = tid; i < 4 * K; i += kThreads) q[i] = cand_q[i];
    for (int n = tid; n < N; n += kThreads) {
      mask[n] = new_mask[n];
      kp_w[n] = new_w[n];
    }
    for (int e = tid; e < F * N; e += kThreads) patch_costs[e] = patch[e] * inv_n;
  }
  if (tid != 0) return;
  commit_tail(sc, commit_scalars(sc, cost, prior_cost), inv_n, success, invalid, max_nonmono,
              retry, more, min_radius, max_radius, min_acd);
}

// K8, the staged design, which the LM launches (lm_commit_*). K8 moves a
// few kilobytes and does a few operations an entry; what sets its time is
// the launch and the chain of dependent trips to memory, three in the block
// design. Here every thread issues every load it needs in one first batch,
// before any is used and without waiting on the flags: K6's and K7's flags,
// its entries of H1, K3's H and the prior's H, of K3's patch costs, of K3's
// g and the prior's g, of the candidate knots, of the new mask and weights,
// and thread 0 the scalars that the step evaluator's tail reads with K3's
// and the prior's cost. A rejected or invalid step loads arrays that it
// throws away: latency, not bytes, sets the time. The residual count takes
// no block-wide tree: each warp sums the new weights itself by shuffles
// (from L1, in flight since the first batch), so the kernel takes no
// barrier; the weights are 0 or 1, whose sum is exact in any order, so
// every warp holds the bits of the plain stage's count and the block
// design's tree. Then the selects and the stores, and thread 0 runs the
// scalar tail after its own stores, while they drain, on the scalars of
// the first batch.
// 256 threads (128 and 512 were measured too: PERF.md). The first batch
// covers kCommitMat entries a thread of [D, D] and [F, N] (D <= 45, F N <=
// 2048), kCommitKp of [N] (N <= 512) and one of [D], [K, 3] and [K, 4];
// arrays past that take their other entries in loops after it. Each entry
// is the block design's arithmetic in its order: the same bits. One block
// a multiprocessor in the launch bounds: with the default, ptxas held the
// float instantiation to 64 registers and spilled part of the first batch
// to local memory, a trip the design exists to take off the chain.
constexpr int kCommitMat = 8;
constexpr int kCommitKp = 2;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    lm_commit_staged_kernel(T* __restrict__ t, T* __restrict__ q, T* __restrict__ H,
                            T* __restrict__ g, T* __restrict__ sc, T* __restrict__ mask,
                            T* __restrict__ kp_w, T* __restrict__ patch_costs,
                            const T* __restrict__ H1, const T* __restrict__ cand_t,
                            const T* __restrict__ cand_q, const T* __restrict__ cost,
                            const T* __restrict__ g_raw, const T* __restrict__ H_raw,
                            const T* __restrict__ patch, const T* __restrict__ new_mask,
                            const T* __restrict__ new_w, const T* __restrict__ prior_cost,
                            const T* __restrict__ prior_g, const T* __restrict__ prior_H,
                            int D, int K, int F, int N, int P, int max_nonmono, int retry,
                            int more, double min_radius, double max_radius, double min_acd) {
  const int tid = threadIdx.x, lane = tid & (kWarp - 1);
  const int DD = D * D, FN = F * N, K3 = 3 * K, K4 = 4 * K;
  const bool prior = prior_H != nullptr;

  // 1. the first batch: every load issued before any is used
  const T f_invalid = sc[S_INVALID], f_success = sc[S_SUCCESS];
  T h1[kCommitMat], hr[kCommitMat], ph[kCommitMat], pa[kCommitMat];
#pragma unroll
  for (int m = 0; m < kCommitMat; ++m) {
    const int e = tid + m * kThreads;
    h1[m] = e < DD ? H1[e] : T(0);
    hr[m] = e < DD ? H_raw[e] : T(0);
    ph[m] = prior && e < DD ? prior_H[e] : T(0);
    pa[m] = e < FN ? patch[e] : T(0);
  }
  const T gr = tid < D ? g_raw[tid] : T(0);
  const T pg = prior && tid < D ? prior_g[tid] : T(0);
  const T ct = tid < K3 ? cand_t[tid] : T(0);
  const T cq = tid < K4 ? cand_q[tid] : T(0);
  T nm[kCommitKp], nw[kCommitKp];
#pragma unroll
  for (int m = 0; m < kCommitKp; ++m) {
    const int n = tid + m * kThreads;
    nm[m] = n < N ? new_mask[n] : T(0);
    nw[m] = n < N ? new_w[n] : T(0);
  }
  CommitScalars<T> tail;
  if (tid == 0) tail = commit_scalars(sc, cost, prior_cost);

  // 2. assemble's scale, 1 / max(sum(w) F P, 1), each warp its own count
  T count = T(0);
#pragma unroll 4
  for (int n = lane; n < N; n += kWarp) count = count + new_w[n];
  T n_res = (warp_allsum(count) * T(F)) * T(P);
  n_res = n_res < T(1) ? T(1) : n_res;   // NaN stays NaN, as torch.clamp leaves it
  const T inv_n = T(1) / n_res;
  const bool invalid = f_invalid != T(0);
  const bool success = f_success != T(0) && !invalid;

  // 3. the selects and the stores; each entry by one thread, in the block design's order
  auto scaled = [&](T raw, T pri) {
    T v = raw * inv_n;
    if (prior) v = v + pri;
    return v;
  };
#pragma unroll
  for (int m = 0; m < kCommitMat; ++m) {
    const int e = tid + m * kThreads;
    if (e < DD) H[e] = success ? scaled(hr[m], ph[m]) : h1[m];
  }
  if (success) {
#pragma unroll
    for (int m = 0; m < kCommitMat; ++m) {
      const int e = tid + m * kThreads;
      if (e < FN) patch_costs[e] = pa[m] * inv_n;
    }
    if (tid < D) g[tid] = scaled(gr, pg);
    if (tid < K3) t[tid] = ct;
    if (tid < K4) q[tid] = cq;
#pragma unroll
    for (int m = 0; m < kCommitKp; ++m) {
      const int n = tid + m * kThreads;
      if (n < N) mask[n] = nm[m], kp_w[n] = nw[m];
    }
  }
  // past the first batch's cover
  for (int e = tid + kCommitMat * kThreads; e < DD; e += kThreads)
    H[e] = success ? scaled(H_raw[e], prior ? prior_H[e] : T(0)) : H1[e];
  if (success) {
    for (int e = tid + kCommitMat * kThreads; e < FN; e += kThreads)
      patch_costs[e] = patch[e] * inv_n;
    for (int i = tid + kThreads; i < D; i += kThreads)
      g[i] = scaled(g_raw[i], prior ? prior_g[i] : T(0));
    for (int i = tid + kThreads; i < K3; i += kThreads) t[i] = cand_t[i];
    for (int i = tid + kThreads; i < K4; i += kThreads) q[i] = cand_q[i];
    for (int n = tid + kCommitKp * kThreads; n < N; n += kThreads)
      mask[n] = new_mask[n], kp_w[n] = new_w[n];
  }

  // 4. the scalar tail, thread 0, while the stores drain
  if (tid == 0)
    commit_tail(sc, tail, inv_n, success, invalid, max_nonmono, retry, more, min_radius,
                max_radius, min_acd);
}

template <typename T>
int launch_step(const T* H, const T* g, T* sc, const T* t, const T* q, T* H1, T* step, T* ct,
                T* cq, T* scratch, int D, int K, int shared_h1, int smem, cudaStream_t stream) {
  // the wrapper's layout (ops/cuda_lm.py's step_layout) against the kernel's
  if (size_t(smem) != step_bytes<T>(D, scratch == nullptr, shared_h1 != 0))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lm_step_shfl_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  lm_step_shfl_kernel<T><<<1, kThreads, smem, stream>>>(H, g, sc, t, q, H1, step, ct, cq,
                                                        scratch, D, K, shared_h1);
  return cudaGetLastError();
}

template <typename T>
int launch_step_block(const T* H, const T* g, T* sc, const T* t, const T* q, T* H1, T* step,
                      T* ct, T* cq, T* scratch, int D, int K, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lm_step_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  lm_step_block_kernel<T><<<1, kThreads, smem, stream>>>(H, g, sc, t, q, H1, step, ct, cq,
                                                         scratch, D, K);
  return cudaGetLastError();
}

template <typename T>
int launch_decide(const T* cost, const T* patch, const T* w, const T* kp_mask, T* sc,
                  const T* prior_cost, T* mask, T* w_out, int F, int N, int P, double chi_k,
                  double min_q, int threads, cudaStream_t stream) {
  // ops/cuda_lm.py's decide_threads
  if (threads < kWarp || threads > kDecideThreads || threads % kWarp != 0)
    return cudaErrorInvalidValue;
  lm_decide_keypoint_kernel<T><<<1, threads, 0, stream>>>(cost, patch, w, kp_mask, sc,
                                                          prior_cost, mask, w_out, F, N, P,
                                                          chi_k, min_q);
  return cudaGetLastError();
}

template <typename T>
int launch_decide_block(const T* cost, const T* patch, const T* w, const T* kp_mask, T* sc,
                        const T* prior_cost, T* mask, T* w_out, int F, int N, int P,
                        double chi_k, double min_q, cudaStream_t stream) {
  lm_decide_block_kernel<T><<<1, kThreads, 0, stream>>>(cost, patch, w, kp_mask, sc,
                                                        prior_cost, mask, w_out, F, N, P, chi_k,
                                                        min_q);
  return cudaGetLastError();
}

template <typename T>
int launch_commit_block(T* t, T* q, T* H, T* g, T* sc, T* mask, T* w, T* pc, const T* H1,
                        const T* ct, const T* cq, const T* cost, const T* g_raw,
                        const T* H_raw, const T* patch, const T* new_mask, const T* new_w,
                        const T* prior_cost, const T* prior_g, const T* prior_H, int D, int K,
                        int F, int N, int P, int max_nonmono, int retry, int more,
                        double min_radius, double max_radius, double min_acd,
                        cudaStream_t stream) {
  lm_commit_block_kernel<T><<<1, kThreads, 0, stream>>>(
      t, q, H, g, sc, mask, w, pc, H1, ct, cq, cost, g_raw, H_raw, patch, new_mask, new_w,
      prior_cost, prior_g, prior_H, D, K, F, N, P, max_nonmono, retry, more, min_radius,
      max_radius, min_acd);
  return cudaGetLastError();
}

template <typename T>
int launch_commit(T* t, T* q, T* H, T* g, T* sc, T* mask, T* w, T* pc, const T* H1,
                  const T* ct, const T* cq, const T* cost, const T* g_raw, const T* H_raw,
                  const T* patch, const T* new_mask, const T* new_w, const T* prior_cost,
                  const T* prior_g, const T* prior_H, int D, int K, int F, int N, int P,
                  int max_nonmono, int retry, int more, double min_radius, double max_radius,
                  double min_acd, cudaStream_t stream) {
  lm_commit_staged_kernel<T><<<1, kThreads, 0, stream>>>(
      t, q, H, g, sc, mask, w, pc, H1, ct, cq, cost, g_raw, H_raw, patch, new_mask, new_w,
      prior_cost, prior_g, prior_H, D, K, F, N, P, max_nonmono, retry, more, min_radius,
      max_radius, min_acd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int lm_scalars_size() { return S_SIZE; }

#define LM_ENTRIES(T, SUFFIX)                                                                   \
  int lm_step_##SUFFIX(const T* H, const T* g, T* sc, const T* t, const T* q, T* H1, T* step,  \
                       T* ct, T* cq, T* scratch, int D, int K, int shared_h1, int smem,         \
                       cudaStream_t stream) {                                                   \
    return launch_step<T>(H, g, sc, t, q, H1, step, ct, cq, scratch, D, K, shared_h1, smem,    \
                          stream);                                                              \
  }                                                                                             \
  int lm_step_block_##SUFFIX(const T* H, const T* g, T* sc, const T* t, const T* q, T* H1,     \
                             T* step, T* ct, T* cq, T* scratch, int D, int K, int smem,         \
                             cudaStream_t stream) {                                             \
    return launch_step_block<T>(H, g, sc, t, q, H1, step, ct, cq, scratch, D, K, smem,         \
                                stream);                                                        \
  }                                                                                             \
  int lm_decide_##SUFFIX(const T* cost, const T* patch, const T* w, const T* kp_mask, T* sc,   \
                         const T* prior_cost, T* mask, T* w_out, int F, int N, int P,          \
                         double chi_k, double min_q, int threads, cudaStream_t stream) {       \
    return launch_decide<T>(cost, patch, w, kp_mask, sc, prior_cost, mask, w_out, F, N, P,     \
                            chi_k, min_q, threads, stream);                                     \
  }                                                                                             \
  int lm_decide_block_##SUFFIX(const T* cost, const T* patch, const T* w, const T* kp_mask,    \
                               T* sc, const T* prior_cost, T* mask, T* w_out, int F, int N,    \
                               int P, double chi_k, double min_q, cudaStream_t stream) {       \
    return launch_decide_block<T>(cost, patch, w, kp_mask, sc, prior_cost, mask, w_out, F, N,  \
                                  P, chi_k, min_q, stream);                                     \
  }                                                                                             \
  int lm_commit_##SUFFIX(T* t, T* q, T* H, T* g, T* sc, T* mask, T* w, T* pc, const T* H1,     \
                         const T* ct, const T* cq, const T* cost, const T* g_raw,              \
                         const T* H_raw, const T* patch, const T* new_mask, const T* new_w,    \
                         const T* prior_cost, const T* prior_g, const T* prior_H, int D,       \
                         int K, int F, int N, int P, int max_nonmono, int retry, int more,     \
                         double min_radius, double max_radius, double min_acd,                 \
                         cudaStream_t stream) {                                                 \
    return launch_commit<T>(t, q, H, g, sc, mask, w, pc, H1, ct, cq, cost, g_raw, H_raw,       \
                            patch, new_mask, new_w, prior_cost, prior_g, prior_H, D, K, F, N,  \
                            P, max_nonmono, retry, more, min_radius, max_radius, min_acd,      \
                            stream);                                                            \
  }                                                                                             \
  int lm_commit_block_##SUFFIX(T* t, T* q, T* H, T* g, T* sc, T* mask, T* w, T* pc,            \
                               const T* H1, const T* ct, const T* cq, const T* cost,           \
                               const T* g_raw, const T* H_raw, const T* patch,                 \
                               const T* new_mask, const T* new_w, const T* prior_cost,         \
                               const T* prior_g, const T* prior_H, int D, int K, int F, int N, \
                               int P, int max_nonmono, int retry, int more, double min_radius, \
                               double max_radius, double min_acd, cudaStream_t stream) {       \
    return launch_commit_block<T>(t, q, H, g, sc, mask, w, pc, H1, ct, cq, cost, g_raw, H_raw, \
                                  patch, new_mask, new_w, prior_cost, prior_g, prior_H, D, K,  \
                                  F, N, P, max_nonmono, retry, more, min_radius, max_radius,   \
                                  min_acd, stream);                                             \
  }

LM_ENTRIES(float, f32)
LM_ENTRIES(double, f64)

#undef LM_ENTRIES

}  // extern "C"
