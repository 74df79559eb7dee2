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
// the card's memory or arithmetic rate; the time is the launch, the chain of
// D pivots of the factorisation (three barriers each) and the two triangular
// solves (two barriers a row). One CTA each, so every decision is made where
// its inputs are, without a second launch or an atomic, and the host reads
// one flag an iteration (K8's continue flag).
//
// Orders of the sums (not cuSOLVER's or torch.sum's, which cannot be
// followed bit for bit): the factorisation is the right-looking Cholesky,
// column by column, each trailing entry updated once per pivot in pivot
// order; the solves go row by row (forward) and back, then once more on
// the residual g - H1 x summed in double the working precision (one step
// of refinement: the step is then close to the exact solution's rounding,
// so it stays near LAPACK's and cuSOLVER's whatever the order); every
// reduction over the block is each thread's strided elements in order, then
// a tree over the 256 threads in shared memory. This order is written out in
// torch in experiments/residual_kernels.py (lm_step_kernel_order), to which
// the card's checks hold K6's step and model change bit for bit. The retraction follows the card's torch in
// its order of operations (this source builds with -fmad=false, as K2, K4
// and K5 do), so the candidate knots equal spline_retract_flat of K6's own
// step on the card bit for bit, and K5 anchors the candidate's patches
// exactly as it anchors the plain retraction's.
//
// The factor lives in shared memory while D*D values fit (D up to ~165 in
// f64, ~235 in f32; ops/cuda_lm.py's step_smem_bytes), else in a global
// scratch matrix in the same kernel: no D leaves the kernel.

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

constexpr int kThreads = 256;   // ops/cuda_lm.py's LM_THREADS

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_step_kernel(const T* __restrict__ H, const T* __restrict__ g, T* sc,
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

  // the candidate knots: [all t; all omega] steps retracted, or the knots
  const T thr = sizeof(T) >= 8 ? T(1e-20) : T(1e-10);
  for (int k = tid; k < K; k += kThreads) {
    const Quat<T> qk{knot_q[4 * k], knot_q[4 * k + 1], knot_q[4 * k + 2], knot_q[4 * k + 3]};
    if (invalid) {
      for (int c = 0; c < 3; ++c) cand_t[3 * k + c] = knot_t[3 * k + c];
      cand_q[4 * k] = qk.x, cand_q[4 * k + 1] = qk.y, cand_q[4 * k + 2] = qk.z,
      cand_q[4 * k + 3] = qk.w;
      continue;
    }
    for (int c = 0; c < 3; ++c) cand_t[3 * k + c] = knot_t[3 * k + c] + b[3 * k + c];
    const T* w = b + 3 * K + 3 * k;
    const Quat<T> r = spline::qmul(qk, spline::quat_exp(V3<T>{w[0], w[1], w[2]}, thr));
    cand_q[4 * k] = r.x, cand_q[4 * k + 1] = r.y, cand_q[4 * k + 2] = r.z,
    cand_q[4 * k + 3] = r.w;
  }
  if (tid == 0) {
    sc[S_MCC] = mcc;
    sc[S_INVALID] = invalid ? T(1) : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_decide_kernel(const T* __restrict__ cost, const T* __restrict__ patch,
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lm_commit_kernel(T* t, T* q, T* H, T* g, T* sc, T* mask, T* kp_w, T* patch_costs,
                     const T* __restrict__ H1, const T* __restrict__ cand_t,
                     const T* __restrict__ cand_q, const T* __restrict__ cost,
                     const T* __restrict__ g_raw, const T* __restrict__ H_raw,
                     const T* __restrict__ patch, const T* __restrict__ new_mask,
                     const T* __restrict__ new_w, const T* __restrict__ prior_cost,
                     const T* __restrict__ prior_g, const T* __restrict__ prior_H, int D, int K,
                     int F, int N, int P, int max_nonmono, int retry, int more,
                     double min_radius, double max_radius, double min_acd) {
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

  const T lo = T(min_radius), hi = T(max_radius);
  const T radius = sc[S_RADIUS], decrease = sc[S_DECREASE], mcc = sc[S_MCC];
  T acd = sc[S_ACD];
  if (success) {
    T cost_f = cost[0] * inv_n;
    if (prior_cost != nullptr) cost_f = cost_f + prior_cost[0];
    const T x = T(2) * sc[S_QUALITY] - T(1);
    T den = T(1) - (x * x) * x;
    den = den < T(1.0 / 3.0) ? T(1.0 / 3.0) : den;
    // _step_accepted: Conn-Gould-Toint with Ceres' always-check step 3d
    const T current = cost_f;
    T acc_cand = sc[S_ACC_CAND] + mcc;
    T acc_ref = sc[S_ACC_REF] + mcc;
    const bool improved = current < sc[S_MIN];
    const T minimum = improved ? current : sc[S_MIN];
    const T nonmono = improved ? T(0) : sc[S_NONMONO] + T(1);
    const bool worse = current > sc[S_CAND];
    const T candidate = improved ? current : (worse ? current : sc[S_CAND]);
    if (improved || worse) acc_cand = T(0);
    const bool hit = nonmono == T(max_nonmono);
    const T reference = hit ? candidate : sc[S_REF];
    if (hit) acc_ref = acc_cand;
    sc[S_COST] = cost_f;
    sc[S_RADIUS] = clamp(radius / den, lo, hi);
    sc[S_DECREASE] = T(2);
    sc[S_MIN] = minimum;
    sc[S_CUR] = current;
    sc[S_REF] = reference;
    sc[S_CAND] = candidate;
    sc[S_ACC_REF] = acc_ref;
    sc[S_ACC_CAND] = acc_cand;
    sc[S_NONMONO] = nonmono;
    acd = sc[S_ACD_NEW];
  } else {
    sc[S_RADIUS] = clamp(radius / decrease, lo, hi);
    sc[S_DECREASE] = decrease * T(2);
    if (!invalid && !retry) acd = sc[S_ACD_NEW];
  }
  sc[S_ACD] = acd;
  sc[S_CONTINUE] = (more && acd >= T(min_acd)) ? T(1) : T(0);
}

template <typename T>
int launch_step(const T* H, const T* g, T* sc, const T* t, const T* q, T* H1, T* step, T* ct,
                T* cq, T* scratch, int D, int K, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lm_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  lm_step_kernel<T><<<1, kThreads, smem, stream>>>(H, g, sc, t, q, H1, step, ct, cq, scratch,
                                                   D, K);
  return cudaGetLastError();
}

template <typename T>
int launch_decide(const T* cost, const T* patch, const T* w, const T* kp_mask, T* sc,
                  const T* prior_cost, T* mask, T* w_out, int F, int N, int P, double chi_k,
                  double min_q, cudaStream_t stream) {
  lm_decide_kernel<T><<<1, kThreads, 0, stream>>>(cost, patch, w, kp_mask, sc, prior_cost,
                                                  mask, w_out, F, N, P, chi_k, min_q);
  return cudaGetLastError();
}

template <typename T>
int launch_commit(T* t, T* q, T* H, T* g, T* sc, T* mask, T* w, T* pc, const T* H1,
                  const T* ct, const T* cq, const T* cost, const T* g_raw, const T* H_raw,
                  const T* patch, const T* new_mask, const T* new_w, const T* prior_cost,
                  const T* prior_g, const T* prior_H, int D, int K, int F, int N, int P,
                  int max_nonmono, int retry, int more, double min_radius, double max_radius,
                  double min_acd, cudaStream_t stream) {
  lm_commit_kernel<T><<<1, kThreads, 0, stream>>>(
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
                       T* ct, T* cq, T* scratch, int D, int K, int smem,                        \
                       cudaStream_t stream) {                                                   \
    return launch_step<T>(H, g, sc, t, q, H1, step, ct, cq, scratch, D, K, smem, stream);      \
  }                                                                                             \
  int lm_decide_##SUFFIX(const T* cost, const T* patch, const T* w, const T* kp_mask, T* sc,   \
                         const T* prior_cost, T* mask, T* w_out, int F, int N, int P,          \
                         double chi_k, double min_q, cudaStream_t stream) {                    \
    return launch_decide<T>(cost, patch, w, kp_mask, sc, prior_cost, mask, w_out, F, N, P,     \
                            chi_k, min_q, stream);                                              \
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
  }

LM_ENTRIES(float, f32)
LM_ENTRIES(double, f64)

#undef LM_ENTRIES

}  // extern "C"
