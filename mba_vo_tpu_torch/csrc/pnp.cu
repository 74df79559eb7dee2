// K13: the backend's robust PnP on the card, every LM iteration of a batch
// of problems in one launch, and the loop-closure gate's residual norms at
// the final pose.
//
// Replaces mba_vo_tpu/backend/geometry.py::solve_pnp (:77-158, its
// lax.while_loop :157, jitted as solve_pnp_jit :161) and
// pnp_residual_norms (:164-181), which XLA compiles into one device program
// each (no Pallas source). Bound in ops/cuda_backend.py (pnp_solve_cuda);
// the plain versions are backend/geometry.py's solve_pnp_plain and
// pnp_residual_norms.
//
// What it computes, for each problem b of the batch [B, N]: from the
// camera-to-F pose (t, q) = init, the masked mean Huber cost of the
// reprojections of points [N, 3] against obs [N, 2] (pinhole K, depth
// clamped at 1e-6), then max_iterations LM iterations on the tangent
// [dt; dw] under t + dt, q (x) exp(dw): the normal equations H [6, 6] and g
// [6] of the Huber-weighted residuals (the closed-form 2 x 6 Jacobian of
// backend/ba.py::reprojection_jacobians, zero in depth where the clamp is
// active, the weight times the mask), each divided by n = max(sum(mask),
// 1); Hd = H + lambda diag(H) + 1e-12 I solved by LU with partial pivoting
// (the method of jnp.linalg.solve and torch.linalg.solve_ex; a pivot that
// is exactly 0 gives a NaN step); the candidate's cost; ok = candidate cost
// < cost and a finite step; the select; lambda halved or times 4. Writes
// the row [norms (N) | cost | t (3) | q (4)] of the final pose, the layout
// the backend's loop stage reads in one copy.
//
// The mask multiplies every term, it never branches: a NaN point in a row
// whose mask is 0 makes the cost NaN, so every step is rejected and the
// pose stays at init, as in both reference implementations. NaN compares
// false, so a NaN candidate cost is never accepted either.
//
// What bounds it: latency. At N = 256 a problem reads 6 KB and each
// iteration does ~40 k operations; the time is the chain of 2 max_iterations
// + 1 block reductions, each ended by a barrier, and one thread's 6 x 6
// LU, quaternion exponential and product between them.
//
// Design: one CTA of 256 threads a problem, thread i the correspondences
// i, i + 256, ...; each thread keeps its running sums of H's 21 upper
// entries and g's 6 (or of the cost) in registers; a block reduction in a
// fixed order (a butterfly of shuffles in each warp, then lane 0's values
// summed warp by warp in order by one thread an entry) makes every sum
// repeat bit for bit. Thread 0 forms Hd, solves it, retracts and decides;
// the pose, lambda and cost live in shared memory.

#include <cuda_runtime.h>
#include <math.h>

#include "pose_geometry.cuh"
#include "spline_pose.cuh"

namespace {

using namespace geo;

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int kSums = 27;   // H's upper triangle row by row (21), then g (6)

// the sums of every thread's v[0..K) in a fixed order into out[0..K);
// red holds kWarps * K values. Ends with a barrier.
template <typename T, int K>
__device__ __forceinline__ void block_sum(T (&v)[K], T* red, T* out) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) v[k] = v[k] + __shfl_xor_sync(~0u, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  __syncthreads();
  if (tid < K) {
    T s = red[tid];
    for (int w = 1; w < kWarps; ++w) s = s + red[w * K + tid];
    out[tid] = s;
  }
  __syncthreads();
}

// The problem's inputs
template <typename T>
struct Problem {
  const T* pts;    // [N, 3]
  const T* obs;    // [N, 2]
  const T* mask;   // [N]
  const T* K;      // [4]
  int N;
};

// correspondence i's residual at the camera-to-F pose (q^-1, t)
template <typename T>
__device__ __forceinline__ V3<T> reproject(const Problem<T>& p, const Pose3<T>& P, int i, T* r) {
  const V3<T> Pc = camera_point(P, load_v(p.pts, i));
  residual(Pc, p.K, p.obs[2 * i], p.obs[2 * i + 1], r);
  return Pc;
}

// solve_pnp_plain's cost_of: sum(rho mask) / n at the pose; every thread
// returns it
template <typename T>
__device__ __forceinline__ T cost_at(const Problem<T>& p, const Pose3<T>& P, double huber_a,
                                     T n, T* red, T* out) {
  T acc[1] = {T(0)};
  for (int i = threadIdx.x; i < p.N; i += kThreads) {
    T r[2], rho, w2;
    reproject(p, P, i, r);
    huber(r, huber_a, rho, w2);
    acc[0] = acc[0] + rho * p.mask[i];
  }
  block_sum<T, 1>(acc, red, out);
  return out[0] / n;
}

// the camera-to-F pose (t, q) as the camera point's inputs
template <typename T>
__device__ __forceinline__ Pose3<T> pose_of(const T* s) {
  return Pose3<T>{spline::qconj(Quat<T>{s[3], s[4], s[5], s[6]}), V3<T>{s[0], s[1], s[2]}};
}

// Hd x = g by LU with partial pivoting (the first largest pivot, as LAPACK's
// getrf), A [6 x 6] row-major and g overwritten; false where a pivot is
// exactly 0 (torch.linalg.solve_ex's info != 0)
template <typename T>
__device__ bool lu_solve6(T (&A)[36], T (&g)[6]) {
  bool ok = true;
  for (int k = 0; k < 6; ++k) {
    int p = k;
    T best = fabs(A[6 * k + k]);
    for (int i = k + 1; i < 6; ++i)
      if (fabs(A[6 * i + k]) > best) {
        best = fabs(A[6 * i + k]);
        p = i;
      }
    if (p != k) {
      for (int j = 0; j < 6; ++j) {
        const T tmp = A[6 * k + j];
        A[6 * k + j] = A[6 * p + j];
        A[6 * p + j] = tmp;
      }
      const T tmp = g[k];
      g[k] = g[p];
      g[p] = tmp;
    }
    const T piv = A[6 * k + k];
    if (piv == T(0)) {
      ok = false;
      continue;
    }
    for (int i = k + 1; i < 6; ++i) {
      const T l = A[6 * i + k] / piv;
      A[6 * i + k] = l;
      for (int j = k + 1; j < 6; ++j) A[6 * i + j] = A[6 * i + j] - l * A[6 * k + j];
      g[i] = g[i] - l * g[k];
    }
  }
  for (int i = 5; i >= 0; --i) {
    T s = g[i];
    for (int j = i + 1; j < 6; ++j) s = s - A[6 * i + j] * g[j];
    g[i] = s / A[6 * i + i];
  }
  return ok;
}

// state slots in shared memory
enum { S_T = 0, S_Q = 3, S_COST = 7, S_LAM, S_N, S_CT, S_CQ = S_CT + 3, S_FINITE = S_CQ + 4,
       S_SIZE };

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pnp_solve_kernel(const T* __restrict__ pts, const T* __restrict__ obs,
                     const T* __restrict__ mask, const T* __restrict__ K,
                     const T* __restrict__ init_t, const T* __restrict__ init_q,
                     T* __restrict__ out, int N, double huber_a, int iterations) {
  __shared__ T red[kWarps * kSums];
  __shared__ T tot[kSums];
  __shared__ T st[S_SIZE];
  const int b = blockIdx.x, tid = threadIdx.x;
  const Problem<T> p{pts + size_t(3) * N * b, obs + size_t(2) * N * b, mask + size_t(N) * b, K,
                     N};
  out += size_t(N + 8) * b;

  if (tid < 3) st[S_T + tid] = init_t[3 * b + tid];
  if (tid < 4) st[S_Q + tid] = init_q[4 * b + tid];
  {
    T acc[1] = {T(0)};
    for (int i = tid; i < N; i += kThreads) acc[0] = acc[0] + p.mask[i];
    block_sum<T, 1>(acc, red, tot);   // ends with a barrier: st's pose visible
  }
  const T n = clamp_min(tot[0], T(1));
  T cost = cost_at(p, pose_of(st), huber_a, n, red, tot);
  T lam = T(1e-4);

  for (int it = 0; it < iterations; ++it) {
    // the normal equations at the pose
    const Pose3<T> P = pose_of(st);
    T Rt[9];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const V3<T> c = qrot(P.q_inv, V3<T>{T(j == 0), T(j == 1), T(j == 2)});
      Rt[j] = c.x;
      Rt[3 + j] = c.y;
      Rt[6 + j] = c.z;
    }
    T acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = T(0);
    const T K0 = K[0], K1 = K[1];
    for (int i = tid; i < N; i += kThreads) {
      T r[2], rho, w2;
      const V3<T> Pc = reproject(p, P, i, r);
      huber(r, huber_a, rho, w2);
      const T wgt = w2 * p.mask[i];
      // reprojection_jacobians: dproj [2 x 3], J = [-dproj R^T, dproj [Pc]x]
      const T z = clamp_min(Pc.z, T(1e-6));
      const T inv_z = T(1) / z;
      const T live = Pc.z > T(1e-6) ? T(1) : T(0);
      const T dp[6] = {K0 * inv_z, T(0), (((-K0) * Pc.x) * inv_z) * inv_z * live,
                       T(0), K1 * inv_z, (((-K1) * Pc.y) * inv_z) * inv_z * live};
      T Ph[9];
      hat(Pc, Ph);
      T J[12];
#pragma unroll
      for (int row = 0; row < 2; ++row)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          J[6 * row + j] = -((dp[3 * row] * Rt[j] + dp[3 * row + 1] * Rt[3 + j]) +
                             dp[3 * row + 2] * Rt[6 + j]);
          J[6 * row + 3 + j] = (dp[3 * row] * Ph[j] + dp[3 * row + 1] * Ph[3 + j]) +
                               dp[3 * row + 2] * Ph[6 + j];
        }
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int c = a; c < 6; ++c, ++k)
          acc[k] = acc[k] + ((J[a] * wgt) * J[c] + (J[6 + a] * wgt) * J[6 + c]);
#pragma unroll
      for (int a = 0; a < 6; ++a)
        acc[21 + a] = acc[21 + a] + ((J[a] * wgt) * r[0] + (J[6 + a] * wgt) * r[1]);
    }
    block_sum<T, kSums>(acc, red, tot);

    // thread 0: the damped solve, the retraction
    if (tid == 0) {
      T A[36], x[6];
      int k = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c, ++k) {
          A[6 * a + c] = tot[k] / n;
          A[6 * c + a] = A[6 * a + c];
        }
      for (int a = 0; a < 6; ++a) x[a] = tot[21 + a] / n;
      for (int a = 0; a < 6; ++a) A[7 * a] = (A[7 * a] + lam * A[7 * a]) + T(1e-12);
      const bool solved = lu_solve6(A, x);
      T d[6];
      bool finite = true;
      for (int a = 0; a < 6; ++a) {
        d[a] = solved ? -x[a] : T(NAN);
        finite = finite && isfinite(d[a]);
      }
      const Quat<T> e = spline::quat_exp(V3<T>{d[3], d[4], d[5]}, small_threshold<T>());
      const Quat<T> cq = spline::qmul(Quat<T>{st[S_Q], st[S_Q + 1], st[S_Q + 2], st[S_Q + 3]}, e);
      st[S_CT] = st[S_T] + d[0];
      st[S_CT + 1] = st[S_T + 1] + d[1];
      st[S_CT + 2] = st[S_T + 2] + d[2];
      st[S_CQ] = cq.x;
      st[S_CQ + 1] = cq.y;
      st[S_CQ + 2] = cq.z;
      st[S_CQ + 3] = cq.w;
      st[S_FINITE] = finite ? T(1) : T(0);
    }
    __syncthreads();
    const T cand = cost_at(p, pose_of(st + S_CT), huber_a, n, red, tot);
    const bool ok = cand < cost && st[S_FINITE] != T(0);
    if (ok) {
      cost = cand;
      lam = lam * T(0.5);
    } else {
      lam = lam * T(4);
    }
    __syncthreads();   // every thread has read the candidate's flag
    if (ok && tid < 7) st[S_T + tid] = st[S_CT + tid];
    __syncthreads();
  }

  // the epilogue: pnp_residual_norms at the final pose, then cost, t, q
  const Pose3<T> P = pose_of(st);
  for (int i = tid; i < N; i += kThreads) {
    T r[2];
    reproject(p, P, i, r);
    out[i] = sqrt(r[0] * r[0] + r[1] * r[1]);
  }
  if (tid == 0) out[N] = cost;
  if (tid < 7) out[N + 1 + tid] = st[S_T + tid];
}

template <typename T>
int launch_pnp(const T* pts, const T* obs, const T* mask, const T* K, const T* init_t,
               const T* init_q, T* out, int B, int N, double huber_a, int iterations,
               cudaStream_t stream) {
  if (B < 1 || N < 1 || iterations < 0) return cudaErrorInvalidValue;
  pnp_solve_kernel<T><<<B, kThreads, 0, stream>>>(pts, obs, mask, K, init_t, init_q, out, N,
                                                  huber_a, iterations);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pnp_solve_f32(const float* pts, const float* obs, const float* mask, const float* K,
                  const float* init_t, const float* init_q, float* out, int B, int N,
                  double huber_a, int iterations, cudaStream_t stream) {
  return launch_pnp<float>(pts, obs, mask, K, init_t, init_q, out, B, N, huber_a, iterations,
                           stream);
}

int pnp_solve_f64(const double* pts, const double* obs, const double* mask, const double* K,
                  const double* init_t, const double* init_q, double* out, int B, int N,
                  double huber_a, int iterations, cudaStream_t stream) {
  return launch_pnp<double>(pts, obs, mask, K, init_t, init_q, out, B, N, huber_a, iterations,
                            stream);
}

// the threads of K13's CTA (ops/cuda_backend.py's PNP_THREADS)
int pnp_threads() { return kThreads; }

}  // extern "C"
