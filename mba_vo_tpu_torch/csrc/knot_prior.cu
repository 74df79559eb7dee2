// K9: the joint path's knot prior on the card, in one launch of one CTA.
//
// Replaces the stage XLA fuses in mba_vo_tpu/solver/lm.py's jitted level:
// _prior_terms (:253-268, jax.linearize of _knot_prior_residual :244-250
// through spline_retract_flat, vmapped over the 6K seeds), fused at
// :308-314; no Pallas source. Bound in ops/cuda_lm.py (knot_prior_cuda, and
// CommitBinding.knot_prior, which writes into the level's buffers that K8
// reads); the plain version is solver/lm.py's knot_prior_plain
// (_prior_terms), the same closed form in the same order.
//
// What it computes, at K >= 3 knots t [K, 3], q [K, 4] (xyzw), D = 6K: the
// constant-velocity violation p (the second differences d2t_j = t_j+2 -
// 2 t_j+1 + t_j and d2w_j = w_j+1 - w_j of the relative-rotation logs w_k =
// log(q_k* q_k+1), j < K - 2) linearised through the retraction t + dt,
// q exp(omega) at zero, the step laid out [all t; all omega]: with R_k =
// R(q_k* q_k+1) and N_k = Jr^-1(w_k) = I + [w]x / 2 + c(theta) [w]x^2,
// d2w_j's Jacobian is M_j = N_j R_j^T on knot j's omega, -M_j+1 - N_j on
// knot j+1's and N_j+1 on knot j+2's; d2t_j's is [1, -2, 1] on the knots'
// t; the t-omega blocks are zero. Out: cost = weight |p|^2 / 2 [], g =
// weight J^T p [D], H = weight J^T J [D, D].
//
// What bounds it: latency. It reads 7K values and writes 1 + D + D^2 (7.4
// KB at K = 7 in float32: 2.2 ns at 3.35 TB/s) and does a few tens of
// thousands of operations; the time is the launch and the chain of one
// knot pair's arithmetic (a quaternion product, its log, sin, cos and
// square roots).
//
// Design: one CTA of 512 threads. (1) Every thread zeroes its share of H
// (the entries off the prior's band stay 0) and each thread of the first
// batch takes a knot pair k (strided past 512): it loads q_k and q_k+1 and
// writes w_k, N_k and M_k, 21 values, to shared memory, while the block
// stages t there. (2) After a barrier the threads write each prior block's
// three 3 x 3 Jacobian blocks (27 P values, -M_j+1 - N_j formed once) and
// the residual p (6 P) to shared memory, so that no entry below branches
// on which block it reads. (3) After a second barrier a thread a slot
// computes the entries a prior block can touch (knots at most 2 apart:
// 45 omega-omega and 15 t-t slots a knot, 462 at K = 7, under one a
// thread) and g's D entries: an entry sums the <= 3 prior blocks that
// touch both its knots, in ascending block order, each block's term a dot
// product over the block's 3 rows summed left to right, then times the
// weight; the t-t entries are weight times the integer sums of [1, -2, 1]
// products. Forming the blocks in each entry of all D^2, a branch on the
// block per load, took 7.6 us at K = 7 on an H100 (PERF.md section 6).
// (4) Warp 0 sums the squared residuals, lane l the entries l, l + 32,
// ... in order, then a butterfly of shuffles (lane 0's bits are a tree
// over the lanes), and lane 0 writes the cost.
//
// Bits: every operation rounds once, as the plain version's torch ops do
// on the card (this source builds with -fmad=false, ops/cuda_build.py):
// the quaternion product and log are spline_pose.cuh's (qmul, and
// quat_log_jvp's primal), a tensor over a Python float is a product with
// the float's reciprocal, as the card's torch computes it (the Taylor
// form of c: / 720 and / 30240). The card's checks hold K9 to the plain
// version bit for bit where the transcendentals (sin, cos, atan2) round
// as torch's do, and within 1e-13 (float64) / 1e-6 (float32) of each
// output's magnitude where not.

#include <cuda_runtime.h>
#include <math.h>

#include "spline_pose.cuh"

namespace {

using spline::Quat;
using spline::V3;

constexpr int kThreads = 512;
constexpr int kWarp = 32;

// the second difference's coefficients on knots j, j + 1, j + 2
__device__ __forceinline__ int second(int m) { return m == 1 ? -2 : 1; }

// row i, column r of d2w_j's Jacobian on knot j + m's omega (m = 0, 1, 2),
// from the pairs' N and M [K - 1, 3, 3] in shared memory
template <typename T>
__device__ __forceinline__ T block(const T* M, const T* N, int j, int m, int i, int r) {
  const int e = 3 * i + r;
  if (m == 0) return M[9 * j + e];
  if (m == 1) return -M[9 * (j + 1) + e] - N[9 * j + e];
  return N[9 * (j + 1) + e];
}

// d2t_j's component s, d2w_j's component i, from t and the logs in shared
// memory
template <typename T>
__device__ __forceinline__ T d2t(const T* ts, int j, int s) {
  return (ts[3 * (j + 2) + s] - T(2) * ts[3 * (j + 1) + s]) + ts[3 * j + s];
}

template <typename T>
__device__ __forceinline__ T d2w(const T* ws, int j, int i) {
  return ws[3 * (j + 1) + i] - ws[3 * j + i];
}

// knot pair k: w = log(q_k* q_k+1), N = Jr^-1(w) and M = N R^T, as
// solver/lm.py's _prior_terms and _right_jacobian_inverse compute them
template <typename T>
__device__ __forceinline__ void knot_pair(const T* q, int k, T* w_out, T* N_out, T* M_out) {
  const Quat<T> qa{q[4 * k], q[4 * k + 1], q[4 * k + 2], q[4 * k + 3]};
  const Quat<T> qb{q[4 * k + 4], q[4 * k + 5], q[4 * k + 6], q[4 * k + 7]};
  const Quat<T> qr = spline::qmul(spline::qconj(qa), qb);
  const T thr_log = sizeof(T) >= 8 ? T(1e-20) : T(1e-10);
  V3<T> w, dw;
  spline::quat_log_jvp(qr, Quat<T>{T(0), T(0), T(0), T(0)}, thr_log, w, dw);
  // c(theta) = (1 - (theta/2) cot(theta/2)) / theta^2, its Taylor form below
  // theta^2 = 1e-4 (float64) or 1e-2 (float32)
  const T th2 = (w.x * w.x + w.y * w.y) + w.z * w.z;
  const bool small = th2 < (sizeof(T) >= 8 ? T(1e-4) : T(1e-2));
  const T th2s = small ? T(1) : th2;
  const T h = T(0.5) * sqrt(th2s);
  const T cot = cos(h) / sin(h);
  const T c = small ? (T(1.0 / 12.0) + th2 * (T(1) / T(720))) + (th2 * th2) * (T(1) / T(30240))
                    : (T(1) - h * cot) / th2s;
  const T h0 = T(0.5) * w.x, h1 = T(0.5) * w.y, h2 = T(0.5) * w.z;
  const T x01 = c * (w.x * w.y), x02 = c * (w.x * w.z), x12 = c * (w.y * w.z);
  T N[9];
  N[0] = T(1) - c * (w.y * w.y + w.z * w.z);
  N[1] = -h2 + x01;
  N[2] = h1 + x02;
  N[3] = h2 + x01;
  N[4] = T(1) - c * (w.x * w.x + w.z * w.z);
  N[5] = -h0 + x12;
  N[6] = -h1 + x02;
  N[7] = h0 + x12;
  N[8] = T(1) - c * (w.x * w.x + w.y * w.y);
  // R(q_rel), core/lie.py's quat_to_matrix
  const T xx = qr.x * qr.x, yy = qr.y * qr.y, zz = qr.z * qr.z;
  const T xy = qr.x * qr.y, xz = qr.x * qr.z, yz = qr.y * qr.z;
  const T wx = qr.w * qr.x, wy = qr.w * qr.y, wz = qr.w * qr.z;
  const T R[9] = {T(1) - T(2) * (yy + zz), T(2) * (xy - wz), T(2) * (xz + wy),
                  T(2) * (xy + wz), T(1) - T(2) * (xx + zz), T(2) * (yz - wx),
                  T(2) * (xz - wy), T(2) * (yz + wx), T(1) - T(2) * (xx + yy)};
  w_out[0] = w.x;
  w_out[1] = w.y;
  w_out[2] = w.z;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      N_out[3 * i + r] = N[3 * i + r];
      M_out[3 * i + r] = (N[3 * i] * R[3 * r] + N[3 * i + 1] * R[3 * r + 1]) +
                         N[3 * i + 2] * R[3 * r + 2];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    knot_prior_kernel(const T* __restrict__ t, const T* __restrict__ q, T* __restrict__ cost,
                      T* __restrict__ g, T* __restrict__ H, int K, T weight, T half_weight) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = K - 2;          // prior blocks
  const int K3 = 3 * K, D = 6 * K, P3 = 3 * P;
  T* ts = reinterpret_cast<T*>(smem_raw);   // [K, 3]
  T* ws = ts + K3;                          // [K - 1, 3]
  T* Ns = ws + 3 * (K - 1);                 // [K - 1, 3, 3]
  T* Ms = Ns + 9 * (K - 1);                 // [K - 1, 3, 3]
  T* Bs = Ms + 9 * (K - 1);                 // [P, 3 (m), 3 (i), 3 (r)]
  T* ps = Bs + 27 * P;                      // [2, P, 3]: all d2t, then all d2w
  const int tid = threadIdx.x;

  // 1. H zeroed (every entry off the prior's band stays 0, as the weight
  // times 0: the weight is positive), the knot pairs and the translations
  // into shared memory
  const int DD = D * D;
  for (int e = tid; e < DD; e += blockDim.x) H[e] = T(0);
  for (int k = tid; k < K - 1; k += blockDim.x)
    knot_pair(q, k, ws + 3 * k, Ns + 9 * k, Ms + 9 * k);
  for (int e = tid; e < K3; e += blockDim.x) ts[e] = t[e];
  __syncthreads();

  // 2. the prior blocks and the residual, once each
  for (int e = tid; e < 27 * P + 2 * P3; e += blockDim.x) {
    if (e < 27 * P) {
      const int j = e / 27, m = (e - 27 * j) / 9, ir = e - 27 * j - 9 * m;
      Bs[e] = block(Ms, Ns, j, m, ir / 3, ir - 3 * (ir / 3));
    } else {
      const int l = e - 27 * P;
      ps[l] = l < P3 ? d2t(ts, l / 3, l - 3 * (l / 3))
                     : d2w(ws, (l - P3) / 3, (l - P3) - 3 * ((l - P3) / 3));
    }
  }
  __syncthreads();

  // 3. H's band, then g: a slot for each entry that a prior block can
  // touch, knots a and b = a + d - 2 (d < 5), omega-omega (45 a knot:
  // (d, r, s)), then t-t on the diagonal of each 3 x 3 block (15 a knot:
  // (d, r)), then g's D entries
  const int n_ww = 45 * K, n_tt = 15 * K;
  for (int e = tid; e < n_ww + n_tt + D; e += blockDim.x) {
    T acc = T(0);
    if (e < n_ww) {
      const int a = e / 45, d = (e - 45 * a) / 9, rs = e - 45 * a - 9 * d;
      const int r = rs / 3, s = rs - 3 * r, b = a + d - 2;
      if (b < 0 || b >= K) continue;
      const int lo = max(max(a, b) - 2, 0), hi = min(min(a, b), P - 1);
      for (int j = lo; j <= hi; ++j) {
        const T* x = Bs + 27 * j + 9 * (a - j) + r;
        const T* y = Bs + 27 * j + 9 * (b - j) + s;
        acc = acc + ((x[0] * y[0] + x[3] * y[3]) + x[6] * y[6]);
      }
      H[(K3 + 3 * a + r) * D + K3 + 3 * b + s] = weight * acc;
    } else if (e < n_ww + n_tt) {
      const int f = e - n_ww, a = f / 15, d = (f - 15 * a) / 3, r = f - 15 * a - 3 * d;
      const int b = a + d - 2;
      if (b < 0 || b >= K) continue;
      const int lo = max(max(a, b) - 2, 0), hi = min(min(a, b), P - 1);
      for (int j = lo; j <= hi; ++j) acc = acc + T(second(a - j) * second(b - j));
      H[(3 * a + r) * D + 3 * b + r] = weight * acc;
    } else {
      const int gamma = e - n_ww - n_tt;
      const bool tg = gamma < K3;
      const int u = tg ? gamma : gamma - K3;
      const int k = u / 3, s = u - 3 * k;
      const int lo = max(k - 2, 0), hi = min(k, P - 1);
      for (int j = lo; j <= hi; ++j) {
        if (tg) {
          acc = acc + T(second(k - j)) * ps[3 * j + s];
        } else {
          const T* x = Bs + 27 * j + 9 * (k - j) + s;
          const T* dw = ps + P3 + 3 * j;
          acc = acc + ((x[0] * dw[0] + x[3] * dw[1]) + x[6] * dw[2]);
        }
      }
      g[gamma] = weight * acc;
    }
  }

  // 4. the cost: warp 0, lane l over the residuals l, l + 32, ..., then a
  // butterfly
  if (tid < kWarp) {
    T sum = T(0);
    for (int l = tid; l < 2 * P3; l += kWarp) sum = sum + ps[l] * ps[l];
#pragma unroll
    for (int s = kWarp / 2; s > 0; s >>= 1) sum = sum + __shfl_xor_sync(0xffffffffu, sum, s);
    if (tid == 0) *cost = sum * half_weight;
  }
}

template <typename T>
int launch_prior(const T* t, const T* q, T* cost, T* g, T* H, int K, double weight, int smem,
                 cudaStream_t stream) {
  // the wrapper's layout (ops/cuda_lm.py's prior_smem_bytes) against the kernel's
  if (K < 3 ||
      size_t(smem) != (size_t(3) * K + size_t(21) * (K - 1) + size_t(33) * (K - 2)) * sizeof(T))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knot_prior_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  // the weight as torch takes a Python float: cast to T, and 0.5 * weight
  // (exact in double) cast to T
  knot_prior_kernel<T><<<1, kThreads, smem, stream>>>(t, q, cost, g, H, K, T(weight),
                                                     T(0.5 * weight));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int knot_prior_f32(const float* t, const float* q, float* cost, float* g, float* H, int K,
                   double weight, int smem, cudaStream_t stream) {
  return launch_prior<float>(t, q, cost, g, H, K, weight, smem, stream);
}

int knot_prior_f64(const double* t, const double* q, double* cost, double* g, double* H, int K,
                   double weight, int smem, cudaStream_t stream) {
  return launch_prior<double>(t, q, cost, g, H, K, weight, smem, stream);
}

}  // extern "C"
