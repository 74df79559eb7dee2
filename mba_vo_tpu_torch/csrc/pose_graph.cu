// K14-K15: the backend's pose-graph LM iteration on the card, two launches
// an iteration and one flag read by the host.
//
// Replaces the body of the LM lax.while_loop in
// mba_vo_tpu/backend/pose_graph.py::optimize_pose_graph (:124-145, the loop
// :147, jitted as optimize_pose_graph_jit :151), which XLA compiles into one
// device program (no Pallas source). Bound in ops/cuda_backend.py
// (PGBinding); the plain versions are backend/pose_graph.py's
// pg_build_plain and pg_step_plain.
//
//   * K14 pg_build: each edge's residual r = log(T_m^-1 (T_i^-1 T_j)) and
//     its Jacobians J_i, J_j [6 x 6] in the closed form of
//     backend/ba.py::relative_pose_jacobians (node 0 gauged out: its J
//     times 0), weighted by sqrt(w); written straight into H's 6 x 6 blocks
//     H_ii += J_i^T J_i, H_jj += J_j^T J_j, H_ij = H_ji^T += J_i^T J_j and
//     into g_i += J_i^T r, g_j += J_j^T r (the dense [6E, 6N] Jacobian and
//     its product in backend/pose_graph.py's old build, and jax.jacfwd's in
//     the reference :100-111); and the cost at the current poses, which at
//     the loop's first iteration (the scalars' iteration count 0) becomes
//     the loop's initial cost;
//   * K15 pg_step: Hd = H + (lambda diag(H) + 1e-12) I + the gauge's
//     diagonal (1 on node 0's six entries), its Cholesky factor (right
//     looking; a pivot that is not > 0 gives a NaN step: Hd is symmetric
//     positive definite by construction), the step -Hd^-1 g times the
//     gauge, the candidate t + dt, q (x) exp(dw), its cost, ok = candidate
//     cost < cost and a finite step, rel = (cost - candidate) / max(cost,
//     1e-24), the select in place, lambda down or up within its clamps, the
//     iteration count and done = ok and rel < min_rel_decrease. A launch on
//     a state already done changes nothing (the reference's while_loop
//     stops there).
//
// What bounds them: latency. At the loop benchmark's chain (N = 64 nodes,
// E = 65 edges) H is 384 x 384 (1.18 MB in float64); K14 writes it once
// and K15 reads it once and factors it, D^3 / 6 ~ 9.4 M multiply-adds in
// 384 dependent pivots (a square root, a division and a barrier each),
// then 384 dependent steps of back-substitution.
//
// Design: K14, one CTA of 256 threads a block row a of H: thread 0 lists,
// in edge order, the edges that touch node a (a chunk of at most 64 at a
// time); one thread an edge of the chunk computes its weighted Jacobians
// and residual into shared memory; then one thread an entry of the block
// row (6 rows of H's 6N columns and of g) adds the chunk's terms in edge
// order. CTA 0's first warp also computes the cost. K15, one CTA of 512
// threads: Hd's lower triangle and g, as row D, into a global scratch
// [(D + 1), D] (the system is larger than shared memory), factored in
// place pivot by pivot (column j scaled by its pivot's square root and
// copied to shared memory, then a warp a row updates the trailing triangle,
// the forward sweep falling out as row D), the back-substitution in shared
// memory, the candidate poses in shared memory, the cost and the decision.
// A cooperative or blocked factorisation is later work.
//
// Orders: every sum has one fixed order (no floating-point atomics), so a
// run repeats bit for bit. An entry of H sums its edges in edge order, each
// edge's term the six products of a Jacobian column pair added left to
// right; the cost is lane l's edges l, l + 32, ... in order, each edge's
// (w r_k) r_k summed over k, then lane 0's butterfly of shuffles, the same
// function in K14 and K15, so that the cost K14 writes at the first
// iteration and K15's candidate costs are one function of the poses. The
// Cholesky updates each entry once a pivot, in pivot order (a rounded
// product, then a rounded difference) and divides by the pivot's square
// root; the back-substitution takes each unknown in descending order
// (experiments/backend_kernels.py::pg_cholesky_solve_ordered writes this
// order out in torch). The plain version solves by LU (torch.linalg.solve_ex),
// so the two agree within the solve's roundoff, not bit for bit.
//
// An edge whose node index lies outside [0, N) has a NaN residual and
// touches no block: the cost is NaN and every step is rejected.

#include <cuda_runtime.h>
#include <math.h>

#include "pose_geometry.cuh"
#include "spline_pose.cuh"

namespace {

using namespace geo;

// the state's scalars (ops/cuda_backend.py's G_* constants)
enum { G_COST = 0, G_LAM, G_IT, G_DONE, G_CAND_COST, G_OK, G_REL, G_BUILD_COST, G_SIZE };

constexpr int kBuildThreads = 256;
constexpr int kStepThreads = 512;
constexpr int kWarp = 32;
constexpr int kChunk = 64;          // edges a CTA of K14 stages at once
constexpr int kEdgeVals = 78;       // an edge's J_i, J_j [6 x 6] and r [6], weighted

// The graph's constant inputs
template <typename T>
struct Edges {
  const long long* i;
  const long long* j;
  const T* t;        // [E, 3] measured T_ij
  const T* q;        // [E, 4]
  const T* w;        // [E]
  int E, N;
};

template <typename T>
__device__ __forceinline__ bool valid(const Edges<T>& ed, int e) {
  return ed.i[e] >= 0 && ed.i[e] < ed.N && ed.j[e] >= 0 && ed.j[e] < ed.N;
}

// backend/pose_graph.py's _cost at the poses (node n's t at t + ts n, its q
// at q + qs n) by the first warp: 0.5 sum_e sum_k (w_e r_k) r_k /
// max(sum_e w_e, 1e-12), every lane the same value
template <typename T>
__device__ T warp_cost(const Edges<T>& ed, const T* t, int ts, const T* q, int qs) {
  const int lane = threadIdx.x % kWarp;
  T s = T(0), ws = T(0);
  for (int e = lane; e < ed.E; e += kWarp) {
    T r[6];
    if (valid(ed, e)) {
      EdgeParts<T> p;
      const int a = int(ed.i[e]), b = int(ed.j[e]);
      const T *ta = t + ts * a, *tb = t + ts * b, *qa = q + qs * a, *qb = q + qs * b;
      edge_residual(V3<T>{ta[0], ta[1], ta[2]}, Quat<T>{qa[0], qa[1], qa[2], qa[3]},
                    V3<T>{tb[0], tb[1], tb[2]}, Quat<T>{qb[0], qb[1], qb[2], qb[3]},
                    load_v(ed.t, e), load_q(ed.q, e), r, p);
    } else {
      for (int k = 0; k < 6; ++k) r[k] = T(NAN);
    }
    T se = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) se = se + (ed.w[e] * r[k]) * r[k];
    s = s + se;
    ws = ws + ed.w[e];
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    s = s + __shfl_xor_sync(~0u, s, off);
    ws = ws + __shfl_xor_sync(~0u, ws, off);
  }
  return (T(0.5) * s) / clamp_min(ws, T(1e-12));
}

// ------------------------------------------------------------------ K14

template <typename T>
__global__ void __launch_bounds__(kBuildThreads)
    pg_build_kernel(const T* __restrict__ t, const T* __restrict__ q, T* __restrict__ scalars,
                    Edges<T> ed, T* __restrict__ H, T* __restrict__ g) {
  __shared__ T jac[kChunk * kEdgeVals];
  __shared__ int list[kChunk];
  __shared__ int s_cnt, s_next;
  const int a = blockIdx.x, tid = threadIdx.x, N = ed.N, D = 6 * N;
  const int entries = 6 * (D + 1);   // 6 rows of H's D columns, then g
  int next = 0;
  bool first = true;
  do {
    if (tid == 0) {
      int cnt = 0, e = next;
      for (; e < ed.E && cnt < kChunk; ++e)
        if (valid(ed, e) && (ed.i[e] == a || ed.j[e] == a)) list[cnt++] = e;
      s_cnt = cnt;
      s_next = e;
    }
    __syncthreads();
    const int cnt = s_cnt;
    next = s_next;
    for (int u = tid; u < cnt; u += blockDim.x) {
      const int e = list[u];
      const int ni = int(ed.i[e]), nj = int(ed.j[e]);
      T r[6], Ji[36], Jj[36];
      edge_jacobians(load_v(t, ni), load_q(q, ni), load_v(t, nj), load_q(q, nj),
                     load_v(ed.t, e), load_q(ed.q, e), r, Ji, Jj);
      const T sw = sqrt(ed.w[e]);
      const T gi = ni == 0 ? T(0) : T(1), gj = nj == 0 ? T(0) : T(1);
      T* s = jac + kEdgeVals * u;
#pragma unroll
      for (int k = 0; k < 36; ++k) {
        s[k] = (Ji[k] * gi) * sw;
        s[36 + k] = (Jj[k] * gj) * sw;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) s[72 + k] = r[k] * sw;
    }
    __syncthreads();
    for (int x = tid; x < entries; x += blockDim.x) {
      const int k = x / (D + 1), c = x - k * (D + 1);
      T* dst = c < D ? H + size_t(6 * a + k) * D + c : g + 6 * a + k;
      T acc = first ? T(0) : *dst;
      const int node = c / 6, l = c - 6 * node;
      for (int u = 0; u < cnt; ++u) {
        const int e = list[u];
        const int ni = int(ed.i[e]), nj = int(ed.j[e]);
        const T* s = jac + kEdgeVals * u;
        const T* Ja = ni == a ? s : s + 36;         // this row's node's J [6 x 6]
        const int other = ni == a ? nj : ni;
        const T* Jc;
        if (c == D) {
          Jc = s + 72;                               // g's column: r
        } else if (node == a) {
          Jc = Ja + l;
        } else if (node == other) {
          Jc = (ni == a ? s + 36 : s) + l;
        } else {
          continue;
        }
        const int stride = c == D ? 1 : 6;
        T term = Ja[k] * Jc[0];
#pragma unroll
        for (int m = 1; m < 6; ++m) term = term + Ja[6 * m + k] * Jc[stride * m];
        acc = acc + term;
      }
      *dst = acc;
    }
    first = false;
    __syncthreads();   // the chunk's Jacobians read before the next chunk's
  } while (next < ed.E);

  if (a == 0 && tid < kWarp) {
    const T cost = warp_cost(ed, t, 3, q, 4);
    if (tid == 0) {
      scalars[G_BUILD_COST] = cost;
      if (scalars[G_IT] == T(0)) scalars[G_COST] = cost;
    }
  }
}

// ------------------------------------------------------------------ K15

struct StepOptions {
  double lambda_up, lambda_down, min_lambda, max_lambda, min_rel_decrease;
};

// shared memory (elements of T): z [D], x [D], column j [D + 1], the
// candidate poses [N, 7]
__host__ __device__ inline size_t step_smem_elems(int N) {
  return size_t(6 * N) * 3 + 1 + size_t(7) * N;
}

template <typename T>
__global__ void __launch_bounds__(kStepThreads)
    pg_step_kernel(T* __restrict__ t, T* __restrict__ q, T* __restrict__ scalars, Edges<T> ed,
                   const T* __restrict__ H, const T* __restrict__ g, T* __restrict__ A,
                   StepOptions o) {
  extern __shared__ unsigned char smem_raw[];
  T* zs = reinterpret_cast<T*>(smem_raw);
  const int N = ed.N, D = 6 * N;
  T* xs = zs + D;
  T* col = xs + D;
  T* cand = col + D + 1;   // [N, 7]: t, q
  __shared__ int s_fail;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid % kWarp, warp = tid / kWarp, warps = nth / kWarp;
  if (scalars[G_DONE] != T(0)) return;   // a done state changes nothing
  const T lam = scalars[G_LAM];

  // 1. Hd's lower triangle, g as row D
  for (size_t x = tid; x < size_t(D) * D; x += nth) {
    const int r = int(x / D), c = int(x - size_t(r) * D);
    if (c > r) continue;
    const T v = lam * H[size_t(c) * D + c] + T(1e-12);
    const T eye = r == c ? T(1) : T(0);
    const T gauge = (r == c && r < 6) ? T(1) : T(0);
    A[x] = (H[x] + v * eye) + gauge;
  }
  for (int c = tid; c < D; c += nth) A[size_t(D) * D + c] = g[c];
  if (tid == 0) s_fail = 0;
  __syncthreads();

  // 2. the right-looking Cholesky, rows 0..D (row D the forward sweep)
  for (int j = 0; j < D; ++j) {
    const T d = A[size_t(j) * D + j];
    if (!(d > T(0))) {
      if (tid == 0) s_fail = 1;
      break;   // every thread read the same pivot
    }
    const T s = sqrt(d);
    for (int i = j + 1 + tid; i <= D; i += nth) {
      const T v = A[size_t(i) * D + j] / s;
      A[size_t(i) * D + j] = v;
      col[i] = v;
    }
    if (tid == 0) A[size_t(j) * D + j] = s;
    __syncthreads();
    for (int i = j + 1 + warp; i <= D; i += warps) {
      const T ci = col[i];
      const int last = i < D ? i : D - 1;
      T* row = A + size_t(i) * D;
      for (int k = j + 1 + lane; k <= last; k += kWarp) row[k] = row[k] - ci * col[k];
    }
    __syncthreads();
  }
  __syncthreads();
  const bool fail = s_fail != 0;

  // 3. the back-substitution L^T x = z, each unknown in descending order
  if (!fail) {
    for (int c = tid; c < D; c += nth) zs[c] = A[size_t(D) * D + c];
    __syncthreads();
    for (int j = D - 1; j >= 0; --j) {
      const T xj = zs[j] / A[size_t(j) * D + j];
      if (tid == 0) xs[j] = xj;
      const T* row = A + size_t(j) * D;
      for (int i = tid; i < j; i += nth) zs[i] = zs[i] - row[i] * xj;
      __syncthreads();
    }
  }

  // 4. the step times the gauge, the candidate poses
  bool finite = true;
  for (int n = tid; n < N; n += nth) {
    const T gn = n == 0 ? T(0) : T(1);
    T d[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      d[k] = (-(fail ? T(NAN) : xs[6 * n + k])) * gn;
      finite = finite && isfinite(d[k]);
    }
    const Quat<T> e = spline::quat_exp(V3<T>{d[3], d[4], d[5]}, small_threshold<T>());
    const Quat<T> cq = spline::qmul(load_q(q, n), e);
    T* cp = cand + 7 * n;
    cp[0] = t[3 * n] + d[0];
    cp[1] = t[3 * n + 1] + d[1];
    cp[2] = t[3 * n + 2] + d[2];
    cp[3] = cq.x;
    cp[4] = cq.y;
    cp[5] = cq.z;
    cp[6] = cq.w;
  }
  finite = __syncthreads_and(finite) != 0;

  // 5. the candidate's cost, the decision, the select in place
  __shared__ T s_ok;
  if (warp == 0) {
    const T cc = warp_cost(ed, cand, 7, cand + 3, 7);
    if (tid == 0) {
      const T cost = scalars[G_COST];
      const bool ok = cc < cost && finite;
      const T rel = (cost - cc) / clamp_min(cost, T(1e-24));
      const T l_ok = clamp_min(lam * T(o.lambda_down), T(o.min_lambda));
      const T l_no = clamp_max(lam * T(o.lambda_up), T(o.max_lambda));
      scalars[G_CAND_COST] = cc;
      scalars[G_OK] = ok ? T(1) : T(0);
      scalars[G_REL] = rel;
      scalars[G_LAM] = ok ? l_ok : l_no;
      scalars[G_DONE] = (ok && rel < T(o.min_rel_decrease)) ? T(1) : T(0);
      scalars[G_COST] = ok ? cc : cost;
      scalars[G_IT] = scalars[G_IT] + T(1);
      s_ok = ok ? T(1) : T(0);
    }
  }
  __syncthreads();
  if (s_ok != T(0))
    for (int x = tid; x < 7 * N; x += nth) {
      const int n = x / 7, k = x - 7 * n;
      if (k < 3)
        t[3 * n + k] = cand[x];
      else
        q[4 * n + k - 3] = cand[x];
    }
}

template <typename T>
int launch_build(const T* t, const T* q, T* scalars, const long long* ei, const long long* ej,
                 const T* et, const T* eq, const T* ew, T* H, T* g, int N, int E,
                 cudaStream_t stream) {
  if (N < 1 || E < 0) return cudaErrorInvalidValue;
  pg_build_kernel<T><<<N, kBuildThreads, 0, stream>>>(t, q, scalars,
                                                      Edges<T>{ei, ej, et, eq, ew, E, N}, H, g);
  return cudaGetLastError();
}

template <typename T>
int launch_step(T* t, T* q, T* scalars, const long long* ei, const long long* ej, const T* et,
                const T* eq, const T* ew, const T* H, const T* g, T* A, int N, int E,
                double lambda_up, double lambda_down, double min_lambda, double max_lambda,
                double min_rel_decrease, long long smem, cudaStream_t stream) {
  // the wrapper's shared memory (ops/cuda_backend.py's step_smem_bytes)
  if (N < 1 || E < 0 || size_t(smem) != step_smem_elems(N) * sizeof(T))
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pg_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  pg_step_kernel<T><<<1, kStepThreads, size_t(smem), stream>>>(
      t, q, scalars, Edges<T>{ei, ej, et, eq, ew, E, N}, H, g, A,
      StepOptions{lambda_up, lambda_down, min_lambda, max_lambda, min_rel_decrease});
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pg_build_f32(const float* t, const float* q, float* scalars, const long long* ei,
                 const long long* ej, const float* et, const float* eq, const float* ew,
                 float* H, float* g, int N, int E, cudaStream_t stream) {
  return launch_build<float>(t, q, scalars, ei, ej, et, eq, ew, H, g, N, E, stream);
}

int pg_build_f64(const double* t, const double* q, double* scalars, const long long* ei,
                 const long long* ej, const double* et, const double* eq, const double* ew,
                 double* H, double* g, int N, int E, cudaStream_t stream) {
  return launch_build<double>(t, q, scalars, ei, ej, et, eq, ew, H, g, N, E, stream);
}

int pg_step_f32(float* t, float* q, float* scalars, const long long* ei, const long long* ej,
                const float* et, const float* eq, const float* ew, const float* H,
                const float* g, float* A, int N, int E, double lambda_up, double lambda_down,
                double min_lambda, double max_lambda, double min_rel_decrease, long long smem,
                cudaStream_t stream) {
  return launch_step<float>(t, q, scalars, ei, ej, et, eq, ew, H, g, A, N, E, lambda_up,
                            lambda_down, min_lambda, max_lambda, min_rel_decrease, smem, stream);
}

int pg_step_f64(double* t, double* q, double* scalars, const long long* ei,
                const long long* ej, const double* et, const double* eq, const double* ew,
                const double* H, const double* g, double* A, int N, int E, double lambda_up,
                double lambda_down, double min_lambda, double max_lambda,
                double min_rel_decrease, long long smem, cudaStream_t stream) {
  return launch_step<double>(t, q, scalars, ei, ej, et, eq, ew, H, g, A, N, E, lambda_up,
                             lambda_down, min_lambda, max_lambda, min_rel_decrease, smem,
                             stream);
}

// the scalars' count (ops/cuda_backend.py's G_SIZE) and K15's shared memory
int pg_scalars_size() { return G_SIZE; }

long long pg_step_smem_bytes(int N, int itemsize) {
  return (long long)(step_smem_elems(N) * size_t(itemsize));
}

}  // extern "C"
