// K5: the tracker's patch layout for Hopper (sm_90a), which every path runs
// once an LM evaluation.
//
// Replaces the XLA fusion of mba_vo_tpu/ops/residual.py::prepare_frame_layout
// (:348-378, with patch_anchors :158-190, patch_pixel_grid :192-199,
// _current_intensity :250-255 and ops/image.py::in_bounds :96-100): no
// Pallas source, XLA fused it on the TPU. The port ran it as ~150 eager
// torch ops an evaluation at degree 2 (~300 at degree 4 over four frames),
// most of them the virtual poses of sample_virtual_poses, of which the
// layout needs one a frame.
//
// For each frame f it computes the mid-exposure pose v = V / 2 from the
// spline knots (core/spline.py's virtual_pose_times, the segment clamp, the
// bases and the quaternion chain), projects every keypoint n through it
// into the frame (the anchor), and for every pattern pixel p writes
//   pix[f, n, p]   = floor(anchor) + pattern[p]   (float, the knots' type)
//   valid[f, n, p] = pix in [0, W-1] x [0, H-1] and kp_mask[n] > 0
//   obs[f, n, p]   = cur_imgs[f] at pix, its indices clamped into the image
// and, where asked (a check, not the tracker's), the anchors [F, N, 2].
//
// Design: one launch. A CTA takes one frame (blockIdx.y) and a block of
// (keypoint, pattern pixel) pairs. Its first degree - 1 threads each compute
// one segment's exp of the mid pose's rotation chain (a chain of divisions,
// an atan2, a sin and a cos), thread 0 multiplies them and sums the
// translation; the pose's inverse goes to shared memory while the other
// threads load their keypoint. Then one thread a (n, p) runs the rest of
// patch_anchors in the plain version's order: the back-projection, the
// rotation by the conjugate quaternion (quat_rotate's two cross products),
// the two divisions, floor, the pattern, the mask and the doubly clamped
// gather of cur_imgs.
//
// What bounds it on the card: latency. It moves the knots, N keypoints, the
// F N P pixels of cur_imgs its patches read and F N P (2 itemsize + 1 +
// itemsize) output bytes, ~53 kB at the frame in f32 (0.02 us at 3.35
// TB/s); the pose's chain of transcendentals runs before any write.
//
// Bits: pix selects the pixels, and from a standing start the anchors are
// integers up to the last bit, so one ulp in an anchor picks another pixel.
// The layout therefore equals the plain version (ops/residual.py's
// prepare_frame_layout_plain) run on the card bit for bit: the build
// compiles this file with -fmad=false, every operation is the plain
// version's, each rounded once, and each sum runs in the order torch runs
// it on the card (spline_pose.cuh's einsum_tap_sum for the translation).
// The exposure times divide as torch divides a tensor by a Python float on
// the card: a product with the divisor's reciprocal, rounded in the knots'
// type. Both orders were measured by experiments/pose_order.py.
// NaN knots give NaN anchors, pixels and poses where they reach; such a
// pixel is not valid, and its gather index is torch's cast of the clamped
// NaN. The kernel allocates nothing and does not synchronise; the C entry
// points return the CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spline_pose.cuh"

namespace {

using namespace spline;

constexpr int kThreads = 256;

// The mid-exposure pose of frame f, inverted (q_r2c = conj(q), t_r2c =
// -rotate(q_r2c, t)), into s_inv[0..6] = (t_r2c, q_r2c). s_exp holds the
// segments' exps (degree - 1 of them).
template <typename T, int degree>
__device__ void mid_pose_inverse(const T* __restrict__ knot_t, const T* __restrict__ knot_q,
                                 int K, T t0, T dt, T c, T e, int V, T* s_inv, T* s_exp) {
  const T thr = sizeof(T) >= 8 ? T(1e-20) : T(1e-10);   // core/lie.py::_small_threshold
  // core/spline.py::virtual_pose_times at v = V // 2: c - 0.5 e + v e / div,
  // the division by the Python float div a product with its reciprocal
  const T inv_div = T(1) / T((double)(V - 1) + 1e-8);
  const T tau = (c - T(0.5) * e) + (T(V / 2) * e) * inv_div;
  T wv[degree], wc[degree - 1];
  const int idx = spline_segment<T, degree>(tau, t0, dt, K, wv, wc);
  auto knot = [&](int j) {
    const T* k = knot_q + (idx + j) * 4;
    return Quat<T>{k[0], k[1], k[2], k[3]};
  };
  const int j = threadIdx.x;
  if (j < degree - 1) {
    const Quat<T> ex = segment_exp(knot(j), knot(j + 1), wc[j], thr);
    T* o = s_exp + 4 * j;
    o[0] = ex.x; o[1] = ex.y; o[2] = ex.z; o[3] = ex.w;
  }
  __syncthreads();
  if (j != 0) return;
  Quat<T> q = knot(0);
#pragma unroll
  for (int s = 0; s + 1 < degree; ++s) {
    const T* x = s_exp + 4 * s;
    q = qmul(q, Quat<T>{x[0], x[1], x[2], x[3]});
  }
  T t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    T x[degree];
#pragma unroll
    for (int i = 0; i < degree; ++i) x[i] = knot_t[(idx + i) * 3 + k];
    t[k] = einsum_tap_sum<T, degree>(wv, x);
  }
  // patch_anchors: q_r2c = quat_conjugate(q), t_r2c = -quat_rotate(q_r2c, t),
  // quat_rotate's two-cross-product form v + w (2 xyz x v) + xyz x (2 xyz x v)
  const Quat<T> qi = qconj(q);
  const V3<T> xyz = {qi.x, qi.y, qi.z};
  const V3<T> v = {t[0], t[1], t[2]};
  V3<T> u = cross(xyz, v);
  u = {T(2) * u.x, T(2) * u.y, T(2) * u.z};
  const V3<T> xu = cross(xyz, u);
  s_inv[0] = -((v.x + qi.w * u.x) + xu.x);
  s_inv[1] = -((v.y + qi.w * u.y) + xu.y);
  s_inv[2] = -((v.z + qi.w * u.z) + xu.z);
  s_inv[3] = qi.x;
  s_inv[4] = qi.y;
  s_inv[5] = qi.z;
  s_inv[6] = qi.w;
}

// torch.clamp of a float (a NaN passes through), then its cast to int64,
// then the int64 clamp: _current_intensity's index
template <typename T>
__device__ __forceinline__ long long gather_index(T x, int size) {
  const T c = isnan(x) ? x : fmin(fmax(x, T(-1)), T(size));
  long long i = (long long)c;
  return i < 0 ? 0 : (i > size - 1 ? size - 1 : i);
}

template <typename T, int degree>
__device__ void layout_body(const T* __restrict__ knot_t, const T* __restrict__ knot_q,
                            const T* __restrict__ t0p, const T* __restrict__ dtp,
                            const T* __restrict__ cap, const T* __restrict__ expo,
                            const T* __restrict__ kp_xy, const T* __restrict__ kp_z,
                            const T* __restrict__ kp_mask, const T* __restrict__ Kv,
                            const int32_t* __restrict__ pattern, const T* __restrict__ cur,
                            T* __restrict__ pix, uint8_t* __restrict__ valid,
                            T* __restrict__ obs, T* __restrict__ anchors, int K, int N, int F,
                            int P, int V, int H, int W, int Hc, int Wc, T* s_inv, T* s_exp) {
  const int f = blockIdx.y;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;   // n P + p
  const bool active = i < (long long)N * P;
  const int n = active ? (int)(i / P) : 0;
  const int p = active ? (int)(i - (long long)n * P) : 0;
  const T fx = Kv[0], fy = Kv[1], cx = Kv[2], cy = Kv[3];
  // the keypoint's back-projection P3dr, while the pose is computed
  T z = T(0), px = T(0), py = T(0), live = T(0);
  int ox = 0, oy = 0;
  if (active) {
    z = kp_z[n];
    px = (z * (kp_xy[2 * n] - cx)) / fx;
    py = (z * (kp_xy[2 * n + 1] - cy)) / fy;
    live = kp_mask[n];
    ox = pattern[2 * p];
    oy = pattern[2 * p + 1];
  }
  mid_pose_inverse<T, degree>(knot_t, knot_q, K, *t0p, *dtp, cap[f], expo[f], V, s_inv, s_exp);
  __syncthreads();
  if (!active) return;
  // P3dc = quat_rotate(q_r2c, P3dr) + t_r2c
  const V3<T> xyz = {s_inv[3], s_inv[4], s_inv[5]};
  const T w = s_inv[6];
  const V3<T> v = {px, py, z};
  V3<T> u = cross(xyz, v);
  u = {T(2) * u.x, T(2) * u.y, T(2) * u.z};
  const V3<T> xu = cross(xyz, u);
  const T Px = ((v.x + w * u.x) + xu.x) + s_inv[0];
  const T Py = ((v.y + w * u.y) + xu.y) + s_inv[1];
  const T Pz = ((v.z + w * u.z) + xu.z) + s_inv[2];
  const T ax = (Px / Pz) * fx + cx;
  const T ay = (Py / Pz) * fy + cy;
  const long long o = ((long long)f * N + n) * P + p;
  if (anchors != nullptr && p == 0) {
    const long long a = (long long)f * N + n;
    anchors[2 * a] = ax;
    anchors[2 * a + 1] = ay;
  }
  const T x = floor(ax) + T(ox);
  const T y = floor(ay) + T(oy);
  pix[2 * o] = x;
  pix[2 * o + 1] = y;
  valid[o] = (x >= T(0) && x <= T(W - 1) && y >= T(0) && y <= T(H - 1) && live > T(0)) ? 1 : 0;
  obs[o] = __ldg(cur + ((long long)f * Hc + gather_index(y, Hc)) * Wc + gather_index(x, Wc));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
frame_layout_kernel(const T* __restrict__ knot_t,    // [K, 3]
                    const T* __restrict__ knot_q,    // [K, 4]
                    const T* __restrict__ t0p,       // spline start time
                    const T* __restrict__ dtp,       // knot interval
                    const T* __restrict__ cap,       // [F] capture times
                    const T* __restrict__ expo,      // [F] exposure times
                    const T* __restrict__ kp_xy,     // [N, 2]
                    const T* __restrict__ kp_z,      // [N]
                    const T* __restrict__ kp_mask,   // [N]
                    const T* __restrict__ Kv,        // [4]
                    const int32_t* __restrict__ pattern,  // [P, 2]
                    const T* __restrict__ cur,       // [F, Hc, Wc]
                    T* __restrict__ pix,             // [F, N, P, 2]
                    uint8_t* __restrict__ valid,     // [F, N, P]
                    T* __restrict__ obs,             // [F, N, P]
                    T* __restrict__ anchors,         // [F, N, 2] or null
                    int K, int degree, int N, int F, int P, int V, int H, int W, int Hc,
                    int Wc) {
  // the frame's inverted mid pose (t_r2c, q_r2c) and its segments' exps
  __shared__ T s_inv[7];
  __shared__ T s_exp[4 * 3];
  if (degree == 2)
    layout_body<T, 2>(knot_t, knot_q, t0p, dtp, cap, expo, kp_xy, kp_z, kp_mask, Kv, pattern,
                      cur, pix, valid, obs, anchors, K, N, F, P, V, H, W, Hc, Wc, s_inv, s_exp);
  else
    layout_body<T, 4>(knot_t, knot_q, t0p, dtp, cap, expo, kp_xy, kp_z, kp_mask, Kv, pattern,
                      cur, pix, valid, obs, anchors, K, N, F, P, V, H, W, Hc, Wc, s_inv, s_exp);
}

template <typename T>
int launch_frame_layout(const void* knot_t, const void* knot_q, const void* t0, const void* dt,
                        const void* cap, const void* expo, const void* kp_xy, const void* kp_z,
                        const void* kp_mask, const void* Kv, const void* pattern,
                        const void* cur, void* pix, void* valid, void* obs, void* anchors,
                        int K, int degree, int N, int F, int P, int V, int H, int W, int Hc,
                        int Wc, void* stream) {
  if ((degree != 2 && degree != 4) || K < degree || N < 0 || F < 1 || F > 65535 || P < 1 ||
      V < 1 || H < 1 || W < 1 || Hc < 1 || Wc < 1 || (long long)N * P >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)(((long long)N * P + kThreads - 1) / kThreads), (unsigned)F);
  frame_layout_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)knot_t, (const T*)knot_q, (const T*)t0, (const T*)dt, (const T*)cap,
      (const T*)expo, (const T*)kp_xy, (const T*)kp_z, (const T*)kp_mask, (const T*)Kv,
      (const int32_t*)pattern, (const T*)cur, (T*)pix, (uint8_t*)valid, (T*)obs, (T*)anchors,
      K, degree, N, F, P, V, H, W, Hc, Wc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define LAYOUT_ARGS                                                                     \
  const void *knot_t, const void *knot_q, const void *t0, const void *dt, const void *cap, \
      const void *expo, const void *kp_xy, const void *kp_z, const void *kp_mask,          \
      const void *Kv, const void *pattern, const void *cur, void *pix, void *valid,        \
      void *obs, void *anchors, int K, int degree, int N, int F, int P, int V, int H,      \
      int W, int Hc, int Wc, void *stream
#define LAYOUT_PASS                                                                      \
  knot_t, knot_q, t0, dt, cap, expo, kp_xy, kp_z, kp_mask, Kv, pattern, cur, pix, valid, \
      obs, anchors, K, degree, N, F, P, V, H, W, Hc, Wc, stream

int frame_layout_f32(LAYOUT_ARGS) { return launch_frame_layout<float>(LAYOUT_PASS); }
int frame_layout_f64(LAYOUT_ARGS) { return launch_frame_layout<double>(LAYOUT_PASS); }

}  // extern "C"
