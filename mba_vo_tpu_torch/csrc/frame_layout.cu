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
// A CTA takes one frame (blockIdx.y) and a block of 256 (keypoint, pattern
// pixel) pairs, one thread a pair.
//
// What bounds it on the card: latency. It moves the knots, N keypoints, the
// F N P pixels of cur_imgs its patches read and F N P (2 itemsize + 1 +
// itemsize) output bytes, ~53 kB at the frame in f32 (0.02 us at 3.35
// TB/s); what it costs past one launch is its chain of dependent trips to
// memory and barriers, and the pose's chain of divisions and
// transcendentals, which runs before any write.
//
// Two designs, equal to the bit:
//   * frame_layout_kernel (the staged design, which the tracker launches):
//     one trip for every input. At entry warp 0 stages the knots' rotations
//     q [K, 4] into shared memory and warp 1 their translations t [K, 3]
//     (up to kLoads values a lane, loaded back to back, then stored: K <=
//     kMaxKnots, which the wrapper's layout function enforces,
//     ops/cuda_layout.py's layout_staging), both load t0, dt and the
//     frame's capture and exposure times, and every thread its keypoint,
//     pattern pixel and the intrinsics, all in the same trip. After a
//     __syncwarp each of the two warps finds the segment; warp 0's first
//     degree - 1 lanes run the segments' exps side by side and its lane 0
//     the quaternion chain, while warp 1's lane 0 sums the translation
//     (the two warps' work overlaps), each from shared memory only. One
//     barrier; then every thread inverts the pose (t_r2c = -rotate(q_r2c,
//     t), the same operations in each thread, so the same bits), projects
//     its keypoint, and gathers cur_imgs at its pixel: the second and last
//     trip.
//   * frame_layout_serial_kernel (the first design, the earlier one, a timed
//     row): every thread loads the times and finds the segment; only then
//     the segments' knots are loaded (by the first degree - 1 threads, who
//     run the exps), a barrier, thread 0 loads the translations and runs
//     the chain, the translation sum and the inverse one after another, a
//     barrier, then the projection and the gather: four dependent trips to
//     memory.
// Both designs run one copy of each step of the arithmetic (the helpers
// under "shared" below: the mid time, the rotation chain, the translation,
// the rotation, the pair's back-projection and its projection and gather);
// they differ only in where a step's inputs come from and which threads run
// it. The tracker launches the staged design: it is the faster warm on the
// tracker's recorded calls (PERF.md section 6).
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
// NaN. The kernels allocate nothing and do not synchronise; the C entry
// points return the CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "spline_pose.cuh"

namespace {

using namespace spline;

constexpr int kThreads = 256;
// the staged design: values a lane of warps 0 and 1 stages (warp 0 the 4 K
// rotation values, warp 1 the 3 K translation values), hence the most knots
constexpr int kLoads = 8;
constexpr int kMaxKnots = 32 * kLoads / 4;

// ---------------------------------------------------------------- shared
// The arithmetic both designs run, one copy of each step: the designs
// differ only in where the inputs come from and which threads run a step.

// core/spline.py::virtual_pose_times at v = V // 2: c - 0.5 e + v e / div,
// the division by the Python float div a product with its reciprocal
template <typename T>
__device__ __forceinline__ T mid_time(T c, T e, int V) {
  const T inv_div = T(1) / T((double)(V - 1) + 1e-8);
  return (c - T(0.5) * e) + (T(V / 2) * e) * inv_div;
}

// core/lie.py::_small_threshold
template <typename T>
__device__ __forceinline__ T small_threshold() {
  return sizeof(T) >= 8 ? T(1e-20) : T(1e-10);
}

// knot j of the rotations q [K, 4]
template <typename T>
__device__ __forceinline__ Quat<T> knot_quat(const T* q, int j) {
  const T* k = q + j * 4;
  return Quat<T>{k[0], k[1], k[2], k[3]};
}

// the segment's first knot times its segments' exps s_exp [degree - 1, 4],
// in order: the mid pose's rotation
template <typename T, int degree>
__device__ __forceinline__ Quat<T> rotation_chain(Quat<T> q, const T* s_exp) {
#pragma unroll
  for (int s = 0; s + 1 < degree; ++s) {
    const T* x = s_exp + 4 * s;
    q = qmul(q, Quat<T>{x[0], x[1], x[2], x[3]});
  }
  return q;
}

// component k of the mid pose's translation: the position bases wv over
// the segment's knots of t [K, 3], in the card's einsum order
template <typename T, int degree>
__device__ __forceinline__ T translation(const T* knot_t, int idx, int k, const T* wv) {
  T x[degree];
#pragma unroll
  for (int i = 0; i < degree; ++i) x[i] = knot_t[(idx + i) * 3 + k];
  return einsum_tap_sum<T, degree>(wv, x);
}

// quat_rotate(q, v), q = (xyz, w), in its two-cross-product form
// v + w (2 xyz x v) + xyz x (2 xyz x v), each sum left to right
template <typename T>
__device__ __forceinline__ V3<T> rotate(V3<T> xyz, T w, V3<T> v) {
  V3<T> u = cross(xyz, v);
  u = {T(2) * u.x, T(2) * u.y, T(2) * u.z};
  const V3<T> xu = cross(xyz, u);
  return {(v.x + w * u.x) + xu.x, (v.y + w * u.y) + xu.y, (v.z + w * u.z) + xu.z};
}

// torch.clamp of a float (a NaN passes through), then its cast to int64,
// then the int64 clamp: _current_intensity's index
template <typename T>
__device__ __forceinline__ long long gather_index(T x, int size) {
  const T c = isnan(x) ? x : fmin(fmax(x, T(-1)), T(size));
  long long i = (long long)c;
  return i < 0 ? 0 : (i > size - 1 ? size - 1 : i);
}

// A thread's (keypoint n, pattern pixel p) pair before the pose: the
// keypoint's back-projection P3dr, its mask and the pattern's offset
// (zeros for a thread past N P)
template <typename T>
struct Pair {
  V3<T> P3dr;
  T live;
  int ox, oy;
};

template <typename T>
__device__ __forceinline__ Pair<T> load_pair(const T* __restrict__ kp_xy,
                                             const T* __restrict__ kp_z,
                                             const T* __restrict__ kp_mask,
                                             const int32_t* __restrict__ pattern, bool active,
                                             int n, int p, T fx, T fy, T cx, T cy) {
  Pair<T> r{{T(0), T(0), T(0)}, T(0), 0, 0};
  if (active) {
    const T z = kp_z[n];
    r.P3dr = {(z * (kp_xy[2 * n] - cx)) / fx, (z * (kp_xy[2 * n + 1] - cy)) / fy, z};
    r.live = kp_mask[n];
    r.ox = pattern[2 * p];
    r.oy = pattern[2 * p + 1];
  }
  return r;
}

// The pair through the frame's inverted mid pose (q_r2c = (xyz, w),
// t_r2c): P3dc = quat_rotate(q_r2c, P3dr) + t_r2c, the anchor, then the
// pixel, its in-image test and the gather of cur_imgs there
template <typename T>
__device__ __forceinline__ void write_pair(const Pair<T>& r, V3<T> xyz, T w, V3<T> t_r2c,
                                           T fx, T fy, T cx, T cy, int f, int n, int p, int N,
                                           int P, int H, int W, int Hc, int Wc,
                                           const T* __restrict__ cur, T* __restrict__ pix,
                                           uint8_t* __restrict__ valid, T* __restrict__ obs,
                                           T* __restrict__ anchors) {
  const V3<T> c = rotate(xyz, w, r.P3dr);
  const T Px = c.x + t_r2c.x, Py = c.y + t_r2c.y, Pz = c.z + t_r2c.z;
  const T ax = (Px / Pz) * fx + cx;
  const T ay = (Py / Pz) * fy + cy;
  const long long o = ((long long)f * N + n) * P + p;
  if (anchors != nullptr && p == 0) {
    const long long a = (long long)f * N + n;
    anchors[2 * a] = ax;
    anchors[2 * a + 1] = ay;
  }
  const T x = floor(ax) + T(r.ox);
  const T y = floor(ay) + T(r.oy);
  pix[2 * o] = x;
  pix[2 * o + 1] = y;
  valid[o] = (x >= T(0) && x <= T(W - 1) && y >= T(0) && y <= T(H - 1) && r.live > T(0)) ? 1
                                                                                          : 0;
  obs[o] = __ldg(cur + ((long long)f * Hc + gather_index(y, Hc)) * Wc + gather_index(x, Wc));
}

// ---------------------------------------------------------------- serial

// The mid-exposure pose of frame f, inverted (q_r2c = conj(q), t_r2c =
// -rotate(q_r2c, t)), into s_inv[0..6] = (t_r2c, q_r2c). s_exp holds the
// segments' exps (degree - 1 of them).
template <typename T, int degree>
__device__ void mid_pose_inverse(const T* __restrict__ knot_t, const T* __restrict__ knot_q,
                                 int K, T t0, T dt, T c, T e, int V, T* s_inv, T* s_exp) {
  T wv[degree], wc[degree - 1];
  const int idx = spline_segment<T, degree>(mid_time(c, e, V), t0, dt, K, wv, wc);
  const int j = threadIdx.x;
  if (j < degree - 1) {
    const Quat<T> ex = segment_exp(knot_quat(knot_q, idx + j), knot_quat(knot_q, idx + j + 1),
                                   wc[j], small_threshold<T>());
    T* o = s_exp + 4 * j;
    o[0] = ex.x; o[1] = ex.y; o[2] = ex.z; o[3] = ex.w;
  }
  __syncthreads();
  if (j != 0) return;
  const Quat<T> qi = qconj(rotation_chain<T, degree>(knot_quat(knot_q, idx), s_exp));
  const V3<T> t = {translation<T, degree>(knot_t, idx, 0, wv),
                   translation<T, degree>(knot_t, idx, 1, wv),
                   translation<T, degree>(knot_t, idx, 2, wv)};
  // patch_anchors: q_r2c = quat_conjugate(q), t_r2c = -quat_rotate(q_r2c, t)
  const V3<T> rt = rotate(V3<T>{qi.x, qi.y, qi.z}, qi.w, t);
  s_inv[0] = -rt.x;
  s_inv[1] = -rt.y;
  s_inv[2] = -rt.z;
  s_inv[3] = qi.x;
  s_inv[4] = qi.y;
  s_inv[5] = qi.z;
  s_inv[6] = qi.w;
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
  const Pair<T> pair = load_pair(kp_xy, kp_z, kp_mask, pattern, active, n, p, fx, fy, cx, cy);
  mid_pose_inverse<T, degree>(knot_t, knot_q, K, *t0p, *dtp, cap[f], expo[f], V, s_inv, s_exp);
  __syncthreads();
  if (!active) return;
  write_pair(pair, V3<T>{s_inv[3], s_inv[4], s_inv[5]}, s_inv[6],
             V3<T>{s_inv[0], s_inv[1], s_inv[2]}, fx, fy, cx, cy, f, n, p, N, P, H, W, Hc, Wc,
             cur, pix, valid, obs, anchors);
}
// The first design, kept as the earlier one (the serial design)
template <typename T>
__global__ void __launch_bounds__(kThreads)
frame_layout_serial_kernel(const T* __restrict__ knot_t,    // [K, 3]
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

// ---------------------------------------------------------------- staged

// The staged design at a spline degree. Shared memory: s_q [4 K] and s_t
// [3 K] (the knots), s_exp [4 (degree - 1)] (the segments' exps), s_pose
// [7] = (t, q_r2c) (the frame's mid pose, its translation not yet
// inverted).
template <typename T, int degree>
__device__ void staged_body(const T* __restrict__ knot_t, const T* __restrict__ knot_q,
                            const T* __restrict__ t0p, const T* __restrict__ dtp,
                            const T* __restrict__ cap, const T* __restrict__ expo,
                            const T* __restrict__ kp_xy, const T* __restrict__ kp_z,
                            const T* __restrict__ kp_mask, const T* __restrict__ Kv,
                            const int32_t* __restrict__ pattern, const T* __restrict__ cur,
                            T* __restrict__ pix, uint8_t* __restrict__ valid,
                            T* __restrict__ obs, T* __restrict__ anchors, int K, int N, int F,
                            int P, int V, int H, int W, int Hc, int Wc, T* s_q, T* s_t,
                            T* s_exp, T* s_pose) {
  const int f = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;   // n P + p, below 2^31
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = i < N * P;
  const int n = active ? i / P : 0;
  const int p = active ? i - n * P : 0;
  // the one trip: every thread's keypoint, pattern pixel and intrinsics,
  // and warp 0's rotations, warp 1's translations and both warps' times
  const T fx = Kv[0], fy = Kv[1], cx = Kv[2], cy = Kv[3];
  const Pair<T> pair = load_pair(kp_xy, kp_z, kp_mask, pattern, active, n, p, fx, fy, cx, cy);
  if (warp < 2) {
    const T* src = warp == 0 ? knot_q : knot_t;
    T* dst = warp == 0 ? s_q : s_t;
    const int count = (warp == 0 ? 4 : 3) * K;
    T staged[kLoads];
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int e = lane + 32 * r;
      if (e < count) staged[r] = src[e];
    }
    const T c = cap[f], e = expo[f], t0 = *t0p, dt = *dtp;
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int at = lane + 32 * r;
      if (at < count) dst[at] = staged[r];
    }
    __syncwarp();
    T wv[degree], wc[degree - 1];
    const int idx = spline_segment<T, degree>(mid_time(c, e, V), t0, dt, K, wv, wc);
    if (warp == 0) {
      if (lane < degree - 1) {
        // wc[lane] by selects: a register, not a local array indexed at run time
        T cj = wc[0];
#pragma unroll
        for (int j = 1; j + 1 < degree; ++j) cj = lane == j ? wc[j] : cj;
        const Quat<T> ex = segment_exp(knot_quat(s_q, idx + lane),
                                       knot_quat(s_q, idx + lane + 1), cj,
                                       small_threshold<T>());
        T* o = s_exp + 4 * lane;
        o[0] = ex.x; o[1] = ex.y; o[2] = ex.z; o[3] = ex.w;
      }
      __syncwarp();
      if (lane == 0) {
        const Quat<T> qi = qconj(rotation_chain<T, degree>(knot_quat(s_q, idx), s_exp));
        s_pose[3] = qi.x; s_pose[4] = qi.y; s_pose[5] = qi.z; s_pose[6] = qi.w;
      }
    } else if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) s_pose[k] = translation<T, degree>(s_t, idx, k, wv);
    }
  }
  __syncthreads();
  if (!active) return;
  // patch_anchors: t_r2c = -quat_rotate(q_r2c, t), in every thread (the
  // serial design's operations: the same bits), then write_pair
  const V3<T> xyz = {s_pose[3], s_pose[4], s_pose[5]};
  const T w = s_pose[6];
  const V3<T> rt = rotate(xyz, w, V3<T>{s_pose[0], s_pose[1], s_pose[2]});
  write_pair(pair, xyz, w, V3<T>{-rt.x, -rt.y, -rt.z}, fx, fy, cx, cy, f, n, p, N, P, H, W, Hc,
             Wc, cur, pix, valid, obs, anchors);
}
// the staged design's shared memory (ops/cuda_layout.py's layout_staging):
// s_q, s_t, s_exp and s_pose, rounded up to 16 bytes
template <typename T>
constexpr long long staged_smem_bytes(int K) {
  return ((7LL * K + 12 + 7) * (long long)sizeof(T) + 15) / 16 * 16;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
frame_layout_kernel(const T* __restrict__ knot_t, const T* __restrict__ knot_q,
                    const T* __restrict__ t0p, const T* __restrict__ dtp,
                    const T* __restrict__ cap, const T* __restrict__ expo,
                    const T* __restrict__ kp_xy, const T* __restrict__ kp_z,
                    const T* __restrict__ kp_mask, const T* __restrict__ Kv,
                    const int32_t* __restrict__ pattern, const T* __restrict__ cur,
                    T* __restrict__ pix, uint8_t* __restrict__ valid, T* __restrict__ obs,
                    T* __restrict__ anchors, int K, int degree, int N, int F, int P, int V,
                    int H, int W, int Hc, int Wc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_q = reinterpret_cast<T*>(smem);
  T* s_t = s_q + 4 * K;
  T* s_exp = s_t + 3 * K;
  T* s_pose = s_exp + 12;
  if (degree == 2)
    staged_body<T, 2>(knot_t, knot_q, t0p, dtp, cap, expo, kp_xy, kp_z, kp_mask, Kv, pattern,
                      cur, pix, valid, obs, anchors, K, N, F, P, V, H, W, Hc, Wc, s_q, s_t,
                      s_exp, s_pose);
  else
    staged_body<T, 4>(knot_t, knot_q, t0p, dtp, cap, expo, kp_xy, kp_z, kp_mask, Kv, pattern,
                      cur, pix, valid, obs, anchors, K, N, F, P, V, H, W, Hc, Wc, s_q, s_t,
                      s_exp, s_pose);
}

// ---------------------------------------------------------------- launch

template <typename T>
int launch_frame_layout(const void* knot_t, const void* knot_q, const void* t0, const void* dt,
                        const void* cap, const void* expo, const void* kp_xy, const void* kp_z,
                        const void* kp_mask, const void* Kv, const void* pattern,
                        const void* cur, void* pix, void* valid, void* obs, void* anchors,
                        int K, int degree, int N, int F, int P, int V, int H, int W, int Hc,
                        int Wc, bool staged, long long smem_bytes, void* stream) {
  if ((degree != 2 && degree != 4) || K < degree || N < 0 || F < 1 || F > 65535 || P < 1 ||
      V < 1 || H < 1 || W < 1 || Hc < 1 || Wc < 1 || (long long)N * P >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (staged && (K > kMaxKnots || smem_bytes != staged_smem_bytes<T>(K)))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)(((long long)N * P + kThreads - 1) / kThreads), (unsigned)F);
  const cudaStream_t st = (cudaStream_t)stream;
  if (staged)
    frame_layout_kernel<T><<<grid, kThreads, (size_t)smem_bytes, st>>>(
        (const T*)knot_t, (const T*)knot_q, (const T*)t0, (const T*)dt, (const T*)cap,
        (const T*)expo, (const T*)kp_xy, (const T*)kp_z, (const T*)kp_mask, (const T*)Kv,
        (const int32_t*)pattern, (const T*)cur, (T*)pix, (uint8_t*)valid, (T*)obs, (T*)anchors,
        K, degree, N, F, P, V, H, W, Hc, Wc);
  else
    frame_layout_serial_kernel<T><<<grid, kThreads, 0, st>>>(
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
      int W, int Hc, int Wc
#define LAYOUT_PASS                                                                      \
  knot_t, knot_q, t0, dt, cap, expo, kp_xy, kp_z, kp_mask, Kv, pattern, cur, pix, valid, \
      obs, anchors, K, degree, N, F, P, V, H, W, Hc, Wc

int frame_layout_max_knots() { return kMaxKnots; }

int frame_layout_f32(LAYOUT_ARGS, long long smem_bytes, void* stream) {
  return launch_frame_layout<float>(LAYOUT_PASS, true, smem_bytes, stream);
}
int frame_layout_f64(LAYOUT_ARGS, long long smem_bytes, void* stream) {
  return launch_frame_layout<double>(LAYOUT_PASS, true, smem_bytes, stream);
}
int frame_layout_serial_f32(LAYOUT_ARGS, void* stream) {
  return launch_frame_layout<float>(LAYOUT_PASS, false, 0, stream);
}
int frame_layout_serial_f64(LAYOUT_ARGS, void* stream) {
  return launch_frame_layout<double>(LAYOUT_PASS, false, 0, stream);
}

}  // extern "C"
