// K2: the tracker's residual and Jacobian rows for Hopper (sm_90a), two
// entry points around the sampler K1.
//
// Replaces the XLA fusion of mba_vo_tpu/ops/residual.py:429-466
// (residuals_of under jax.linearize): no Pallas source, XLA fused it on the
// TPU. The port ran it as a few hundred eager torch ops an evaluation.
//
//   warp_tangents (the knots design, which the tracker launches): the stage
//     XLA fuses from the knot step to the window-local positions
//     (residual.py:430-446: spline_retract, sample_virtual_poses,
//     frontoparallel_warp, in_bounds and loc), with its derivative at zero
//     retraction, in one launch. Every sample (n, f, p, v) -- patch pixel
//     p of keypoint n in frame f, warped by virtual pose v into the
//     keyframe -- gives its window-local coordinate loc = warp - start_n,
//     its in-image flag vs and the derivative dxy of the warped position
//     along the D = 6K knot tangents ([3K translations; 3K rotations]; D =
//     0 for a cost-only call), laid out [2, D, N, S] (x and y planes,
//     tangent-major). A CTA takes one frame and blocks of a few keypoints.
//     It first puts the frame's V virtual poses and their 7 x D tangents in
//     shared memory (core/spline.py's virtual_pose_times,
//     spline_retract_jvp and spline_pose_at_times_jvp step by step; a pose
//     depends on `degree` knots only, so it runs 1 + 3 degree chains of
//     quaternion log/exp -- the zero seed, which every other seed shares,
//     and each rotation seed of its window -- one thread a (pose, chain,
//     segment), then fills the D entries from them). Then one thread a
//     sample (and a group of its tangents) warps it, writes loc and vs, and
//     folds the warp's chain rule into 7 coefficients of x and of y on the
//     pose tangent, so that each tangent is two 7-term sums over the shared
//     table, consecutive threads on consecutive samples of one tangent.
//   warp_tangents_threads (the earlier thread design, a sweep row): the warp alone from
//     pose tangents dpose [D, F, V, 7] computed by torch, one thread a
//     sample in the samples' order n S + s, D tangents one after another,
//     the pose tangents through the L1. The math is
//     ops/warp.py::frontoparallel_warp_jvp, step by step.
//   blur_rows: after K1 has sampled (I, dI/dx, dI/dy) at every loc, the
//     blur model averages each patch pixel's V samples, and the tangent row
//     mean_v (gx dx + gy dy); it writes r = pred - obs and the J row where
//     the patch pixel is valid (0 elsewhere), or pred and its tangent
//     unmasked when the affine elimination follows in torch. Two designs,
//     equal to the bit (the same sums over v in order, the same division):
//     * keypoint design (the one the tracker launches): one CTA a keypoint
//       n in every frame. Its operands are a few contiguous runs: its
//       samples of val, gx and gy (one run for all three where they are
//       K1's channels), and for each tangent d its entries of dxy's x and y
//       planes. Warp 0 brings them into shared memory by cp.async.bulk on an
//       mbarrier (bulk_copy.cuh); then one thread an output (f, n, p, d),
//       a warp a block of 4 x 8 or 8 x 4 outputs, sums over v from shared
//       memory, and J leaves from registers in runs of the block's
//       consecutive tangents. Where one keypoint's whole slab exceeds the
//       wrapper's budget (a joint chunk's 42 tangents), the tangents stream
//       in tiles of up to 8, two stages deep: the copies of tile t + 2 fly
//       while tile t + 1 is summed.
//     * thread design (the earlier one, a sweep row): one thread an
//       (f, n, p), d outside and v inside; the block's J rows pass through
//       a padded shared buffer 32 tangents at a time, so that they leave in
//       contiguous runs.
//
// What bounds it on the card: the bytes of dxy, written once and read once
// (N F P V 2 D items: 2 MB at the frame's shapes in f32, 0.6 us at 3.35
// TB/s, less than one launch; 27.5 MB at a degree-4 joint chunk, 8.2 us).
// warp_tangents' knots design writes them in one pass: the poses are a few
// KB, computed once a CTA for as many keypoint blocks as one wave of CTAs
// leaves it (their chains of divisions and transcendentals are the
// launch's fixed cost, run segment by segment side by side), and each
// sample's tangents read the shared table, not the L1.
// Bulk copies cost their SM time to issue, one after another (PERF.md
// section 6), so blur_rows takes few long runs (a keypoint's samples of a
// tangent plane in every frame).
// Keeping dxy out of device memory (blur_rows recomputing the warp
// tangents, or the normal equations fused into blur_rows) is later work.
//
// Semantics kept from the plain versions (ops/residual.py's
// warp_tangents_plain, warp_tangents_threads_plain and blur_rows_plain):
//   * the warped position is the plain version's to the bit wherever the
//     poses are: the build compiles this file with -fmad=false
//     (ops/cuda_build.py) and the warp runs the plain version's operations
//     in its order, each rounded once, as torch's elementwise kernels round
//     them. A multiply-add contracted into one rounding moves a position by
//     an ulp, and where the integer patch pixels of a standing start warp
//     onto the image's border that flips the in-image flag. The knots
//     design's poses take the plain version's operations too
//     (spline_pose.cuh, which K5 shares), with the sum over a pose's knots
//     in the order of the einsum on the card (measured equal positions in
//     f32; f64 within 1e-15 of the position);
//   * the knots design's tangents are held to the plain version within a
//     tolerance (1e-6 f32, 1e-12 f64 of the largest entry), not to the bit:
//     their arithmetic is regrouped into the 7 coefficients and fused
//     multiply-adds;
//   * vs is 1 where the warped position lies in [0, W-1] x [0, H-1], else
//     0 (a NaN position gives 0); K1 then gives 0 samples and gradients
//     there, so the tangent of such a sample is 0;
//   * a NaN coordinate still reaches K1, which returns NaN;
//   * r and the J row are 0 where the patch pixel is invalid, whatever the
//     samples hold (a NaN included).
// The kernels allocate nothing and do not synchronise; the C entry points
// return the CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "spline_pose.cuh"

#ifndef MAX_TANGENTS
#error "MAX_TANGENTS (the largest number of knot tangents a launch may take) must be defined by the build"
#endif

namespace {

using namespace spline;

constexpr int kMaxTangents = MAX_TANGENTS;
// threads a block of warp_tangents' thread design
constexpr int kWarpThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kWarpThreads)
warp_tangents_threads_kernel(const T* __restrict__ pose_t,   // [F, V, 3]
                                     const T* __restrict__ pose_q,   // [F, V, 4]
                                     const T* __restrict__ dpose,    // [D, F, V, 7]
                                     const T* __restrict__ kp_z,     // [N]
                                     const T* __restrict__ Kv,       // [4]
                                     const T* __restrict__ pix,      // [F, N, P, 2]
                                     const int64_t* __restrict__ starts,  // [N, 2]
                                     T* __restrict__ loc,            // [N, S, 2]
                                     T* __restrict__ vs,             // [N, S]
                                     T* __restrict__ dxy,            // [2, D, N, S]
                                     int N, int F, int P, int V, int D, int H, int W) {
  const long long S = (long long)F * P * V;
  const long long NS = (long long)N * S;
  const long long o = (long long)blockIdx.x * kWarpThreads + threadIdx.x;   // n S + s
  if (o >= NS) return;
  const int n = (int)(o / S);
  const int s_idx = (int)(o - (long long)n * S);
  const int f = s_idx / (P * V);
  const int p = (s_idx / V) % P;
  const int v = s_idx % V;
  const int fv = f * V + v;

  const T fx = Kv[0], fy = Kv[1], cx = Kv[2], cy = Kv[3];
  const T* px = pix + (((long long)f * N + n) * P + p) * 2;
  // unit ray of the current-view pixel
  const T x_hat = (px[0] - cx) / fx;
  const T y_hat = (px[1] - cy) / fy;
  const T z_hat = T(1) / sqrt(T(1) + x_hat * x_hat + y_hat * y_hat);
  const V3<T> ray = {x_hat * z_hat, y_hat * z_hat, z_hat};
  // rotated = ray + w u + xyz x u, u = 2 xyz x ray
  const T* q = pose_q + fv * 4;
  const T* t = pose_t + fv * 3;
  const V3<T> xyz = {q[0], q[1], q[2]};
  const T w = q[3];
  V3<T> u = cross(xyz, ray);
  u = {T(2) * u.x, T(2) * u.y, T(2) * u.z};
  const V3<T> xu = cross(xyz, u);
  const V3<T> rot = {ray.x + w * u.x + xu.x, ray.y + w * u.y + xu.y, ray.z + w * u.z + xu.z};
  // meet the plane z = depth, project into the keyframe
  const T lam = rot.z;
  const T s = (kp_z[n] - t[2]) / lam;
  const V3<T> Pw = {rot.x * s + t[0], rot.y * s + t[1], rot.z * s + t[2]};
  const T iz = T(1) / (Pw.z + T(1e-8));
  const T rx = fx * Pw.x * iz + cx;
  const T ry = fy * Pw.y * iz + cy;

  loc[2 * o] = rx - (T)starts[2 * n];
  loc[2 * o + 1] = ry - (T)starts[2 * n + 1];
  vs[o] = (rx >= T(0) && rx <= T(W - 1) && ry >= T(0) && ry <= T(H - 1)) ? T(1) : T(0);

  const T* dp = dpose + (long long)fv * 7;
  const long long dstride = (long long)F * V * 7;
  for (int d = 0; d < D; ++d, dp += dstride) {
    const V3<T> dt = {__ldg(dp), __ldg(dp + 1), __ldg(dp + 2)};
    const V3<T> dxyz = {__ldg(dp + 3), __ldg(dp + 4), __ldg(dp + 5)};
    const T dw = __ldg(dp + 6);
    V3<T> du = cross(dxyz, ray);
    du = {T(2) * du.x, T(2) * du.y, T(2) * du.z};
    const V3<T> a = cross(dxyz, u);
    const V3<T> b = cross(xyz, du);
    const V3<T> drot = {dw * u.x + w * du.x + a.x + b.x, dw * u.y + w * du.y + a.y + b.y,
                        dw * u.z + w * du.z + a.z + b.z};
    const T ds = -(dt.z + s * drot.z) / lam;
    const V3<T> dP = {drot.x * s + rot.x * ds + dt.x, drot.y * s + rot.y * ds + dt.y,
                      drot.z * s + rot.z * ds + dt.z};
    const T diz = -dP.z * iz * iz;
    dxy[(long long)d * NS + o] = fx * (dP.x * iz + Pw.x * diz);
    dxy[((long long)D + d) * NS + o] = fy * (dP.y * iz + Pw.y * diz);
  }
}

// thread design: J columns a block stages in shared memory at once, and
// threads a block
constexpr int kCols = 32;
constexpr int kRowsPerBlock = 128;

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock)
blur_rows_kernel(const T* __restrict__ val,   // [N, S] rows row_stride apart
                 const T* __restrict__ gx,
                 const T* __restrict__ gy,
                 long long row_stride,
                 const T* __restrict__ dxy,   // [2, D, N, S]
                 const T* __restrict__ obs,   // [F, N, P]
                 const uint8_t* __restrict__ valid,  // [F, N, P]
                 T* __restrict__ out_r,       // [F, N, P]
                 T* __restrict__ out_j,       // [F, N, P, D]
                 int N, int F, int P, int V, int D, int affine) {
  __shared__ T s_j[kRowsPerBlock * (kCols + 1)];
  const long long rows = (long long)F * N * P;
  const long long i0 = (long long)blockIdx.x * kRowsPerBlock;
  const long long i = i0 + threadIdx.x;
  const bool active = i < rows;
  const long long NP = (long long)N * P;
  const long long S = (long long)F * P * V;
  const long long NS = (long long)N * S;
  int n = 0;
  long long s0 = 0;
  bool live = false;
  if (active) {
    const int f = (int)(i / NP);
    const long long rem = i - f * NP;
    n = (int)(rem / P);
    const int p = (int)(rem - (long long)n * P);
    s0 = ((long long)f * P + p) * V;
    live = valid[i] != 0;
  }
  const T* I = val + n * row_stride + s0;
  const T* Gx = gx + n * row_stride + s0;
  const T* Gy = gy + n * row_stride + s0;
  const long long so = (long long)n * S + s0;   // this row's first sample in dxy's planes
  const T nv = T(V);

  if (active) {
    T sum = T(0);
    for (int v = 0; v < V; ++v) sum += I[v];
    const T pred = sum / nv;
    out_r[i] = affine ? pred : (live ? pred - obs[i] : T(0));
  }

  const int nrows = rows - i0 < kRowsPerBlock ? (int)(rows - i0) : kRowsPerBlock;
  for (int d0 = 0; d0 < D; d0 += kCols) {
    const int width = D - d0 < kCols ? D - d0 : kCols;
    if (active) {
      // v outside, the chunk's columns inside and unrolled: each v's loads
      // of every column leave together, so a row waits on V round trips to
      // memory, not on one per column
      T acc[kCols];
#pragma unroll
      for (int dd = 0; dd < kCols; ++dd) acc[dd] = T(0);
      const T* dx = dxy + (long long)d0 * NS + so;
      const T* dy = dxy + (long long)(D + d0) * NS + so;
      for (int v = 0; v < V; ++v) {
        const T a = Gx[v], b = Gy[v];
#pragma unroll
        for (int dd = 0; dd < kCols; ++dd)
          if (dd < width) acc[dd] += a * dx[dd * NS + v] + b * dy[dd * NS + v];
      }
#pragma unroll
      for (int dd = 0; dd < kCols; ++dd)
        if (dd < width)
          s_j[threadIdx.x * (kCols + 1) + dd] = (affine || live) ? acc[dd] / nv : T(0);
    }
    __syncthreads();
    // the block's rows i0 .. i0 + nrows - 1, columns d0 .. d0 + width - 1
    for (int k = threadIdx.x; k < nrows * width; k += kRowsPerBlock) {
      const int r = k / width;
      const int dd = k - r * width;
      out_j[(i0 + r) * D + d0 + dd] = s_j[r * (kCols + 1) + dd];
    }
    __syncthreads();
  }
}


// keypoint design. Dynamic shared memory of a CTA, in bytes from its start
// (the wrapper computes the same: ops/cuda_residual.py::blur_rows_layout):
//   2 mbarriers | each row's row of r and J [F P] | 3 sample spans |
//   stages x (tile x-plane spans, tile y-plane spans)
// a span holding the keypoint's run of S = F P V samples (a bulk copy's
// slot, bulk_copy.cuh), 16 bytes past a multiple of 128: consecutive
// tangents' spans start on banks 4 words apart, so that a warp's 4 x 8 (or
// 8 x 4) block of outputs reads 32 banks
constexpr int kMaxShared = 232448;   // shared memory a block may use (227 KB)

__host__ __device__ inline long long span_bytes(long long bytes) {
  const long long b = bulk::slot_bytes(bytes);
  return b + (16 - b % 128 + 128) % 128;
}

struct BlurLayout {
  long long span, table, samples, tangents, stage, total;
};

__host__ __device__ inline BlurLayout blur_layout(int F, int P, int V, int sz, int tile,
                                                  int stages) {
  BlurLayout l;
  l.span = span_bytes((long long)F * P * V * sz);
  l.table = 16;
  l.samples = l.table + bulk::round16((long long)F * P * 8);
  l.tangents = l.samples + 3 * l.span;
  l.stage = 2LL * tile * l.span;
  l.total = l.tangents + stages * l.stage;
  return l;
}

// A CTA takes keypoint n in every frame. Its samples of each tangent plane
// of dxy are one contiguous run of S elements, and so are its samples of
// val, gx and gy: one run of 3 S for all three where they are the channels
// of K1's [N, 3, S] output (`interleaved`), else one run each. Its row
// (f, p) is the keypoint's patch pixel rw = f P + p, whose V samples start
// rw V into each run.
template <typename T>
__global__ void __launch_bounds__(1024)
blur_rows_keypoint_kernel(const T* __restrict__ val,   // [N, S] rows row_stride apart
                          const T* __restrict__ gx,
                          const T* __restrict__ gy,
                          long long row_stride,
                          const T* __restrict__ dxy,   // [2, D, N, S]
                          const T* __restrict__ obs,   // [F, N, P]
                          const uint8_t* __restrict__ valid,  // [F, N, P]
                          T* __restrict__ out_r,       // [F, N, P]
                          T* __restrict__ out_j,       // [F, N, P, D]
                          int N, int F, int P, int V, int D, int affine, int tile,
                          int interleaved) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stages = D > tile ? 2 : 1;
  const BlurLayout lay = blur_layout(F, P, V, (int)sizeof(T), tile, stages);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int S = F * P * V;
  const long long n = blockIdx.x;
  const int steps = D > 0 ? (D + tile - 1) / tile : 1;
  const T nv = T(V);

  auto sample_run = [&](int which) {
    T* slot = reinterpret_cast<T*>(smem + lay.samples + which * lay.span);
    if (interleaved) return bulk::Run<T>(val + n * row_stride, slot, 3 * S);
    const T* src = which == 0 ? val : (which == 1 ? gx : gy);
    return bulk::Run<T>(src + n * row_stride, slot, S);
  };
  auto tangent_run = [&](int st, int cxy, int dd) {
    const long long plane = (long long)cxy * D + (long long)st * tile + dd;
    return bulk::Run<T>(dxy + (plane * N + n) * S,
                        reinterpret_cast<T*>(smem + lay.tangents + (st % stages) * lay.stage +
                                             ((long long)cxy * tile + dd) * lay.span),
                        S);
  };
  auto width_of = [&](int st) { return D - st * tile < tile ? D - st * tile : tile; };
  // warp 0: step st's copies (with step 0 the samples: val, and gx and gy
  // where there are tangents), lanes taking turns; the phase's two arrivals
  // (bulk_copy.cuh)
  const int nsample = interleaved ? 1 : (D > 0 ? 3 : 1);
  auto issue = [&](int st) {
    const int width = width_of(st);
    const int first = st == 0 ? nsample : 0;
    const int nruns = first + 2 * width;
    auto run_of = [&](int i) {
      if (i < first) return sample_run(i);
      return tangent_run(st, (i - first) & 1, (i - first) >> 1);
    };
    uint64_t* bar = &bars[st & 1];
    uint32_t bytes = 0;
    for (int i = lane; i < nruns; i += 32) bytes += run_of(i).bytes();
    const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
    if (lane == 0) bulk::bar_arrive_expect(bar, total);
    __syncwarp();
    for (int i = lane; i < nruns; i += 32) run_of(i).issue(bar);
    __syncwarp();
    if (lane == 0) bulk::bar_arrive(bar);
  };

  if (tid == 0) {
    bulk::bar_init(&bars[0], 2);
    bulk::bar_init(&bars[1], 2);
    bulk::fence_bar_init();
  }
  __syncthreads();
  if (tid < 32) {
    issue(0);
    if (steps > 1) issue(1);
  }
  const int rows = F * P;
  // each row's row of r and J, while the copies fly
  long long* s_out = reinterpret_cast<long long*>(smem + lay.table);
  for (int rw = tid; rw < rows; rw += blockDim.x) {
    const int f = rw / P;
    s_out[rw] = ((long long)f * N + n) * P + (rw - f * P);
  }
  __syncthreads();
  const T* I = sample_run(0).data();
  const T* Gx = interleaved ? I + S : sample_run(1).data();
  const T* Gy = interleaved ? I + 2 * S : sample_run(2).data();
  for (int st = 0; st < steps; ++st) {
    bulk::bar_wait(&bars[st & 1], (st >> 1) & 1);
    if (st == 0) {
      for (int rw = tid; rw < rows; rw += blockDim.x) {
        const long long row = s_out[rw];
        const T* Ir = I + rw * V;
        T sum = T(0);
        for (int v = 0; v < V; ++v) sum += Ir[v];
        const T pred = sum / nv;
        out_r[row] = affine ? pred : (valid[row] != 0 ? pred - obs[row] : T(0));
      }
    }
    const int width = width_of(st);
    // a warp takes blocks of WR rows x WD tangents, a lane an output; the
    // blocks of a row block are its consecutive tangents
    const int WD = width % 8 == 0 ? 8 : 4, WR = 32 / WD;
    const int cblocks = (width + WD - 1) / WD;
    const int nblocks = (rows + WR - 1) / WR * cblocks;
    for (int blk = tid >> 5; blk < nblocks; blk += blockDim.x >> 5) {
      const int rb = blk / cblocks;
      const int rw = rb * WR + lane / WD;
      const int dd = (blk - rb * cblocks) * WD + lane % WD;
      if (rw >= rows || dd >= width) continue;
      const T* gxr = Gx + rw * V;
      const T* gyr = Gy + rw * V;
      const T* dx = tangent_run(st, 0, dd).data() + rw * V;
      const T* dy = tangent_run(st, 1, dd).data() + rw * V;
      T acc = T(0);
      for (int v = 0; v < V; ++v) {
        const T a = gxr[v], b = gyr[v];
        acc += a * dx[v] + b * dy[v];
      }
      const long long row = s_out[rw];
      out_j[row * D + (long long)st * tile + dd] =
          (affine || valid[row] != 0) ? acc / nv : T(0);
    }
    if (st + 2 < steps) {
      // step st's stage is free: tile st + 2 flies while st + 1 is summed
      __syncthreads();
      if (tid < 32) issue(st + 2);
    }
  }
}

// ---------------------------------------------------------------- knots design
// warp_tangents from the spline knots, the entry the tracker launches (the
// file's header). Dynamic shared memory of a CTA, in elements of T from its
// start (the wrapper computes the same: ops/cuda_residual.py's
// warp_tangents_layout):
//   the poses' tangents [V][D][8] (7 values and a pad, so that a tangent
//   loads as two or four 16-byte words) | the frame's V poses [V][7] |
//   each pose's segment [V][5] (basis weights, first knot) |
//   each pose's rotation tangents [V][kJobs][4] |
//   each job's segments' exps and their tangents [V][kJobs][3][8]
// threads a CTA of the knots design
constexpr int kKnotThreads = 256;
// a pose's rotation jobs: the zero seed, then each (tap, axis) of degree 4
constexpr int kJobs = 13;

__host__ __device__ inline long long knots_smem_bytes(int V, int D, int sz) {
  return (8LL * V * D + 7LL * V + 5LL * V + 4LL * kJobs * V + 24LL * kJobs * V) * sz;
}

// eight values of shared memory, 16-byte aligned, in 16-byte words
__device__ __forceinline__ void load8(const float* p, float* e) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  e[0] = a.x; e[1] = a.y; e[2] = a.z; e[3] = a.w;
  e[4] = b.x; e[5] = b.y; e[6] = b.z; e[7] = b.w;
}

__device__ __forceinline__ void load8(const double* p, double* e) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double2 a = reinterpret_cast<const double2*>(p)[i];
    e[2 * i] = a.x;
    e[2 * i + 1] = a.y;
  }
}

// The window's knot j retracted by a zero step, and its tangent along one
// rotation seed of the knot tangent: axis `axis` of the window's knot `tap`
// (tap < 0: the zero seed, which every translation seed and every rotation
// seed of a knot outside the window passes through the same operations), as
// core/spline.py's spline_retract_jvp takes them: the retraction's exp(0)
// and its tangent (0.5 e_axis, 0), then the products q exp(0) and q de.
template <typename T>
__device__ __forceinline__ void window_knot(const T* __restrict__ kq, int idx, int j, int tap,
                                            int axis, Quat<T>& q, Quat<T>& dq) {
  const Quat<T> ident = {T(0), T(0), T(0), T(1)};
  const T* k = kq + (idx + j) * 4;
  const Quat<T> q0 = {k[0], k[1], k[2], k[3]};
  q = qmul(q0, ident);
  const T h = T(0.5) * T(j == tap);
  dq = qmul(q0, Quat<T>{axis == 0 ? h : T(0), axis == 1 ? h : T(0), axis == 2 ? h : T(0),
                        T(0)});
}

// The poses of frame f and their tangents into shared memory, as
// core/spline.py's spline_interp_q_jvp takes them. A pose's rotation jobs
// r: r = 0 the zero seed (and the pose itself), r = 1 + 3 j + a the
// rotation seed of the window's knot j along axis a. (A) one thread a (v, r,
// segment j): the relative rotation of knots j and j + 1, its log and the
// exp of its basis-scaled log, each with its forward-mode rule, into
// shared memory (the segments are independent, so that their long chains
// of divisions and transcendentals run side by side); (B) one thread a (v,
// r): the products over the segments, the pose and its translation (at
// degree 2, one segment, the thread of (A) ends the job itself); (C)
// each (v, d) tangent entry, filled from the jobs, its translation part the
// basis weight of its knot (tap_sum over the seed's unit entries, as the
// plain version's einsum of the seeds).
template <typename T, int degree>
__device__ void frame_poses(const T* __restrict__ knot_t, const T* __restrict__ knot_q,
                            int K, T t0, T kdt, T c, T e, int V, int D, T* s_pose, T* s_tan,
                            T* s_seg, T* s_job, T* s_exp) {
  const T thr = sizeof(T) >= 8 ? T(1e-20) : T(1e-10);   // core/lie.py::_small_threshold
  // core/spline.py::virtual_pose_times, its 1e-8 guard in the divisor
  const T div = T((double)(V - 1) + 1e-8);
  const int R = D > 0 ? 1 + 3 * degree : 1;
  // a job's end: its rotation tangent, and for the zero seed the pose and
  // its segment
  auto finish = [&](int v, int r, int idx, const T* wv, Quat<T> q, Quat<T> dq) {
    T* jb = s_job + (v * kJobs + r) * 4;
    jb[0] = dq.x;
    jb[1] = dq.y;
    jb[2] = dq.z;
    jb[3] = dq.w;
    if (r != 0) return;
    T* p = s_pose + v * 7;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T x[degree];
#pragma unroll
      for (int j = 0; j < degree; ++j) x[j] = knot_t[(idx + j) * 3 + k];
      p[k] = tap_sum<T, degree>(wv, x);
    }
    p[3] = q.x;
    p[4] = q.y;
    p[5] = q.z;
    p[6] = q.w;
#pragma unroll
    for (int j = 0; j < degree; ++j) s_seg[v * 5 + j] = wv[j];
    s_seg[v * 5 + 4] = T(idx);
  };
  for (int i = threadIdx.x; i < V * R * (degree - 1); i += kKnotThreads) {
    const int v = i % V, r = (i / V) % R, j = i / (V * R);
    const int tap = r == 0 ? -1 : (r - 1) / 3, axis = (r - 1) % 3;
    const T tau = (c - T(0.5) * e) + (T(v) * e) / div;
    T wv[degree], wc[degree - 1];
    const int idx = spline_segment<T, degree>(tau, t0, kdt, K, wv, wc);
    Quat<T> qa, dqa, qb, dqb;
    window_knot(knot_q, idx, j, tap, axis, qa, dqa);
    window_knot(knot_q, idx, j + 1, tap, axis, qb, dqb);
    const Quat<T> ca = qconj(qa);
    const Quat<T> rel = qmul(ca, qb);
    const Quat<T> drel = qadd(qmul(qconj(dqa), qb), qmul(ca, dqb));
    V3<T> lg, dlg;
    quat_log_jvp(rel, drel, thr, lg, dlg);
    const T cj = wc[j];
    Quat<T> ex, dex;
    quat_exp_jvp(V3<T>{lg.x * cj, lg.y * cj, lg.z * cj},
                 V3<T>{dlg.x * cj, dlg.y * cj, dlg.z * cj}, thr, ex, dex);
    if constexpr (degree == 2) {
      // one segment: the product with the window's first knot ends the job
      finish(v, r, idx, wv, qmul(qa, ex), qadd(qmul(dqa, ex), qmul(qa, dex)));
    } else {
      T* o = s_exp + ((v * kJobs + r) * 3 + j) * 8;
      o[0] = ex.x; o[1] = ex.y; o[2] = ex.z; o[3] = ex.w;
      o[4] = dex.x; o[5] = dex.y; o[6] = dex.z; o[7] = dex.w;
    }
  }
  if constexpr (degree != 2) {
    __syncthreads();
    for (int i = threadIdx.x; i < V * R; i += kKnotThreads) {
      const int v = i % V, r = i / V;
      const int tap = r == 0 ? -1 : (r - 1) / 3, axis = (r - 1) % 3;
      const T tau = (c - T(0.5) * e) + (T(v) * e) / div;
      T wv[degree], wc[degree - 1];
      const int idx = spline_segment<T, degree>(tau, t0, kdt, K, wv, wc);
      Quat<T> q, dq;
      window_knot(knot_q, idx, 0, tap, axis, q, dq);
#pragma unroll
      for (int j = 0; j + 1 < degree; ++j) {
        const T* x = s_exp + ((v * kJobs + r) * 3 + j) * 8;
        const Quat<T> ex = {x[0], x[1], x[2], x[3]}, dex = {x[4], x[5], x[6], x[7]};
        dq = qadd(qmul(dq, ex), qmul(q, dex));
        q = qmul(q, ex);
      }
      finish(v, r, idx, wv, q, dq);
    }
  }
  if (D == 0) return;
  __syncthreads();
  for (int i = threadIdx.x; i < V * D; i += kKnotThreads) {
    const int v = i % V, d = i / V;
    const T* sg = s_seg + v * 5;
    const int idx = (int)sg[4];
    const bool rot = d >= 3 * K;
    const int knot = (rot ? d - 3 * K : d) / 3, axis = d % 3;
    const int tap = knot - idx;
    const bool on = tap >= 0 && tap < degree;
    T* out = s_tan + ((long long)v * D + d) * 8;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T x[degree];
#pragma unroll
      for (int j = 0; j < degree; ++j) x[j] = T(!rot && j == tap && k == axis);
      out[k] = tap_sum<T, degree>(sg, x);
    }
    const T* jb = s_job + (v * kJobs + (rot && on ? 1 + 3 * tap + axis : 0)) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) out[3 + k] = jb[k];
    out[7] = T(0);
  }
}

// A CTA takes frame f (blockIdx.y) and the blocks of kp keypoints
// blockIdx.x, blockIdx.x + gridDim.x, ...: a block's samples are kp runs of
// P V, one a keypoint, S apart in loc, vs and each plane of dxy. After the
// frame's poses and tangents are in shared memory (frame_poses), thread t
// takes sample t % (kp P V) of each block and the tangents t / (kp P V),
// + G, + 2G, ... (G groups of threads a block): it warps its sample as the
// thread design does (the group-0 thread writes loc and vs), then folds the
// warp's chain rule into the 7 coefficients of x and of y on the pose
// tangent (dt, dxyz, dw), and each tangent is two 7-term sums. Consecutive
// threads take consecutive samples of one tangent, so each plane of dxy is
// written in runs.
template <typename T, int degree>
__device__ void knots_body(const T* __restrict__ knot_t, const T* __restrict__ knot_q,
                           const T* __restrict__ t0p, const T* __restrict__ dtp,
                           const T* __restrict__ cap, const T* __restrict__ expo,
                           const T* __restrict__ kp_z, const T* __restrict__ Kv,
                           const T* __restrict__ pix, const int64_t* __restrict__ starts,
                           T* __restrict__ loc, T* __restrict__ vs, T* __restrict__ dxy,
                           int K, int N, int F, int P, int V, int D, int H, int W, int kp,
                           unsigned char* smem) {
  const int f = blockIdx.y;
  const int PV = P * V;
  const long long S = (long long)F * PV;
  const long long NS = (long long)N * S;
  T* s_tan = reinterpret_cast<T*>(smem);             // [V][D][8]
  T* s_pose = s_tan + 8LL * V * D;                    // [V][7]
  T* s_seg = s_pose + 7 * V;                          // [V][5]
  T* s_job = s_seg + 5 * V;                           // [V][kJobs][4]
  T* s_exp = s_job + 4 * kJobs * V;                   // [V][kJobs][3][8]
  const int span = kp * PV;                           // samples a block
  const int groups = kKnotThreads / span;
  const int j = threadIdx.x % span, g = threadIdx.x / span;
  const int pv = j % PV;
  const int p = pv / V, v = pv % V;
  const T fx = Kv[0], fy = Kv[1], cx = Kv[2], cy = Kv[3];
  // a sample's inputs that no pose enters: the unit ray of its pixel (the
  // thread design's arithmetic), its keypoint's depth and window corner
  struct Sample {
    V3<T> ray;
    T z, sx, sy;
  };
  auto sample_of = [&](int n) {
    const T* px = pix + (((long long)f * N + n) * P + p) * 2;
    const T x_hat = (px[0] - cx) / fx;
    const T y_hat = (px[1] - cy) / fy;
    const T z_hat = T(1) / sqrt(T(1) + x_hat * x_hat + y_hat * y_hat);
    return Sample{{x_hat * z_hat, y_hat * z_hat, z_hat}, kp_z[n], (T)starts[2 * n],
                  (T)starts[2 * n + 1]};
  };
  // the first block's, loaded and computed while the poses are
  const int n_first = blockIdx.x * kp + j / PV;
  Sample first{};
  if (g < groups && n_first < N) first = sample_of(n_first);
  frame_poses<T, degree>(knot_t, knot_q, K, *t0p, *dtp, cap[f], expo[f], V, D, s_pose, s_tan,
                         s_seg, s_job, s_exp);
  __syncthreads();

  if (g >= groups) return;
  const T* q = s_pose + v * 7 + 3;
  const T* t = s_pose + v * 7;
  const V3<T> xyz = {q[0], q[1], q[2]};
  const T w = q[3];
  const T* tan_v = s_tan + (long long)v * D * 8;
  const int blocks = (N + kp - 1) / kp;
  for (int blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
    const int n = blk * kp + j / PV;
    if (n >= N) continue;
    const long long o = (long long)n * S + (long long)f * PV + pv;
    // the warp, as the thread design computes it
    const Sample sm = blk == (int)blockIdx.x ? first : sample_of(n);
    const V3<T> ray = sm.ray;
    V3<T> u = cross(xyz, ray);
    u = {T(2) * u.x, T(2) * u.y, T(2) * u.z};
    const V3<T> xu = cross(xyz, u);
    const V3<T> rot = {ray.x + w * u.x + xu.x, ray.y + w * u.y + xu.y, ray.z + w * u.z + xu.z};
    const T lam = rot.z;
    const T s = (sm.z - t[2]) / lam;
    const V3<T> Pw = {rot.x * s + t[0], rot.y * s + t[1], rot.z * s + t[2]};
    const T iz = T(1) / (Pw.z + T(1e-8));
    const T rx = fx * Pw.x * iz + cx;
    const T ry = fy * Pw.y * iz + cy;
    if (g == 0) {
      loc[2 * o] = rx - sm.sx;
      loc[2 * o + 1] = ry - sm.sy;
      vs[o] = (rx >= T(0) && rx <= T(W - 1) && ry >= T(0) && ry <= T(H - 1)) ? T(1) : T(0);
    }
    if (D == 0) continue;
    // the chain rule of ops/warp.py::frontoparallel_warp_jvp as a linear map
    // of the pose tangent e = (dt, dxyz, dw): drot = u dw + M dxyz with
    // M = -2w [ray]x - [u]x - 2 [xyz]x [ray]x (du = 2 dxyz x ray), ds =
    // -(dt.z + s drot.z) / lam, dP = s drot + rot ds + dt, and
    // dx = fx iz (dP.x - Pw.x iz dP.z), dy = fy iz (dP.y - Pw.y iz dP.z).
    // The tangents are held to the plain version within a tolerance, not to
    // the bit, so their arithmetic fuses multiply-adds
    T M[3][3];
    {
      // [xyz]x [ray]x = ray xyz^T - (xyz . ray) I
      const T xr = fma(xyz.z, ray.z, fma(xyz.y, ray.y, xyz.x * ray.x));
      const T a[3] = {xyz.x, xyz.y, xyz.z}, b[3] = {ray.x, ray.y, ray.z};
      const T uu[3] = {u.x, u.y, u.z};
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          // [v]x[r][k] = -eps(r, k, l) v_l
          const int l = 3 - r - k;
          const T sgn = (r == k) ? T(0) : (((k - r + 3) % 3 == 1) ? T(-1) : T(1));
          const T hr = r == k ? T(0) : sgn * b[l], hu = r == k ? T(0) : sgn * uu[l];
          const T xx = fma(b[r], a[k], r == k ? -xr : T(0));
          M[r][k] = fma(T(-2), xx, fma(T(-2) * w, hr, -hu));
        }
    }
    const T inv_lam = T(1) / lam;
    T Dz[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const T rz = k < 3 ? T(0) : (k < 6 ? M[2][k - 3] : u.z);
      Dz[k] = -fma(s, rz, k == 2 ? T(1) : T(0)) * inv_lam;
    }
    T ax[7], ay[7];
    const T fxi = fx * iz, fyi = fy * iz, px_iz = Pw.x * iz, py_iz = Pw.y * iz;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      T Q[3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const T ur = r == 0 ? u.x : (r == 1 ? u.y : u.z);
        const T rr = r == 0 ? rot.x : (r == 1 ? rot.y : rot.z);
        const T Rk = k < 3 ? T(0) : (k < 6 ? M[r][k - 3] : ur);
        Q[r] = fma(s, Rk, fma(rr, Dz[k], k == r ? T(1) : T(0)));
      }
      ax[k] = fxi * fma(-px_iz, Q[2], Q[0]);
      ay[k] = fyi * fma(-py_iz, Q[2], Q[1]);
    }
    T* ox = dxy + (long long)g * NS + o;
    T* oy = ox + (long long)D * NS;
    const long long step = (long long)groups * NS;
    for (int d = g; d < D; d += groups, ox += step, oy += step) {
      T e[8];
      load8(tan_v + d * 8, e);
      T sx = ax[0] * e[0], sy = ay[0] * e[0];
#pragma unroll
      for (int k = 1; k < 7; ++k) {
        sx = fma(ax[k], e[k], sx);
        sy = fma(ay[k], e[k], sy);
      }
      *ox = sx;
      *oy = sy;
    }
  }
}

// three CTAs an SM: the registers of a thread capped at 85 (float32 keeps
// them all; float64 spills a few)
template <typename T>
__global__ void __launch_bounds__(kKnotThreads, 3)
warp_tangents_kernel(const T* __restrict__ knot_t,   // [K, 3]
                     const T* __restrict__ knot_q,   // [K, 4]
                     const T* __restrict__ t0p,      // spline start time
                     const T* __restrict__ dtp,      // knot interval
                     const T* __restrict__ cap,      // [F] capture times
                     const T* __restrict__ expo,     // [F] exposure times
                     const T* __restrict__ kp_z,     // [N]
                     const T* __restrict__ Kv,       // [4]
                     const T* __restrict__ pix,      // [F, N, P, 2]
                     const int64_t* __restrict__ starts,  // [N, 2]
                     T* __restrict__ loc,            // [N, S, 2]
                     T* __restrict__ vs,             // [N, S]
                     T* __restrict__ dxy,            // [2, D, N, S]
                     int K, int degree, int N, int F, int P, int V, int D, int H, int W,
                     int kp) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (degree == 2)
    knots_body<T, 2>(knot_t, knot_q, t0p, dtp, cap, expo, kp_z, Kv, pix, starts, loc, vs, dxy,
                     K, N, F, P, V, D, H, W, kp, smem);
  else
    knots_body<T, 4>(knot_t, knot_q, t0p, dtp, cap, expo, kp_z, Kv, pix, starts, loc, vs, dxy,
                     K, N, F, P, V, D, H, W, kp, smem);
}

template <typename T>
int launch_warp_tangents(const void* knot_t, const void* knot_q, const void* t0,
                         const void* dt, const void* cap, const void* expo, const void* kp_z,
                         const void* Kv, const void* pix, const void* starts, void* loc,
                         void* vs, void* dxy, int K, int degree, int N, int F, int P, int V,
                         int D, int H, int W, int kp, long long smem, void* stream) {
  if (kp < 1 || (degree != 2 && degree != 4) || K < degree || V < 1 || N < 1 || F < 1 ||
      F > 65535 || P < 1 || kp * P * V > kKnotThreads || (D != 0 && D != 6 * K) ||
      D > kMaxTangents || smem != knots_smem_bytes(V, D, (int)sizeof(T)) || smem > kMaxShared)
    return (int)cudaErrorInvalidValue;
  // the device whose attribute is set, its SMs and the CTAs an SM holds
  static int ready_on = -1, sms = 0;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != ready_on) {
    err = cudaFuncSetAttribute(warp_tangents_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    ready_on = device;
  }
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, warp_tangents_kernel<T>,
                                                      kKnotThreads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  // one wave: a frame's CTAs loop over its keypoint blocks, so that each
  // computes the frame's poses once for as many blocks as the card allows
  const int blocks = (N + kp - 1) / kp;
  const int wave = (resident > 0 ? resident : 1) * sms;
  const int per_frame = blocks < (wave + F - 1) / F ? blocks : (wave + F - 1) / F;
  const dim3 grid((unsigned)(per_frame > 0 ? per_frame : 1), (unsigned)F);
  warp_tangents_kernel<T><<<grid, kKnotThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)knot_t, (const T*)knot_q, (const T*)t0, (const T*)dt, (const T*)cap,
      (const T*)expo, (const T*)kp_z, (const T*)Kv, (const T*)pix, (const int64_t*)starts,
      (T*)loc, (T*)vs, (T*)dxy, K, degree, N, F, P, V, D, H, W, kp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp_tangents_threads(const void* pose_t, const void* pose_q, const void* dpose,
                         const void* kp_z, const void* Kv, const void* pix, const void* starts,
                         void* loc, void* vs, void* dxy, int N, int F, int P, int V, int D,
                         int H, int W, void* stream) {
  const long long samples = (long long)N * F * P * V;
  const unsigned grid = (unsigned)((samples + kWarpThreads - 1) / kWarpThreads);
  warp_tangents_threads_kernel<T><<<grid, kWarpThreads, 0, (cudaStream_t)stream>>>(
      (const T*)pose_t, (const T*)pose_q, (const T*)dpose, (const T*)kp_z, (const T*)Kv,
      (const T*)pix, (const int64_t*)starts, (T*)loc, (T*)vs, (T*)dxy, N, F, P, V, D, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_blur_rows(const void* val, const void* gx, const void* gy, long long row_stride,
                     const void* dxy, const void* obs, const void* valid, void* out_r,
                     void* out_j, int N, int F, int P, int V, int D, int affine,
                     void* stream) {
  const long long rows = (long long)F * N * P;
  const unsigned blocks = (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  blur_rows_kernel<T><<<blocks, kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const T*)val, (const T*)gx, (const T*)gy, row_stride, (const T*)dxy, (const T*)obs,
      (const uint8_t*)valid, (T*)out_r, (T*)out_j, N, F, P, V, D, affine);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_blur_keypoint(const void* val, const void* gx, const void* gy, long long row_stride,
                         const void* dxy, const void* obs, const void* valid, void* out_r,
                         void* out_j, int N, int F, int P, int V, int D, int affine, int tile,
                         int threads, int interleaved, long long smem, void* stream) {
  const int stages = D > tile ? 2 : 1;
  const long long S = (long long)F * P * V;
  const bool layout_ok =
      !interleaved || (row_stride == 3 * S && (const T*)gx == (const T*)val + S &&
                       (const T*)gy == (const T*)val + 2 * S);
  if (tile < 1 || threads < 32 || threads > 1024 || threads % 32 != 0 || !layout_ok ||
      3 * S >= (1LL << 31) ||
      smem != blur_layout(F, P, V, (int)sizeof(T), tile, stages).total || smem > kMaxShared)
    return (int)cudaErrorInvalidValue;
  static int ready_on = -1;   // the device whose attribute is set
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != ready_on) {
    err = cudaFuncSetAttribute(blur_rows_keypoint_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err != cudaSuccess) return (int)err;
    ready_on = device;
  }
  blur_rows_keypoint_kernel<T><<<(unsigned)N, threads, (size_t)smem, (cudaStream_t)stream>>>(
      (const T*)val, (const T*)gx, (const T*)gy, row_stride, (const T*)dxy, (const T*)obs,
      (const uint8_t*)valid, (T*)out_r, (T*)out_j, N, F, P, V, D, affine, tile, interleaved);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int residual_rows_max_tangents() { return kMaxTangents; }

#define WARP_ARGS                                                                      \
  const void *pose_t, const void *pose_q, const void *dpose, const void *kp_z,         \
      const void *Kv, const void *pix, const void *starts, void *loc, void *vs,        \
      void *dxy, int N, int F, int P, int V, int D, int H, int W, void *stream
#define WARP_PASS \
  pose_t, pose_q, dpose, kp_z, Kv, pix, starts, loc, vs, dxy, N, F, P, V, D, H, W, stream

// the knots design: from the spline knots, kp keypoints of one frame a CTA
// and the dynamic shared memory, from the wrapper's layout (checked here)
#define KNOTS_ARGS                                                                     \
  const void *knot_t, const void *knot_q, const void *t0, const void *dt,              \
      const void *cap, const void *expo, const void *kp_z, const void *Kv,             \
      const void *pix, const void *starts, void *loc, void *vs, void *dxy, int K,      \
      int degree, int N, int F, int P, int V, int D, int H, int W, int kp,             \
      long long smem, void *stream
#define KNOTS_PASS                                                                     \
  knot_t, knot_q, t0, dt, cap, expo, kp_z, Kv, pix, starts, loc, vs, dxy, K, degree, N, \
      F, P, V, D, H, W, kp, smem, stream

int warp_tangents_f32(KNOTS_ARGS) { return launch_warp_tangents<float>(KNOTS_PASS); }
int warp_tangents_f64(KNOTS_ARGS) { return launch_warp_tangents<double>(KNOTS_PASS); }

// the thread design, from given poses and pose tangents
int warp_tangents_threads_f32(WARP_ARGS) { return launch_warp_tangents_threads<float>(WARP_PASS); }
int warp_tangents_threads_f64(WARP_ARGS) { return launch_warp_tangents_threads<double>(WARP_PASS); }

#define BLUR_ARGS_NO_STREAM                                                            \
  const void *val, const void *gx, const void *gy, long long row_stride,               \
      const void *dxy, const void *obs, const void *valid, void *out_r, void *out_j,   \
      int N, int F, int P, int V, int D, int affine
#define BLUR_ARGS BLUR_ARGS_NO_STREAM, void *stream
#define BLUR_PASS \
  val, gx, gy, row_stride, dxy, obs, valid, out_r, out_j, N, F, P, V, D, affine, stream

// the thread design
int blur_rows_threads_f32(BLUR_ARGS) { return launch_blur_rows<float>(BLUR_PASS); }
int blur_rows_threads_f64(BLUR_ARGS) { return launch_blur_rows<double>(BLUR_PASS); }

// the keypoint design: tangent tile, threads, whether val, gx and gy are
// K1's interleaved channels (else three [N, S] runs row_stride apart) and
// the dynamic shared memory, from the wrapper's layout (checked here)
#define KEYPOINT_ARGS \
  BLUR_ARGS_NO_STREAM, int tile, int threads, int interleaved, long long smem, void *stream
#define KEYPOINT_PASS                                                                   \
  val, gx, gy, row_stride, dxy, obs, valid, out_r, out_j, N, F, P, V, D, affine, tile, \
      threads, interleaved, smem, stream

int blur_rows_f32(KEYPOINT_ARGS) { return launch_blur_keypoint<float>(KEYPOINT_PASS); }
int blur_rows_f64(KEYPOINT_ARGS) { return launch_blur_keypoint<double>(KEYPOINT_PASS); }

}  // extern "C"
