// K2: the tracker's residual and Jacobian rows for Hopper (sm_90a), two
// entry points around the sampler K1.
//
// Replaces the XLA fusion of mba_vo_tpu/ops/residual.py:429-466
// (residuals_of under jax.linearize): no Pallas source, XLA fused it on the
// TPU. The port ran it as a few hundred eager torch ops an evaluation.
//
//   warp_tangents: every sample (n, f, p, v) -- patch pixel p of keypoint n
//     in frame f, warped by virtual pose v into the keyframe -- gives its
//     window-local coordinate loc = warp - start_n, its in-image flag vs
//     and the derivative dxy of the warped position along the D knot
//     tangents, from the pose tangents dpose [D, F, V, 7]. One thread a
//     sample, in the samples' order n S + s, so that for each tangent the
//     threads of a warp write consecutive entries of dxy, laid out
//     [2, D, N, S] (x and y planes, tangent-major). The pose tangents come
//     through the L1 (a warp's samples share a few (f, v)). The math is
//     ops/warp.py::frontoparallel_warp_jvp, step by step (1e-8 guard on
//     the z division included).
//   blur_rows: after K1 has sampled (I, dI/dx, dI/dy) at every loc, one
//     thread an (f, n, p) averages the V samples (the blur model), and the
//     tangent row mean_v (gx dx + gy dy); it writes r = pred - obs and the J
//     row where the patch pixel is valid (0 elsewhere), or pred and its
//     tangent unmasked when the affine elimination follows in torch. The
//     loop runs over d outside and v inside, so no D-long array lives in
//     registers (D = 66 at a joint chunk of 8 at degree 4); the block's J
//     rows pass through shared memory 32 tangents at a time, so that they
//     leave in contiguous runs.
//
// What bounds it on the card: the bytes of dxy, written once and read once
// (N F P V 2 D items: 2 MB at the frame's shapes in f32, 0.6 us at 3.35
// TB/s), less than one launch. A one-pass design whose stores coalesce is
// enough; keeping dxy out of device memory (blur_rows recomputing the warp
// tangents, or the normal equations fused into blur_rows) is later work.
//
// Semantics kept from the plain versions (ops/residual.py's
// warp_tangents_plain and blur_rows_plain):
//   * the warped position is the plain version's to the bit: the build
//     compiles this file with -fmad=false (ops/cuda_build.py) and the warp
//     runs the plain version's operations in its order, each rounded once,
//     as torch's elementwise kernels round them. A multiply-add contracted
//     into one rounding moves a position by an ulp, and where the integer
//     patch pixels of a standing start warp onto the image's border that
//     flips the in-image flag;
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

#ifndef MAX_TANGENTS
#error "MAX_TANGENTS (the largest number of knot tangents a launch may take) must be defined by the build"
#endif

namespace {

constexpr int kMaxTangents = MAX_TANGENTS;
// threads a block of warp_tangents
constexpr int kWarpThreads = 128;

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ V3<T> cross(V3<T> a, V3<T> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

template <typename T>
__global__ void __launch_bounds__(kWarpThreads)
warp_tangents_kernel(const T* __restrict__ pose_t,   // [F, V, 3]
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

// J columns a block stages in shared memory at once, and threads a block
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

template <typename T>
int launch_warp_tangents(const void* pose_t, const void* pose_q, const void* dpose,
                         const void* kp_z, const void* Kv, const void* pix, const void* starts,
                         void* loc, void* vs, void* dxy, int N, int F, int P, int V, int D,
                         int H, int W, void* stream) {
  const long long samples = (long long)N * F * P * V;
  const unsigned grid = (unsigned)((samples + kWarpThreads - 1) / kWarpThreads);
  warp_tangents_kernel<T><<<grid, kWarpThreads, 0, (cudaStream_t)stream>>>(
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

}  // namespace

extern "C" {

int residual_rows_max_tangents() { return kMaxTangents; }

#define WARP_ARGS                                                                      \
  const void *pose_t, const void *pose_q, const void *dpose, const void *kp_z,         \
      const void *Kv, const void *pix, const void *starts, void *loc, void *vs,        \
      void *dxy, int N, int F, int P, int V, int D, int H, int W, void *stream
#define WARP_PASS \
  pose_t, pose_q, dpose, kp_z, Kv, pix, starts, loc, vs, dxy, N, F, P, V, D, H, W, stream

int warp_tangents_f32(WARP_ARGS) { return launch_warp_tangents<float>(WARP_PASS); }
int warp_tangents_f64(WARP_ARGS) { return launch_warp_tangents<double>(WARP_PASS); }

#define BLUR_ARGS                                                                      \
  const void *val, const void *gx, const void *gy, long long row_stride,               \
      const void *dxy, const void *obs, const void *valid, void *out_r, void *out_j,   \
      int N, int F, int P, int V, int D, int affine, void *stream
#define BLUR_PASS \
  val, gx, gy, row_stride, dxy, obs, valid, out_r, out_j, N, F, P, V, D, affine, stream

int blur_rows_f32(BLUR_ARGS) { return launch_blur_rows<float>(BLUR_PASS); }
int blur_rows_f64(BLUR_ARGS) { return launch_blur_rows<double>(BLUR_PASS); }

}  // extern "C"
