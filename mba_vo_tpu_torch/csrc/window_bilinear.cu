// K1: windowed bilinear sampler for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mba_vo_tpu/ops/pallas_sampling.py::
// pallas_window_bilinear (body _kernel). For every keypoint n it samples the
// keypoint's [C, win_h, win_w] window at S window-relative positions:
//
//   out[n, c, s] = valid[n, s] * sum_ij W[n,c,i,j] hat(y_ns - i) hat(x_ns - j)
//   hat(d) = max(0, 1 - |d|)
//
// The TPU kernel evaluated this as a dense hat-weight contraction on the
// matrix unit, because the TPU scalarises gathers. Hopper gathers natively,
// and only the 2x2 taps around (x, y) have non-zero weight, so this kernel
// is one thread per (n, s) sample doing a 4-tap read for each channel.
//
// What bounds it on the card: at the tracker's shape (N = 512 keypoints,
// C in {1, 3}, 32x32 windows, S = 40) the work is ~20k threads reading ~1 MB
// of windows (which sit in the 50 MB L2 after the first touch) and a few
// kFLOP each; it is bound by launch latency and gathered bytes, not FLOPs.
// Consecutive threads take consecutive s of one keypoint, so the coordinate
// reads and the [N, C, S] output writes are coalesced and the window reads
// of a warp fall in one or two windows.
//
// Semantics kept from the plain version (window_bilinear_plain):
//   * a tap outside [0, win_w) x [0, win_h) contributes 0 and is not clamped
//     to the edge (x = -0.5 gives 0.5 * W[.., 0]; >= 1 px beyond gives 0);
//   * windows may be rectangular;
//   * the sum runs over y first (per column), then over x;
//   * the output is multiplied by valid (0/1 as a float);
//   * a NaN coordinate yields NaN whatever valid is.
// The kernel allocates nothing and does not synchronise; the C entry points
// return cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T hat(T d) {
  T w = T(1) - fabs(d);
  return w > T(0) ? w : T(0);
}

template <typename T>
__global__ void window_bilinear_kernel(const T* __restrict__ win,
                                       const T* __restrict__ xy,
                                       const T* __restrict__ valid,
                                       T* __restrict__ out, int N, int C,
                                       int win_h, int win_w, int S) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)N * S) return;
  const long long n = t / S;
  const long long s = t - n * S;
  const T x = xy[2 * t];
  const T y = xy[2 * t + 1];
  const T v = valid[t];
  T* o = out + n * C * S + s;

  if (isnan(x) || isnan(y)) {
    const T nan_val = x + y;
    for (int c = 0; c < C; ++c) o[(long long)c * S] = nan_val;
    return;
  }

  // the two row and two column taps; a tap outside the window keeps weight
  // 0 and reads element 0 (finite), so it adds nothing
  const T fy = floor(y);
  const T fx = floor(x);
  const T ty[2] = {fy, fy + T(1)};
  const T tx[2] = {fx, fx + T(1)};
  T wy[2], wx[2];
  int iy[2], jx[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool in_y = ty[k] >= T(0) && ty[k] <= T(win_h - 1);
    const bool in_x = tx[k] >= T(0) && tx[k] <= T(win_w - 1);
    wy[k] = in_y ? hat(y - ty[k]) : T(0);
    wx[k] = in_x ? hat(x - tx[k]) : T(0);
    iy[k] = in_y ? (int)ty[k] : 0;
    jx[k] = in_x ? (int)tx[k] : 0;
  }

  const long long plane = (long long)win_h * win_w;
  const T* w = win + n * C * plane;
  for (int c = 0; c < C; ++c, w += plane) {
    // y first: the two column sums, then the x combination
    const T a0 = w[iy[0] * win_w + jx[0]] * wy[0] + w[iy[1] * win_w + jx[0]] * wy[1];
    const T a1 = w[iy[0] * win_w + jx[1]] * wy[0] + w[iy[1] * win_w + jx[1]] * wy[1];
    o[(long long)c * S] = (a0 * wx[0] + a1 * wx[1]) * v;
  }
}

template <typename T>
int launch(const void* win, const void* xy, const void* valid, void* out,
           int N, int C, int win_h, int win_w, int S, int threads,
           void* stream) {
  const long long total = (long long)N * S;
  if (total == 0 || C == 0) return (int)cudaSuccess;
  if (threads < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + threads - 1) / threads;
  window_bilinear_kernel<T><<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>(
      (const T*)win, (const T*)xy, (const T*)valid, (T*)out, N, C, win_h,
      win_w, S);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_bilinear_f32(const void* win, const void* xy,
                                   const void* valid, void* out, int N, int C,
                                   int win_h, int win_w, int S, int threads,
                                   void* stream) {
  return launch<float>(win, xy, valid, out, N, C, win_h, win_w, S, threads, stream);
}

extern "C" int window_bilinear_f64(const void* win, const void* xy,
                                   const void* valid, void* out, int N, int C,
                                   int win_h, int win_w, int S, int threads,
                                   void* stream) {
  return launch<double>(win, xy, valid, out, N, C, win_h, win_w, S, threads, stream);
}
