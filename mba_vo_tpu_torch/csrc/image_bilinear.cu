// K4: the direct path's whole-image Lucas-Kanade sampler for Hopper
// (sm_90a).
//
// Replaces the sampling that XLA fuses into mba_vo_tpu/ops/residual.py's
// compute_residuals (:273-320): warp_and_sample (ops/warp.py:65) ->
// sample_lk (ops/image.py:142-155, its JVP :161-172) -> bilinear_sample
// (:113-139, _gather4 :103-110). No Pallas source: XLA fused the gather on
// the TPU, and the port ran it as a stack of the three planes and a torch
// gather (ops/image.py::sample_lk_with_gradient).
//
// For every sample (n, s) at the whole-image position loc[n, s] = (x, y) it
// writes the bilinear sample of img_ref [H, W] and, with C = 3, of both
// channels of grad_ref [H, W, 2] (the Lucas-Kanade gradient of the sample),
// out[n, c, s] (c: value, d/dx, d/dy), the layout K1 writes, so that K2's
// blur_rows reads a keypoint's three runs as one. The planes are read in
// place, in the layout TrackingLevelData holds them: no stacked copy.
//
// What bounds it on the card: latency. At the tracker's shapes (N = 512,
// S = F P V = 40 a frame, 160 a joint chunk of 4) the bytes it must move
// (the positions, the outputs and the image pixels the taps touch) take
// 0.1-1 us at 3.35 TB/s, less than one launch. One thread a sample: it
// loads its position, then the taps whose addresses depend on it (for
// C = 3 each of the four corners' gradient pair as one 8- or 16-byte load),
// two dependent trips to memory.
//
// Semantics kept from the plain version (ops/image.py's
// image_bilinear_lk_plain, i.e. bilinear_sample), to the bit: the build
// compiles this file with -fmad=false (ops/cuda_build.py), and each thread
// runs the plain version's operations in its order, each rounded once:
//   * floor, dx = x - floor(x), the corner indices clamped into the image;
//   * (1 - dx - dy + dxdy) v00 + (dx - dxdy) v01 + (dy - dxdy) v10 +
//     dxdy v11, summed left to right;
//   * 0 unless the position lies in [0, W-1] x [0, H-1] (in_bounds): a
//     position off the image or NaN gives 0 in every channel (K1, by
//     contrast, returns NaN for a NaN position).
// The kernel allocates nothing and does not synchronise; the C entry points
// return the CUDA error of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
image_bilinear_kernel(const T* __restrict__ img,    // [H, W]
                      const T* __restrict__ grad,   // [H, W, 2]
                      const T* __restrict__ loc,    // [N, S, 2]
                      T* __restrict__ out,          // [N, C, S]
                      int N, int S, int H, int W, int C) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;   // n S + s
  if (i >= (long long)N * S) return;
  const long long n = i / S;
  const long long s = i - n * S;
  const T x = loc[2 * i], y = loc[2 * i + 1];
  T* o = out + n * C * S + s;
  // in_bounds: false for a NaN coordinate
  if (!(x >= T(0) && x <= T(W - 1) && y >= T(0) && y <= T(H - 1))) {
    for (int c = 0; c < C; ++c) o[(long long)c * S] = T(0);
    return;
  }
  const T xf = floor(x), yf = floor(y);
  const T dx = x - xf, dy = y - yf;
  // the plain version's clamps in float, then the index
  const long long x0 = (long long)fmin(fmax(xf, T(0)), T(W - 1));
  const long long y0 = (long long)fmin(fmax(yf, T(0)), T(H - 1));
  const long long x1 = (long long)fmin(fmax(xf + T(1), T(0)), T(W - 1));
  const long long y1 = (long long)fmin(fmax(yf + T(1), T(0)), T(H - 1));
  const long long i00 = y0 * W + x0, i01 = y0 * W + x1, i10 = y1 * W + x0, i11 = y1 * W + x1;
  const T dxdy = dx * dy;
  const T w00 = ((T(1) - dx) - dy) + dxdy;
  const T w01 = dx - dxdy;
  const T w10 = dy - dxdy;
  auto bilinear = [&](T v00, T v01, T v10, T v11) {
    return ((w00 * v00 + w01 * v01) + w10 * v10) + dxdy * v11;
  };
  o[0] = bilinear(__ldg(img + i00), __ldg(img + i01), __ldg(img + i10), __ldg(img + i11));
  if (C == 1) return;
  using P2 = typename Pair<T>::type;
  const P2* g = reinterpret_cast<const P2*>(grad);
  const P2 g00 = __ldg(g + i00), g01 = __ldg(g + i01), g10 = __ldg(g + i10),
           g11 = __ldg(g + i11);
  o[S] = bilinear(g00.x, g01.x, g10.x, g11.x);
  o[2LL * S] = bilinear(g00.y, g01.y, g10.y, g11.y);
}

template <typename T>
int launch_image_bilinear(const void* img, const void* grad, const void* loc, void* out,
                          int N, int S, int H, int W, int C, void* stream) {
  if (N < 0 || S < 0 || H < 1 || W < 1 || (C != 1 && C != 3) ||
      (long long)N * S * C >= (1LL << 62) || (C == 3 && ((uintptr_t)grad % (2 * sizeof(T)))))
    return (int)cudaErrorInvalidValue;
  const long long samples = (long long)N * S;
  if (samples == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((samples + kThreads - 1) / kThreads);
  image_bilinear_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)img, (const T*)grad, (const T*)loc, (T*)out, N, S, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int image_bilinear_f32(const void* img, const void* grad, const void* loc, void* out, int N,
                       int S, int H, int W, int C, void* stream) {
  return launch_image_bilinear<float>(img, grad, loc, out, N, S, H, W, C, stream);
}

int image_bilinear_f64(const void* img, const void* grad, const void* loc, void* out, int N,
                       int S, int H, int W, int C, void* stream) {
  return launch_image_bilinear<double>(img, grad, loc, out, N, S, H, W, C, stream);
}

}  // extern "C"
