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
// 0.1-1 us at 3.35 TB/s, less than one launch. A sample is two dependent
// trips to memory, its position and then the taps whose addresses depend on
// it; what lies between them, and how many of the taps are in flight at
// once, is the time past the launch.
//
// Three designs, equal to the bit:
//   * image_bilinear_kernel (the select design, which the tracker launches):
//     one thread a sample, kThreads a block, 32-bit indices throughout (the
//     wrapper bounds H W and N S C below 2^31), n = i / S as a 64-bit
//     product with the wrapper's constant m and a shift k
//     (ops/cuda_image.py's sample_divisor: exact for every i < 2^31), the
//     position as one 8- or 16-byte load, the four corners' indices without
//     a branch (the clamps take a NaN or infinite coordinate into the
//     image), every tap load issued back to back before any arithmetic
//     (C = 3: the value's four and the gradient pairs' four), then the
//     in-image test selects 0;
//   * image_bilinear_interleaved_kernel (a timed row): the same from one
//     [H, W, 4] plane (value, d/dx, d/dy, 0) built outside, one 16-byte load
//     a corner in float32 (two in float64);
//   * image_bilinear_branch_kernel (the first design, the earlier one, a timed
//     row): one thread a sample, 64-bit indices and a 64-bit i / S, the
//     position as two scalar loads, a branch to 0 off the image before any
//     tap, the value's taps, then the gradient's.
// The tracker launches the select design. The interleaved row is the
// faster warm on the direct path's recorded calls, but only with its plane
// built beforehand, once a keyframe level: that build costs the host more
// than the row saves the card on this host-bound path, so the tracker does
// not build it (PERF.md section 6 has both numbers).
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
// The kernels allocate nothing and do not synchronise; the C entry points
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

// the plain version's four weights and its sum, left to right
template <typename T>
struct Weights {
  T w00, w01, w10, w11;
  __device__ __forceinline__ Weights(T dx, T dy) {
    w11 = dx * dy;
    w00 = ((T(1) - dx) - dy) + w11;
    w01 = dx - w11;
    w10 = dy - w11;
  }
  __device__ __forceinline__ T operator()(T v00, T v01, T v10, T v11) const {
    return ((w00 * v00 + w01 * v01) + w10 * v10) + w11 * v11;
  }
};

// A sample's position, in-image test and corners: the plain version's clamps
// in float, then the 32-bit indices. A NaN coordinate clamps to 0 and an
// infinite one to the border (fmax/fmin take the number), so every index
// lies in the image and no branch precedes the taps; the in-image test
// then selects 0 for such a position.
template <typename T>
struct Corners {
  T dx, dy;
  bool inside;
  int i00, i01, i10, i11;
  __device__ __forceinline__ Corners(T x, T y, int H, int W) {
    inside = x >= T(0) && x <= T(W - 1) && y >= T(0) && y <= T(H - 1);   // false at NaN
    const T xf = floor(x), yf = floor(y);
    dx = x - xf;
    dy = y - yf;
    const int x0 = (int)fmin(fmax(xf, T(0)), T(W - 1));
    const int y0 = (int)fmin(fmax(yf, T(0)), T(H - 1));
    const int x1 = (int)fmin(fmax(xf + T(1), T(0)), T(W - 1));
    const int y1 = (int)fmin(fmax(yf + T(1), T(0)), T(H - 1));
    i00 = y0 * W + x0;
    i01 = y0 * W + x1;
    i10 = y1 * W + x0;
    i11 = y1 * W + x1;
  }
};

// The select design. Thread t of block b takes sample i = b kThreads + t;
// n = (i m) >> k.
template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
image_bilinear_kernel(const T* __restrict__ img,    // [H, W]
                      const T* __restrict__ grad,   // [H, W, 2]
                      const T* __restrict__ loc,    // [N, S, 2]
                      T* __restrict__ out,          // [N, C, S]
                      int total, int S, int H, int W, unsigned m, int k) {
  using P2 = typename Pair<T>::type;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const P2 xy = __ldg(reinterpret_cast<const P2*>(loc) + i);
  const Corners<T> c(xy.x, xy.y, H, W);
  const T v00 = __ldg(img + c.i00), v01 = __ldg(img + c.i01), v10 = __ldg(img + c.i10),
          v11 = __ldg(img + c.i11);
  P2 g00, g01, g10, g11;
  if (C == 3) {
    const P2* g = reinterpret_cast<const P2*>(grad);
    g00 = __ldg(g + c.i00);
    g01 = __ldg(g + c.i01);
    g10 = __ldg(g + c.i10);
    g11 = __ldg(g + c.i11);
  }
  const int n = (int)(((unsigned long long)(unsigned)i * m) >> k);
  T* o = out + n * C * S + (i - n * S);
  const Weights<T> w(c.dx, c.dy);
  o[0] = c.inside ? w(v00, v01, v10, v11) : T(0);
  if (C == 3) {
    o[S] = c.inside ? w(g00.x, g01.x, g10.x, g11.x) : T(0);
    o[2 * S] = c.inside ? w(g00.y, g01.y, g10.y, g11.y) : T(0);
  }
}

// The interleaved row: C = 3 from plane [H, W, 4] = (value, d/dx, d/dy, 0),
// one thread a sample, one 16-byte load a corner in float32, two in float64.
template <typename T>
__global__ void __launch_bounds__(kThreads)
image_bilinear_interleaved_kernel(const T* __restrict__ plane,   // [H, W, 4]
                                  const T* __restrict__ loc,     // [N, S, 2]
                                  T* __restrict__ out,           // [N, 3, S]
                                  int total, int S, int H, int W, unsigned m, int k) {
  using P2 = typename Pair<T>::type;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const P2 xy = __ldg(reinterpret_cast<const P2*>(loc) + i);
  const Corners<T> c(xy.x, xy.y, H, W);
  T val[4], gx[4], gy[4];
  if constexpr (sizeof(T) == 4) {
    const float4* p = reinterpret_cast<const float4*>(plane);
    const float4 a = __ldg(p + c.i00), b = __ldg(p + c.i01), d = __ldg(p + c.i10),
                 e = __ldg(p + c.i11);
    val[0] = a.x; val[1] = b.x; val[2] = d.x; val[3] = e.x;
    gx[0] = a.y; gx[1] = b.y; gx[2] = d.y; gx[3] = e.y;
    gy[0] = a.z; gy[1] = b.z; gy[2] = d.z; gy[3] = e.z;
  } else {
    const double2* p = reinterpret_cast<const double2*>(plane);
    const int at[4] = {c.i00, c.i01, c.i10, c.i11};
    double2 lo[4], hi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      lo[r] = __ldg(p + 2 * at[r]);
      hi[r] = __ldg(p + 2 * at[r] + 1);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      val[r] = lo[r].x;
      gx[r] = lo[r].y;
      gy[r] = hi[r].x;
    }
  }
  const int n = (int)(((unsigned long long)(unsigned)i * m) >> k);
  T* o = out + n * 3 * S + (i - n * S);
  const Weights<T> w(c.dx, c.dy);
  o[0] = c.inside ? w(val[0], val[1], val[2], val[3]) : T(0);
  o[S] = c.inside ? w(gx[0], gx[1], gx[2], gx[3]) : T(0);
  o[2 * S] = c.inside ? w(gy[0], gy[1], gy[2], gy[3]) : T(0);
}

// The first design, kept as the earlier one (the branch design)
template <typename T>
__global__ void __launch_bounds__(kThreads)
image_bilinear_branch_kernel(const T* __restrict__ img,    // [H, W]
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
  const Weights<T> w(dx, dy);
  o[0] = w(__ldg(img + i00), __ldg(img + i01), __ldg(img + i10), __ldg(img + i11));
  if (C == 1) return;
  using P2 = typename Pair<T>::type;
  const P2* g = reinterpret_cast<const P2*>(grad);
  const P2 g00 = __ldg(g + i00), g01 = __ldg(g + i01), g10 = __ldg(g + i10),
           g11 = __ldg(g + i11);
  o[S] = w(g00.x, g01.x, g10.x, g11.x);
  o[2LL * S] = w(g00.y, g01.y, g10.y, g11.y);
}

// a check of the wrapper's constant: n = (i m) >> k equals i / S at the last
// sample (the constant is exact for every i < 2^31; a wrong one is refused,
// not run)
bool divisor_ok(int total, int S, unsigned m, int k) {
  if (S < 1 || k < 0 || k > 63) return false;
  const unsigned long long last = (unsigned long long)(total - 1);
  return ((last * m) >> k) == last / (unsigned long long)S;
}

template <typename T>
int launch_image_bilinear(const void* img, const void* grad, const void* loc, void* out,
                          int N, int S, int H, int W, int C, unsigned m, int k, void* stream) {
  const long long samples = (long long)N * S;
  if (N < 0 || S < 1 || H < 1 || W < 1 || (C != 1 && C != 3) ||
      (long long)H * W >= (1LL << 31) || samples * C >= (1LL << 31) ||
      (uintptr_t)loc % (2 * sizeof(T)) || (C == 3 && ((uintptr_t)grad % (2 * sizeof(T)))))
    return (int)cudaErrorInvalidValue;
  if (samples == 0) return (int)cudaSuccess;
  if (!divisor_ok((int)samples, S, m, k)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((samples + kThreads - 1) / kThreads);
  const T *im = (const T*)img, *gr = (const T*)grad, *lc = (const T*)loc;
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 3)
    image_bilinear_kernel<T, 3><<<grid, kThreads, 0, st>>>(im, gr, lc, (T*)out, (int)samples,
                                                           S, H, W, m, k);
  else
    image_bilinear_kernel<T, 1><<<grid, kThreads, 0, st>>>(im, gr, lc, (T*)out, (int)samples,
                                                           S, H, W, m, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_interleaved(const void* plane, const void* loc, void* out, int N, int S, int H,
                       int W, unsigned m, int k, void* stream) {
  const long long samples = (long long)N * S;
  if (N < 0 || S < 1 || H < 1 || W < 1 || (long long)H * W * 4 >= (1LL << 31) ||
      samples * 3 >= (1LL << 31) || (uintptr_t)loc % (2 * sizeof(T)) ||
      (uintptr_t)plane % 16)
    return (int)cudaErrorInvalidValue;
  if (samples == 0) return (int)cudaSuccess;
  if (!divisor_ok((int)samples, S, m, k)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((samples + kThreads - 1) / kThreads);
  image_bilinear_interleaved_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)plane, (const T*)loc, (T*)out, (int)samples, S, H, W, m, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_branch(const void* img, const void* grad, const void* loc, void* out, int N, int S,
                  int H, int W, int C, void* stream) {
  if (N < 0 || S < 0 || H < 1 || W < 1 || (C != 1 && C != 3) ||
      (long long)N * S * C >= (1LL << 62) || (C == 3 && ((uintptr_t)grad % (2 * sizeof(T)))))
    return (int)cudaErrorInvalidValue;
  const long long samples = (long long)N * S;
  if (samples == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((samples + kThreads - 1) / kThreads);
  image_bilinear_branch_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)img, (const T*)grad, (const T*)loc, (T*)out, N, S, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int image_bilinear_f32(const void* img, const void* grad, const void* loc, void* out, int N,
                       int S, int H, int W, int C, unsigned m, int k, void* stream) {
  return launch_image_bilinear<float>(img, grad, loc, out, N, S, H, W, C, m, k, stream);
}

int image_bilinear_f64(const void* img, const void* grad, const void* loc, void* out, int N,
                       int S, int H, int W, int C, unsigned m, int k, void* stream) {
  return launch_image_bilinear<double>(img, grad, loc, out, N, S, H, W, C, m, k, stream);
}

int image_bilinear_interleaved_f32(const void* plane, const void* loc, void* out, int N, int S,
                                   int H, int W, unsigned m, int k, void* stream) {
  return launch_interleaved<float>(plane, loc, out, N, S, H, W, m, k, stream);
}

int image_bilinear_interleaved_f64(const void* plane, const void* loc, void* out, int N, int S,
                                   int H, int W, unsigned m, int k, void* stream) {
  return launch_interleaved<double>(plane, loc, out, N, S, H, W, m, k, stream);
}

int image_bilinear_branch_f32(const void* img, const void* grad, const void* loc, void* out,
                              int N, int S, int H, int W, int C, void* stream) {
  return launch_branch<float>(img, grad, loc, out, N, S, H, W, C, stream);
}

int image_bilinear_branch_f64(const void* img, const void* grad, const void* loc, void* out,
                              int N, int S, int H, int W, int C, void* stream) {
  return launch_branch<double>(img, grad, loc, out, N, S, H, W, C, stream);
}

}  // extern "C"
