// K1-v: the windowed bilinear sampler with its windows staged in shared
// memory, for Hopper (sm_90a).
//
// Replaces the Pallas TPU variant experiments/kernel_variants_r04.py::
// run_v0_tile (the body mba_vo_tpu/ops/pallas_sampling.py::_kernel at a fixed
// tile of keypoints per grid step). It computes exactly what K1
// (window_bilinear.cu) computes:
//
//   out[n, c, s] = valid[n, s] * sum_ij W[n,c,i,j] hat(y_ns - i) hat(x_ns - j)
//   hat(d) = max(0, 1 - |d|)
//
// What the variant varies. On the TPU the tile fixed how many keypoints'
// windows sat in the core's fast memory per grid step. The scarce fast
// memory of an SM is a block's shared memory, so here one thread block owns
// TILE consecutive keypoints: it copies their [TILE, C, win_h, win_w]
// windows (contiguous in device memory) into dynamic shared memory with
// coalesced 16-byte loads, then its threads walk the tile's TILE * S samples
// and read the 2x2 taps of each channel from shared memory. TILE and the
// threads per block are launch parameters. The TPU's tiles of 64 and 128
// keypoints cannot exist here: a block may use 227 KB (232,448 bytes) of
// shared memory, which holds 18 windows of [3, 32, 32] floats, not 64. The
// dense hat-weight contraction of the TPU body is not carried over: it
// existed because the TPU scalarises gathers.
//
// What bounds it on the card: bytes. The staging copy reads every window
// once (6.29 MB at N = 512, C = 3, 32x32, f32, whatever S is) where K1 reads
// only the taps its samples touch, at most 4 * C * S elements a keypoint.
// With few samples per keypoint (S = 40) the tiled kernel moves many times
// the window bytes the function needs; with many (S = 320) the two come
// closer and the taps are read from shared memory instead of L2.
//
// Semantics kept from the plain version (window_bilinear_plain), as in K1:
//   * a tap outside [0, win_w) x [0, win_h) contributes 0 and is not clamped;
//   * windows may be rectangular;
//   * the sum runs over y first (per column), then over x;
//   * the output is multiplied by valid (0/1 as a float);
//   * a NaN coordinate yields NaN whatever valid is.
// The kernel allocates nothing and does not synchronise; the C entry points
// return the CUDA error of the launch (or of raising the shared-memory limit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T hat(T d) {
  T w = T(1) - fabs(d);
  return w > T(0) ? w : T(0);
}

template <typename T>
__global__ void window_bilinear_tiled_kernel(const T* __restrict__ win,
                                             const T* __restrict__ xy,
                                             const T* __restrict__ valid,
                                             T* __restrict__ out, int N, int C,
                                             int win_h, int win_w, int S,
                                             int tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int n0 = blockIdx.x * tile;
  const int nt = min(tile, N - n0);
  const int plane = win_h * win_w;
  const int per_kp = C * plane;
  const long long count = (long long)nt * per_kp;
  const T* src = win + (long long)n0 * per_kp;

  // stage the tile's windows: 16-byte loads where the tile starts on a
  // 16-byte boundary, element loads for the rest
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int per_vec = 16 / (int)sizeof(T);
    const long long nvec = count / per_vec;
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(sm);
    for (long long i = threadIdx.x; i < nvec; i += blockDim.x) dst4[i] = src4[i];
    done = nvec * per_vec;
  }
  for (long long i = done + threadIdx.x; i < count; i += blockDim.x) sm[i] = src[i];
  __syncthreads();

  const int total = nt * S;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int ln = idx / S;
    const int s = idx - ln * S;
    const long long n = n0 + ln;
    const long long t = n * S + s;
    const T x = xy[2 * t];
    const T y = xy[2 * t + 1];
    const T v = valid[t];
    T* o = out + n * C * S + s;

    if (isnan(x) || isnan(y)) {
      const T nan_val = x + y;
      for (int c = 0; c < C; ++c) o[(long long)c * S] = nan_val;
      continue;
    }

    // the two row and two column taps; a tap outside the window keeps
    // weight 0 and reads element 0 (finite), so it adds nothing
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

    const T* w = sm + ln * per_kp;
    for (int c = 0; c < C; ++c, w += plane) {
      // y first: the two column sums, then the x combination
      const T a0 = w[iy[0] * win_w + jx[0]] * wy[0] + w[iy[1] * win_w + jx[0]] * wy[1];
      const T a1 = w[iy[0] * win_w + jx[1]] * wy[0] + w[iy[1] * win_w + jx[1]] * wy[1];
      o[(long long)c * S] = (a0 * wx[0] + a1 * wx[1]) * v;
    }
  }
}

template <typename T>
int launch(const void* win, const void* xy, const void* valid, void* out,
           int N, int C, int win_h, int win_w, int S, int tile, int threads,
           void* stream) {
  if (N == 0 || S == 0 || C == 0) return (int)cudaSuccess;
  if (tile < 1 || threads < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)tile * C * win_h * win_w * sizeof(T);
  // above 48 KB a kernel has to opt in to its dynamic shared memory; the call
  // is no stream operation, so a graph capture takes it too
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_bilinear_tiled_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (N + tile - 1) / tile;
  window_bilinear_tiled_kernel<T>
      <<<(unsigned)blocks, (unsigned)threads, bytes, (cudaStream_t)stream>>>(
          (const T*)win, (const T*)xy, (const T*)valid, (T*)out, N, C, win_h,
          win_w, S, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_bilinear_tiled_f32(const void* win, const void* xy,
                                         const void* valid, void* out, int N,
                                         int C, int win_h, int win_w, int S,
                                         int tile, int threads, void* stream) {
  return launch<float>(win, xy, valid, out, N, C, win_h, win_w, S, tile,
                       threads, stream);
}

extern "C" int window_bilinear_tiled_f64(const void* win, const void* xy,
                                         const void* valid, void* out, int N,
                                         int C, int win_h, int win_w, int S,
                                         int tile, int threads, void* stream) {
  return launch<double>(win, xy, valid, out, N, C, win_h, win_w, S, tile,
                        threads, stream);
}
