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
// and only the 2x2 taps around (x, y) have non-zero weight, so both kernels
// here do a 4-tap read per channel.
//
// What bounds it on the card: latency. At the tracker's shapes (N = 512
// keypoints, C in {1, 3}, 32x32 windows, S = 40 a frame or 160 a joint
// chunk) the bytes its inputs need take 0.2-0.6 us at 3.35 TB/s, less than
// one launch. window_bilinear_kernel, which the tracker launches, is one
// thread per (n, s): it loads its coordinates, and only then the taps whose
// addresses depend on them, two dependent trips to memory per thread.
//
// window_bilinear_band_kernel, a row of the sampler sweep, tries to make
// them one: one warp per keypoint issues, before any wait, one 1D bulk
// asynchronous copy (cp.async.bulk, completion on the warp's mbarrier) per
// band and channel plane into shared memory, and the coordinates and mask
// of the lanes' first samples (one 8- or 16-byte load per sample). The
// bands: the kBand rows around the keypoint's own row, which
// extract_windows puts at the window's centre, where the tracker's samples
// cluster; and the kTop rows from row 0, where the tracker's padded keypoint
// slots (at pixel (0, 0), their windows at the image's corner) sample, and
// which every tap outside the window in y reads. A tap on a staged row reads
// shared memory; one on another row (a real keypoint whose window is
// clamped off-centre at the image border, long blur) reads device memory as
// window_bilinear_kernel does. Where the copy's 16-byte rule fails (rows of
// 120 bytes, planes of odd size) the warp stages the bands with ordinary
// loads. kBand and kTop are compile-time constants (WB_BAND, WB_TOP, set by
// the build from ops/cuda_sampling.py's BAND_ROWS and TOP_ROWS), chosen from
// the histogram of the tracker's tap rows that the sampler sweep prints. On
// the tracker's recorded inputs it is slower than the one-thread-a-sample
// design, warm and cold (PERF.md section 6): a launch lasts as long as its
// slowest warp, the warps of off-centre keypoints still make two trips, a
// lane walks its keypoint's samples in rounds of 32 and each round waits on
// its coordinates, and the bands move 2-4 times the bytes the taps need.
// So the tracker keeps window_bilinear_kernel.
//
// Semantics kept from the plain version (window_bilinear_plain), in both:
//   * a tap outside [0, win_w) x [0, win_h) contributes 0 and is not clamped
//     to the edge (x = -0.5 gives 0.5 * W[.., 0]; >= 1 px beyond gives 0);
//     it keeps weight 0 and reads element 0 of its plane;
//   * windows may be rectangular, and keypoints may lie kp_stride elements
//     apart (the C = 1 slice windows[:, :1] of a C = 3 cache is read in
//     place); each keypoint's [C, win_h, win_w] block is contiguous;
//   * the sum runs over y first (per column), then over x;
//   * the output is multiplied by valid (0/1 as a float);
//   * a NaN coordinate yields x + y (NaN) whatever valid is.
// The two agree bit for bit on every case the sweep and chip_smoke.py hold
// them to. The kernels allocate nothing and do not synchronise; the C entry
// points return the CUDA error of the launch (or of raising the
// shared-memory limit).

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(WB_BAND) || !defined(WB_TOP)
#error "WB_BAND and WB_TOP (rows of the staged bands) must be defined by the build"
#endif

namespace {

constexpr int kBand = WB_BAND;   // rows around the keypoint's own row
constexpr int kTop = WB_TOP;     // rows from row 0

template <typename T>
__device__ __forceinline__ T hat(T d) {
  T w = T(1) - fabs(d);
  return w > T(0) ? w : T(0);
}

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// ---------------------------------------------------------------- the taps

// The two row and two column taps of one sample; a tap outside the window
// keeps weight 0 and index 0 (finite), so it adds nothing.
template <typename T>
struct Taps {
  T wy[2], wx[2];
  int iy[2], jx[2];
  __device__ __forceinline__ Taps(T x, T y, int win_h, int win_w) {
    const T fy = floor(y);
    const T fx = floor(x);
    const T ty[2] = {fy, fy + T(1)};
    const T tx[2] = {fx, fx + T(1)};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const bool in_y = ty[k] >= T(0) && ty[k] <= T(win_h - 1);
      const bool in_x = tx[k] >= T(0) && tx[k] <= T(win_w - 1);
      wy[k] = in_y ? hat(y - ty[k]) : T(0);
      wx[k] = in_x ? hat(x - tx[k]) : T(0);
      iy[k] = in_y ? (int)ty[k] : 0;
      jx[k] = in_x ? (int)tx[k] : 0;
    }
  }
};

// ---------------------------------------------- one thread a sample

template <typename T>
__global__ void window_bilinear_kernel(const T* __restrict__ win,
                                              long long kp_stride,
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

  const Taps<T> tp(x, y, win_h, win_w);
  const long long plane = (long long)win_h * win_w;
  const T* w = win + n * kp_stride;
  for (int c = 0; c < C; ++c, w += plane) {
    // y first: the two column sums, then the x combination
    const T a0 = w[tp.iy[0] * win_w + tp.jx[0]] * tp.wy[0] + w[tp.iy[1] * win_w + tp.jx[0]] * tp.wy[1];
    const T a1 = w[tp.iy[0] * win_w + tp.jx[1]] * tp.wy[0] + w[tp.iy[1] * win_w + tp.jx[1]] * tp.wy[1];
    o[(long long)c * S] = (a0 * tp.wx[0] + a1 * tp.wx[1]) * v;
  }
}

// ------------------------------------------------- mbarrier and bulk copy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------- the band design

// The staged rows of a window of win_h rows: [0, top) and [r0, r0 + rows).
// The centre band is centred on the keypoint's own two tap rows
// (extract_windows puts the keypoint in [win_h / 2, win_h / 2 + 1)) and
// clamped into the window; where it meets the top band the two become one
// band from row 0.
struct Bands {
  int top, r0, rows;
};
__host__ __device__ __forceinline__ Bands staged_rows(int win_h) {
  const int top = kTop < win_h ? kTop : win_h;
  const int rows = kBand < win_h ? kBand : win_h;
  int r0 = win_h / 2 + 1 - kBand / 2;
  r0 = r0 < 0 ? 0 : (r0 > win_h - rows ? win_h - rows : r0);
  if (r0 <= top) {
    const int end = r0 + rows > top ? r0 + rows : top;
    return {0, 0, end};
  }
  return {top, r0, rows};
}
// Shared memory of a block of `warps` warps: one mbarrier per warp, then per
// warp C planes of min(kTop, win_h) + min(kBand, win_h) rows, each padded to
// 16 bytes.
__host__ __device__ __forceinline__ size_t bar_bytes(int warps) {
  return ((size_t)warps * 8 + 15) / 16 * 16;
}
template <typename T>
__host__ __device__ __forceinline__ int padded_plane(int win_h, int win_w) {
  const int per16 = 16 / (int)sizeof(T);
  const int rows = (kTop < win_h ? kTop : win_h) + (kBand < win_h ? kBand : win_h);
  return (rows * win_w + per16 - 1) / per16 * per16;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
__global__ void __launch_bounds__(1024) window_bilinear_band_kernel(
    const T* __restrict__ win, long long kp_stride, const T* __restrict__ xy,
    const T* __restrict__ valid, T* __restrict__ out, int N, int C, int win_h,
    int win_w, int S) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using V2 = typename Vec2<T>::type;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long n = (long long)blockIdx.x * warps + warp;
  if (n >= N) return;   // whole warps leave; no block-wide barrier follows

  const Bands b = staged_rows(win_h);
  const int ps = padded_plane<T>(win_h, win_w);
  const long long plane = (long long)win_h * win_w;
  const uint32_t bar = smem_u32(reinterpret_cast<uint64_t*>(smem_raw) + warp);
  T* band = reinterpret_cast<T*>(smem_raw + bar_bytes(warps)) + (size_t)warp * C * ps;
  const T* w = win + n * kp_stride;
  const T* centre = w + (long long)b.r0 * win_w;
  const uint32_t top_bytes = (uint32_t)(b.top * win_w * sizeof(T));
  const uint32_t centre_bytes = (uint32_t)(b.rows * win_w * sizeof(T));
  const bool bulk = (plane * sizeof(T)) % 16 == 0 && top_bytes % 16 == 0 &&
                    centre_bytes % 16 == 0 && aligned16(w) && aligned16(centre);

  // 1. issue the bands' copies and the first sample's loads, then wait once
  if (bulk) {
    if (lane == 0) {
      mbar_init(bar, 1);
      mbar_arrive_expect_tx(bar, (top_bytes + centre_bytes) * C);
      for (int c = 0; c < C; ++c) {
        if (top_bytes) bulk_copy(smem_u32(band + c * ps), w + c * plane, top_bytes, bar);
        bulk_copy(smem_u32(band + c * ps + b.top * win_w), centre + c * plane, centre_bytes,
                  bar);
      }
    }
  } else {
    const int per = (b.top + b.rows) * win_w;
    for (int i = lane; i < C * per; i += 32) {
      const int c = i / per;
      const int e = i - c * per;
      const int sr = e / win_w;
      const int row = sr < b.top ? sr : b.r0 + (sr - b.top);
      band[c * ps + e] = w[c * plane + (long long)row * win_w + (e - sr * win_w)];
    }
  }

  const V2* xy2 = reinterpret_cast<const V2*>(xy) + n * S;
  const T* vn = valid + n * S;
  T* on = out + n * C * S;
  V2 p = {};
  T v = T(0);
  if (lane < S) {
    p = xy2[lane];
    v = vn[lane];
  }
  __syncwarp();
  if (bulk) mbar_wait(bar, 0);

  // shared-memory row of window row r, or -1 where r is not staged
  auto staged = [&](int r) {
    return r < b.top ? r : ((unsigned)(r - b.r0) < (unsigned)b.rows ? b.top + r - b.r0 : -1);
  };

  // 2. sample, lane by lane through the keypoint's samples, the next
  // sample's loads in flight during this one: a tap on a staged row reads
  // shared memory, one on another row reads device memory; the arithmetic
  // is window_bilinear_kernel's
  for (int s = lane; s < S; s += 32) {
    V2 p_next = p;
    T v_next = v;
    if (s + 32 < S) {
      p_next = xy2[s + 32];
      v_next = vn[s + 32];
    }
    const T x = p.x;
    const T y = p.y;
    T* o = on + s;
    if (isnan(x) || isnan(y)) {
      const T nan_val = x + y;
      for (int c = 0; c < C; ++c) o[(long long)c * S] = nan_val;
    } else {
      const Taps<T> tp(x, y, win_h, win_w);
      const int sr0 = staged(tp.iy[0]);
      const int sr1 = staged(tp.iy[1]);
      for (int c = 0; c < C; ++c) {
        const T* row0 = sr0 >= 0 ? band + c * ps + sr0 * win_w
                                 : w + c * plane + (long long)tp.iy[0] * win_w;
        const T* row1 = sr1 >= 0 ? band + c * ps + sr1 * win_w
                                 : w + c * plane + (long long)tp.iy[1] * win_w;
        // y first: the two column sums, then the x combination
        const T a0 = row0[tp.jx[0]] * tp.wy[0] + row1[tp.jx[0]] * tp.wy[1];
        const T a1 = row0[tp.jx[1]] * tp.wy[0] + row1[tp.jx[1]] * tp.wy[1];
        o[(long long)c * S] = (a0 * tp.wx[0] + a1 * tp.wx[1]) * v;
      }
    }
    p = p_next;
    v = v_next;
  }
}

// ------------------------------------------------------------- launchers

template <typename T>
int launch_sample(const void* win, long long kp_stride, const void* xy, const void* valid,
                  void* out, int N, int C, int win_h, int win_w, int S, int threads,
                  void* stream) {
  const long long total = (long long)N * S;
  if (total == 0 || C == 0) return (int)cudaSuccess;
  if (threads < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (total + threads - 1) / threads;
  window_bilinear_kernel<T><<<(unsigned)blocks, (unsigned)threads, 0, (cudaStream_t)stream>>>(
      (const T*)win, kp_stride, (const T*)xy, (const T*)valid, (T*)out, N, C, win_h, win_w, S);
  return (int)cudaGetLastError();
}

template <typename T>
size_t band_shared_bytes(int threads, int C, int win_h, int win_w) {
  const int warps = threads / 32;
  return bar_bytes(warps) + (size_t)warps * C * padded_plane<T>(win_h, win_w) * sizeof(T);
}

template <typename T>
int launch_band(const void* win, long long kp_stride, const void* xy, const void* valid,
                void* out, int N, int C, int win_h, int win_w, int S, int threads,
                void* stream) {
  if (N == 0 || S == 0 || C == 0) return (int)cudaSuccess;
  if (threads < 32 || threads % 32) return (int)cudaErrorInvalidValue;
  const size_t bytes = band_shared_bytes<T>(threads, C, win_h, win_w);
  // above 48 KB a kernel has to opt in to its dynamic shared memory; the call
  // is no stream operation, so a graph capture takes it too
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(window_bilinear_band_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int warps = threads / 32;
  const long long blocks = ((long long)N + warps - 1) / warps;
  window_bilinear_band_kernel<T><<<(unsigned)blocks, (unsigned)threads, bytes, (cudaStream_t)stream>>>(
      (const T*)win, kp_stride, (const T*)xy, (const T*)valid, (T*)out, N, C, win_h, win_w, S);
  return (int)cudaGetLastError();
}

}  // namespace

#define WB_ENTRY(name, fn, T)                                                              \
  extern "C" int name(const void* win, long long kp_stride, const void* xy,             \
                      const void* valid, void* out, int N, int C, int win_h, int win_w, \
                      int S, int threads, void* stream) {                               \
    return fn<T>(win, kp_stride, xy, valid, out, N, C, win_h, win_w, S, threads, stream); \
  }

WB_ENTRY(window_bilinear_f32, launch_sample, float)
WB_ENTRY(window_bilinear_f64, launch_sample, double)
WB_ENTRY(window_bilinear_band_f32, launch_band, float)
WB_ENTRY(window_bilinear_band_f64, launch_band, double)

// the bands' rows, as compiled: the wrapper checks them against BAND_ROWS
// and TOP_ROWS
extern "C" int window_bilinear_band_rows() { return kBand; }
extern "C" int window_bilinear_top_rows() { return kTop; }
