// K1-v: the windowed bilinear sampler with whole windows staged in shared
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
// windows one grid step held in the core's fast memory. Here TILE
// consecutive keypoints are one unit of a block's work, and the block stages
// each keypoint's whole [C, win_h, win_w] window in shared memory before it
// samples it. TILE and the threads per block are launch parameters. The
// dense hat-weight contraction of the TPU body is not carried over: it
// existed because the TPU scalarises gathers.
//
// What bounds it on the card: the bytes of the whole-window copy. It reads
// every window once (6.29 MB at N = 512, C = 3, 32x32, f32, whatever S is),
// where the function needs the taps its samples touch: at the tracker's
// S = 40 a few per cent of them. The first design
// (window_bilinear_staged_kernel, kept as the baseline) ran that copy and
// the sampling in series: a block copied its tile's windows, waited on
// __syncthreads(), and only then loaded coordinates and sampled; a tile of
// 8 copied 98 KB before any work.
//
// What this design (window_bilinear_tiled_kernel) does about it: it
// overlaps the copy with the sampling. The grid is at most one wave of
// persistent blocks (SMs x resident blocks), block b taking tiles b, b +
// gridDim.x, ...; each block keeps a ring of 2 stages in dynamic shared
// memory, a stage holding one keypoint's window planes, coordinate row and
// mask row. Warp 0 produces: one thread issues the 1D bulk asynchronous
// copies (cp.async.bulk, completion on the stage's `full` mbarrier) of
// keypoint k + 1 into the free stage while the other warps consume keypoint
// k from the full one and then arrive on its `empty` mbarrier. A piece whose
// address or size breaks the copy's 16-byte rule (rows of 120 bytes, a mask
// row of odd length) is staged by warp 0 with ordinary loads instead. Shared
// memory holds the ring, not the tile: 2 x 12.5 KB at C = 3, 32x32, f32,
// S = 40, whatever TILE is.
//
// Semantics kept from the plain version (window_bilinear_plain), as in K1:
//   * a tap outside [0, win_w) x [0, win_h) contributes 0 and is not clamped;
//     it keeps weight 0 and reads element 0 of its plane;
//   * windows may be rectangular, and keypoints may lie kp_stride elements
//     apart (each keypoint's [C, win_h, win_w] block contiguous); the staged
//     baseline takes contiguous windows only (kp_stride = C * win_h * win_w);
//   * the sum runs over y first (per column), then over x;
//   * the output is multiplied by valid (0/1 as a float);
//   * a NaN coordinate yields x + y (NaN) whatever valid is.
// The kernels allocate nothing and do not synchronise; the C entry points
// return the CUDA error of the launch (or of raising the shared-memory
// limit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ T hat(T d) {
  T w = T(1) - fabs(d);
  return w > T(0) ? w : T(0);
}

// One sample of a window held in shared memory: the 2x2 taps of every
// channel, y first, then x, times the mask; a NaN coordinate writes x + y.
template <typename T>
__device__ __forceinline__ void sample(const T* w, T x, T y, T v, T* o, int C, int win_h,
                                       int win_w, int S) {
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
  const int plane = win_h * win_w;
  for (int c = 0; c < C; ++c, w += plane) {
    // y first: the two column sums, then the x combination
    const T a0 = w[iy[0] * win_w + jx[0]] * wy[0] + w[iy[1] * win_w + jx[0]] * wy[1];
    const T a1 = w[iy[0] * win_w + jx[1]] * wy[0] + w[iy[1] * win_w + jx[1]] * wy[1];
    o[(long long)c * S] = (a0 * wx[0] + a1 * wx[1]) * v;
  }
}

// ------------------------------------------------- the first design, staged

template <typename T>
__global__ void window_bilinear_staged_kernel(const T* __restrict__ win,
                                              const T* __restrict__ xy,
                                              const T* __restrict__ valid,
                                              T* __restrict__ out, int N, int C,
                                              int win_h, int win_w, int S,
                                              int tile) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);

  const int n0 = blockIdx.x * tile;
  const int nt = min(tile, N - n0);
  const int per_kp = C * win_h * win_w;
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
    sample(sm + ln * per_kp, xy[2 * t], xy[2 * t + 1], valid[t], out + n * C * S + s, C,
           win_h, win_w, S);
  }
}

// ------------------------------------------------- mbarrier and bulk copy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

__device__ __forceinline__ bool bulk_ok(const void* src, size_t bytes) {
  return bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
}

// ------------------------------------------------------- the ring design

constexpr int kStages = 2;
constexpr size_t kHeader = 128;   // the 2 x kStages mbarriers, padded

__host__ __device__ __forceinline__ size_t pad16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// bytes of one stage: the window planes, the coordinate row, the mask row,
// each padded to 16 bytes
template <typename T>
__host__ __device__ __forceinline__ size_t stage_bytes(int C, int win_h, int win_w, int S) {
  return pad16((size_t)C * win_h * win_w * sizeof(T)) + pad16((size_t)2 * S * sizeof(T)) +
         pad16((size_t)S * sizeof(T));
}

// keypoint of step j of a block: tile b + (j / tile) * gridDim.x, slot j % tile;
// -1 past the block's last keypoint
__device__ __forceinline__ long long kp_of(int j, int tile, int N) {
  const long long t = blockIdx.x + (long long)(j / tile) * gridDim.x;
  const long long kp = t * tile + j % tile;
  return kp < N ? kp : -1;
}

template <typename T>
__global__ void window_bilinear_tiled_kernel(const T* __restrict__ win, long long kp_stride,
                                             const T* __restrict__ xy,
                                             const T* __restrict__ valid,
                                             T* __restrict__ out, int N, int C, int win_h,
                                             int win_w, int S, int tile) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kStages;
  const size_t win_bytes = (size_t)C * win_h * win_w * sizeof(T);
  const size_t xy_bytes = (size_t)2 * S * sizeof(T);
  const size_t v_bytes = (size_t)S * sizeof(T);
  const size_t sb = stage_bytes<T>(C, win_h, win_w, S);
  const int consumers = blockDim.x - 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(smem_u32(full + st), 32);          // the producer warp's lanes
      mbar_init(smem_u32(empty + st), consumers);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto stage = [&](int st) { return smem_raw + kHeader + st * sb; };

  if (threadIdx.x < 32) {
    // producer warp: fill the free stage with the next keypoint
    const int lane = threadIdx.x;
    for (int j = 0;; ++j) {
      const long long kp = kp_of(j, tile, N);
      if (kp < 0) break;
      const int st = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      mbar_wait(smem_u32(empty + st), parity ^ 1);   // the first round passes
      T* sw = reinterpret_cast<T*>(stage(st));
      T* sxy = reinterpret_cast<T*>(stage(st) + pad16(win_bytes));
      T* sv = reinterpret_cast<T*>(stage(st) + pad16(win_bytes) + pad16(xy_bytes));
      const T* gw = win + kp * kp_stride;
      const T* gxy = xy + kp * 2 * S;
      const T* gv = valid + kp * S;
      const bool bw = bulk_ok(gw, win_bytes), bxy = bulk_ok(gxy, xy_bytes),
                 bv = bulk_ok(gv, v_bytes);
      const uint32_t fb = smem_u32(full + st);
      if (lane == 0) {
        // the consumers' reads of this stage come before the copies' writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(fb, (uint32_t)((bw ? win_bytes : 0) + (bxy ? xy_bytes : 0) +
                                      (bv ? v_bytes : 0)));
        if (bw) bulk_copy(smem_u32(sw), gw, (uint32_t)win_bytes, fb);
        if (bxy) bulk_copy(smem_u32(sxy), gxy, (uint32_t)xy_bytes, fb);
        if (bv) bulk_copy(smem_u32(sv), gv, (uint32_t)v_bytes, fb);
      }
      if (!bw)
        for (int i = lane; i < C * win_h * win_w; i += 32) sw[i] = gw[i];
      if (!bxy)
        for (int i = lane; i < 2 * S; i += 32) sxy[i] = gxy[i];
      if (!bv)
        for (int i = lane; i < S; i += 32) sv[i] = gv[i];
      mbar_arrive(fb);
    }
  } else {
    // consumer warps: sample the full stage, then hand it back
    const int ct = threadIdx.x - 32;
    for (int j = 0;; ++j) {
      const long long kp = kp_of(j, tile, N);
      if (kp < 0) break;
      const int st = j % kStages;
      mbar_wait(smem_u32(full + st), (j / kStages) & 1);
      const T* sw = reinterpret_cast<const T*>(stage(st));
      const T* sxy = reinterpret_cast<const T*>(stage(st) + pad16(win_bytes));
      const T* sv = reinterpret_cast<const T*>(stage(st) + pad16(win_bytes) + pad16(xy_bytes));
      T* o = out + kp * C * S;
      for (int s = ct; s < S; s += consumers)
        sample(sw, sxy[2 * s], sxy[2 * s + 1], sv[s], o + s, C, win_h, win_w, S);
      mbar_arrive(smem_u32(empty + st));
    }
  }
}

// ------------------------------------------------------------- launchers

template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
  // above 48 KB a kernel has to opt in to its dynamic shared memory; the call
  // is no stream operation, so a graph capture takes it too
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_tiled(const void* win, long long kp_stride, const void* xy, const void* valid,
                 void* out, int N, int C, int win_h, int win_w, int S, int tile, int threads,
                 void* stream) {
  if (N == 0 || S == 0 || C == 0) return (int)cudaSuccess;
  if (tile < 1 || threads < 64 || threads % 32) return (int)cudaErrorInvalidValue;
  const size_t bytes = kHeader + kStages * stage_bytes<T>(C, win_h, win_w, S);
  cudaError_t e = opt_in(window_bilinear_tiled_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  // at most one wave of persistent blocks; none of these calls is a stream
  // operation, so a graph capture takes them too
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, window_bilinear_tiled_kernel<T>, threads, bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = ((long long)N + tile - 1) / tile;
  const long long wave = (long long)sms * per_sm;
  const long long blocks = tiles < wave ? tiles : wave;
  window_bilinear_tiled_kernel<T><<<(unsigned)blocks, (unsigned)threads, bytes, (cudaStream_t)stream>>>(
      (const T*)win, kp_stride, (const T*)xy, (const T*)valid, (T*)out, N, C, win_h, win_w, S,
      tile);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_staged(const void* win, long long kp_stride, const void* xy, const void* valid,
                  void* out, int N, int C, int win_h, int win_w, int S, int tile, int threads,
                  void* stream) {
  if (N == 0 || S == 0 || C == 0) return (int)cudaSuccess;
  if (tile < 1 || threads < 1) return (int)cudaErrorInvalidValue;
  if (kp_stride != (long long)C * win_h * win_w) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)tile * C * win_h * win_w * sizeof(T);
  cudaError_t e = opt_in(window_bilinear_staged_kernel<T>, bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (N + tile - 1) / tile;
  window_bilinear_staged_kernel<T>
      <<<(unsigned)blocks, (unsigned)threads, bytes, (cudaStream_t)stream>>>(
          (const T*)win, (const T*)xy, (const T*)valid, (T*)out, N, C, win_h, win_w, S, tile);
  return (int)cudaGetLastError();
}

}  // namespace

#define WBT_ENTRY(name, fn, T)                                                              \
  extern "C" int name(const void* win, long long kp_stride, const void* xy,              \
                      const void* valid, void* out, int N, int C, int win_h, int win_w,  \
                      int S, int tile, int threads, void* stream) {                      \
    return fn<T>(win, kp_stride, xy, valid, out, N, C, win_h, win_w, S, tile, threads,   \
                 stream);                                                                \
  }

WBT_ENTRY(window_bilinear_tiled_f32, launch_tiled, float)
WBT_ENTRY(window_bilinear_tiled_f64, launch_tiled, double)
WBT_ENTRY(window_bilinear_staged_f32, launch_staged, float)
WBT_ENTRY(window_bilinear_staged_f64, launch_staged, double)
