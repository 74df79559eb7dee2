// K3: the tracker's Huber normal equations for Hopper (sm_90a).
//
// Replaces the XLA fusion of mba_vo_tpu/ops/residual.py:472-486
// (huber_weights), :526-565 (_kahan_chunked_normal_eq) and :568-624
// (assemble): no Pallas source, XLA fused it on the TPU. From the residuals
// r [M] (M = F N P rows in [F, N, P] order), their Jacobian rows J [M, D]
// and the per-keypoint weights kp_w [N] it computes the per-rank raw sums
//
//   cost  = sum_m rho(r_m) kp_w[n(m)]
//   patch = sum_p rho(r)                per (f, n), unmasked (the reference's
//                                       patch costs ignore kp_w)
//   g     = Jw^T rw,   H = Jw^T Jw      Jw = J w kp_w, rw = r w kp_w
//
// with rho and w = sqrt(drho/dx) of the Huber-on-half-squared form
// (x = r^2 / 2; w = sqrt(a / (sqrt(x) + 1e-8)) where x > a^2 strictly).
// The caller scales by the inverse residual count and all-reduces.
//
// Design: two launches, no atomics, so a run repeats bit for bit.
//   stage 1: kChunks x kSplit = 16 x 8 blocks. The rows split into the 16
//     contiguous chunks [c L, (c + 1) L), L = ceil(M / 16), of the
//     reference's compensated sum (padded rows being absent), and each chunk
//     into kSplit contiguous parts, one a block. A block walks its rows in
//     tiles of kTileRows: the weighted rows [Jw | rw] of a tile go to shared
//     memory, then each thread adds the tile's sum for each of its entries
//     of the upper triangle of [Jw | rw]^T [Jw | rw] (H's upper triangle,
//     then g) to its accumulator. It also sums rho kp_w over its rows
//     (a fixed-order reduction in the block) and, for its share of the
//     (f, n) groups, the P patch pixels' rho. Partials go to a scratch
//     buffer [16 x 8, 1 + E].
//   stage 2: one thread an entry sums each chunk's 8 parts in order, then
//     combines the 16 chunk sums in chunk order: Kahan-compensated as the
//     reference's compensated mode does (the compensation term stays local,
//     as in the reference), a plain sum otherwise; it writes H's two
//     triangles.
// D (the knot tangents) is a runtime argument up to MAX_TANGENTS; D = 0 is
// the cost-only mode (no J).
//
// What bounds it on the card: the bytes of J read once (M D items: 0.2 MB
// at the frame's shapes in f32, well under one launch's time); each block
// walks its few tiles one after another, so latency bounds it. Fusing this
// kernel into K2's blur_rows, so that J never reaches device memory, is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MAX_TANGENTS
#error "MAX_TANGENTS (the largest number of knot tangents a launch may take) must be defined by the build"
#endif

namespace {

constexpr int kMaxTangents = MAX_TANGENTS;
constexpr int kThreads = 512;
constexpr int kChunks = 16;
constexpr int kSplit = 8;   // blocks a chunk
constexpr int kTileRows = 32;
// entries of the upper triangle of the (D+1) x (D+1) matrix less (D, D)
constexpr int kMaxEntries = (kMaxTangents + 1) * (kMaxTangents + 2) / 2 - 1;
constexpr int kPerThread = (kMaxEntries + kThreads - 1) / kThreads;

template <typename T>
struct Huber {
  T rho, w;
  __device__ __forceinline__ Huber(T r, double a) {
    const T aa = (T)(a * a);
    const T x = T(0.5) * r * r;
    const T sx = sqrt(x > T(0) ? x : T(0));
    if (x > aa) {
      rho = (T)(2.0 * a) * sx - aa;
      w = sqrt((T)a / (sx + T(1e-8)));
    } else {
      rho = x;
      w = T(1);
    }
  }
};

// entry e -> (k, l), k <= l: first H's upper triangle row by row (l < D),
// then g as column D (k < D, l = D)
__device__ __forceinline__ void entry_kl(int e, int D, int* k, int* l) {
  const int nh = D * (D + 1) / 2;
  if (e >= nh) {
    *k = e - nh;
    *l = D;
    return;
  }
  int row = 0, len = D;
  while (e >= len) {
    e -= len;
    ++row;
    --len;
  }
  *k = row;
  *l = row + e;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
normal_equations_partials(const T* __restrict__ r, const T* __restrict__ J,
                          const T* __restrict__ kp_w, T* __restrict__ part,
                          T* __restrict__ patch, int F, int N, int P, int D, double a) {
  __shared__ T s_rows[kTileRows * (kMaxTangents + 1)];
  __shared__ T s_w[kTileRows];
  __shared__ T s_cost[kTileRows];
  const int tid = threadIdx.x;
  const int c = blockIdx.x / kSplit;
  const int part_of_chunk = blockIdx.x - c * kSplit;
  const long long M = (long long)F * N * P;
  const long long L = (M + kChunks - 1) / kChunks;
  const long long chunk_end = (c + 1) * L < M ? (c + 1) * L : M;
  const long long Lb = (L + kSplit - 1) / kSplit;
  const long long b0 = c * L + part_of_chunk * Lb;
  const long long begin = b0 < chunk_end ? b0 : chunk_end;
  const long long end = begin + Lb < chunk_end ? begin + Lb : chunk_end;
  const int E = D > 0 ? (D + 1) * (D + 2) / 2 - 1 : 0;
  const int stride = D + 1;

  // each entry's (k, l) packed as k << 16 | l
  int kl[kPerThread];
  T acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = tid + j * kThreads;
    int k = 0, l = 0;
    if (e < E) entry_kl(e, D, &k, &l);
    kl[j] = (k << 16) | l;
    acc[j] = T(0);
  }
  T cost = T(0);

  for (long long t0 = begin; t0 < end; t0 += kTileRows) {
    if (tid < kTileRows) {
      const long long m = t0 + tid;
      T rw = T(0), ww = T(0);
      if (m < end) {
        const T kw = kp_w[(m / P) % N];
        const Huber<T> h(r[m], a);
        cost += h.rho * kw;
        rw = r[m] * h.w * kw;
        ww = h.w * kw;
      }
      s_w[tid] = ww;
      s_rows[tid * stride + D] = rw;
    }
    __syncthreads();
    if (D > 0) {
      for (int i = tid; i < kTileRows * D; i += kThreads) {
        const int row = i / D;
        const int d = i - row * D;
        const long long m = t0 + row;
        s_rows[row * stride + d] = m < end ? J[m * D + d] * s_w[row] : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (tid + j * kThreads < E) {
          const T* col_k = s_rows + (kl[j] >> 16);
          const T* col_l = s_rows + (kl[j] & 0xffff);
          T tile = T(0);
          for (int row = 0; row < kTileRows; ++row)
            tile += col_k[row * stride] * col_l[row * stride];
          acc[j] += tile;
        }
      }
    }
    __syncthreads();
  }

  T* out = part + (long long)blockIdx.x * (1 + E);
  if (tid < kTileRows) s_cost[tid] = cost;
  __syncthreads();
  if (tid == 0) {
    T sum = T(0);
    for (int i = 0; i < kTileRows; ++i) sum += s_cost[i];
    out[0] = sum;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e < E) out[1 + e] = acc[j];
  }

  // patch costs of this block's share of the (f, n) groups
  const long long G = (long long)F * N;
  const long long GL = (G + gridDim.x - 1) / gridDim.x;
  const long long g_end = (blockIdx.x + 1) * GL < G ? (blockIdx.x + 1) * GL : G;
  for (long long g = blockIdx.x * GL + tid; g < g_end; g += kThreads) {
    T sum = T(0);
    for (int p = 0; p < P; ++p) sum += Huber<T>(r[g * P + p], a).rho;
    patch[g] = sum;
  }
}

template <typename T>
__global__ void normal_equations_combine(const T* __restrict__ part, T* __restrict__ cost,
                                         T* __restrict__ g, T* __restrict__ H, int D,
                                         int compensated) {
  const int E = D > 0 ? (D + 1) * (D + 2) / 2 - 1 : 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 1 + E; e += gridDim.x * blockDim.x) {
    T s = T(0), comp = T(0);
    for (int c = 0; c < kChunks; ++c) {
      T x = T(0);
      for (int b = 0; b < kSplit; ++b) x += part[((long long)c * kSplit + b) * (1 + E) + e];
      if (compensated && e > 0) {
        const T y = x - comp;
        const T t = s + y;
        comp = (t - s) - y;
        s = t;
      } else {
        s += x;
      }
    }
    if (e == 0) {
      *cost = s;
      continue;
    }
    int k, l;
    entry_kl(e - 1, D, &k, &l);
    if (l == D) {
      g[k] = s;
    } else {
      H[(long long)k * D + l] = s;
      H[(long long)l * D + k] = s;
    }
  }
}

template <typename T>
int launch(const void* r, const void* J, const void* kp_w, void* part, void* cost, void* patch,
           void* g, void* H, int F, int N, int P, int D, double a, int compensated,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  normal_equations_partials<T><<<kChunks * kSplit, kThreads, 0, s>>>(
      (const T*)r, (const T*)J, (const T*)kp_w, (T*)part, (T*)patch, F, N, P, D, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E = D > 0 ? (D + 1) * (D + 2) / 2 - 1 : 0;
  const int threads = 256;
  normal_equations_combine<T><<<(1 + E + threads - 1) / threads, threads, 0, s>>>(
      (const T*)part, (T*)cost, (T*)g, (T*)H, D, compensated);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int normal_equations_max_tangents() { return kMaxTangents; }
int normal_equations_chunks() { return kChunks; }
int normal_equations_blocks() { return kChunks * kSplit; }

#define NE_ARGS                                                                        \
  const void *r, const void *J, const void *kp_w, void *part, void *cost, void *patch, \
      void *g, void *H, int F, int N, int P, int D, double a, int compensated, void *stream
#define NE_PASS r, J, kp_w, part, cost, patch, g, H, F, N, P, D, a, compensated, stream

int normal_equations_f32(NE_ARGS) { return launch<float>(NE_PASS); }
int normal_equations_f64(NE_ARGS) { return launch<double>(NE_PASS); }

}  // extern "C"
