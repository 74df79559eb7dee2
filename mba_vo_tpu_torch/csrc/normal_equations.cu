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
// The order of every sum is fixed, the same in both designs below, so a
// run repeats bit for bit and the two designs give the same bits: the rows
// split into the 16 contiguous chunks [c L, (c + 1) L), L = ceil(M / 16),
// of the reference's compensated sum (padded rows being absent), and each
// chunk into kSplit = 8 contiguous parts of ceil(L / 8) rows. An entry of
// [Jw | rw]^T [Jw | rw] (H's upper triangle, then g) sums a part's rows in
// tiles of 32: a tile's sum runs over its 32 rows in order (rows past the
// part's end are zeros) and is added to the part's sum, tiles in order. The
// cost sums a part's rows by lane (row mod 32 from the part's start) across
// its tiles, then the 32 lanes in order. A chunk adds its 8 parts in order,
// and the 16 chunks are combined in chunk order: Kahan-compensated as the
// reference's compensated mode does (the compensation term stays local, as
// in the reference; the cost is never compensated), a plain sum otherwise.
//
// Cluster design (the one the tracker launches): one launch of
// thread-block clusters, no float atomics; the combination of the 16 chunks
// reads distributed shared memory (cluster.map_shared_rank). Two layouts of
// one kernel, chosen by the wrapper from the rows M
// (ops/cuda_residual.py::normal_equations_layout):
//   * up to 8,192 rows (the frame's calls, which latency bounds): one
//     cluster of 16 CTAs of 512 threads (H100's non-portable cluster size),
//     CTA c on chunk c, its 8 parts in rounds of G at once; each CTA
//     combines a 16th of the entries from the 16 CTAs' chunk sums, in
//     chunk order;
//   * past them (a joint chunk's calls, whose products 16 SMs would take
//     some 5 us to issue): 16 clusters of 8 CTAs of 256 threads (two an
//     SM, so that the clusters run in one wave), a CTA a part; a cluster
//     adds its 8 parts in part order into its chunk's sums (a scratch
//     buffer); the last CTA to take an integer ticket combines the 16
//     chunks in chunk order and resets the ticket. The ticket decides who
//     combines, never in what order.
// In both, rows reach shared memory by cp.async.bulk on an mbarrier
// (bulk_copy.cuh; the few elements of a run's unaligned ends by ordinary
// loads): a step takes a tile range of each of a round's parts,
// and where it covers them whole (the bench's shapes) their rows are one
// run of J and one of r, two copies; two stages where a CTA takes more than
// one step, so that the next step's copies fly during the products. A step
// computes each row's weights once (w kp_w), a thread a row; weights J's
// rows into a padded tile, a thread a tangent of every few rows, while a
// thread a lane of each part carries its cost over its rows in order; then
// a thread an item (a tile's 4 x 4 block of the upper triangle of [Jw |
// rw]^T [Jw | rw], two 4-vectors of shared memory a row for 16 products)
// sums a tile, into its owner's registers where a part has one tile a
// step, else into shared memory for the block's owner to add in tile
// order. At a round's end a thread a block entry adds the round's parts in
// order into the CTA's sums, and a part's lanes add their costs in lane
// order through warp shuffles. The patch costs are spread over the CTAs.
// Split design (the earlier one, a sweep row): two launches. Stage 1:
//   16 x 8 blocks, one a part, each walking its tiles one after another
//   through shared memory by ordinary loads, one entry a thread; partials
//   to a scratch buffer [16 x 8, 1 + E]. Stage 2: one thread an entry sums
//   each chunk's 8 parts in order, then the 16 chunks.
// D (the knot tangents) is a runtime argument up to MAX_TANGENTS; D = 0 is
// the cost-only mode (no J). Both designs are compiled with the same flags
// (the build's default contraction of a multiply and an add), and their
// arithmetic is written alike, operation for operation.
//
// What bounds it on the card: the bytes of J read once (M D items: 0.2 MB
// at the frame's shapes in f32) and M (15 + D + 2E) operations, both far
// under one launch's time at the frame's shapes; latency bounds it there:
// the bulk copies' start, then some ten phases, each a few dependent steps
// of shared memory between barriers, then two cluster barriers. At a joint
// chunk (M = 16,384, D = 42) the products are ~31 MFLOP, well under a
// microsecond on 128 SMs; the combination's ticket and the phases bound it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

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
int launch_split(const void* r, const void* J, const void* kp_w, void* part, void* cost, void* patch,
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

// ------------------------------------------------------------- cluster design

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 512;
constexpr int kBlock = 4;           // a thread's block of entries: kBlock x kBlock
constexpr int kMaxShared = 232448;  // shared memory a block may use (227 KB)
constexpr int kPatchBatch = 8;      // patch pixels whose r a thread loads at once

// rows [begin, end) of part b of chunk c, as the split design cuts them
__device__ __forceinline__ void part_range(long long M, int c, int b, long long* begin,
                                           long long* end) {
  const long long L = (M + kChunks - 1) / kChunks;
  const long long chunk_end = (c + 1) * L < M ? (c + 1) * L : M;
  const long long Lb = (L + kSplit - 1) / kSplit;
  const long long b0 = c * L + b * Lb;
  *begin = b0 < chunk_end ? b0 : chunk_end;
  *end = *begin + Lb < chunk_end ? *begin + Lb : chunk_end;
}

// Dynamic shared memory of a CTA, in bytes from its start (the wrapper
// computes the same: ops/cuda_residual.py::normal_equations_layout). A step
// takes TS tiles of each of the round's G parts (units = G TS tiles of 32
// rows, at most 32 units x 32 rows a pass):
//   2 mbarriers | stages x (G J slots, G r slots) | W [units, 32, Dpad] |
//   row weights, rho and kp_w [units, 32] each | part costs [8] | units' J
//   and r offsets, first rows and rows [units] | blocks [nblk] (k, l) |
//   tile sums, then the round's parts' sums [units x nblk x 16] (with more
//   than one unit) | kp_w [N] (where staged) | the CTA's sums [1 + E]
struct ClusterLayout {
  int Dpad, E, nblk, units;
  long long jslot, rslot, stage, raw, w, ww, rho, kwv, psum, unit, blk, sums, kw, x, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int D, int G, int TS, int stages, int sz,
                                                        int kw_staged) {
  ClusterLayout l;
  l.Dpad = (D + 1 + kBlock - 1) / kBlock * kBlock;
  l.E = D > 0 ? (D + 1) * (D + 2) / 2 - 1 : 0;
  const int nb = l.Dpad / kBlock;
  l.nblk = D > 0 ? nb * (nb + 1) / 2 : 0;
  l.units = G * TS;
  const long long rows = (long long)l.units * kTileRows;
  l.jslot = bulk::slot_bytes((long long)TS * kTileRows * D * sz);
  l.rslot = bulk::slot_bytes((long long)TS * kTileRows * sz);
  l.stage = (long long)G * (l.jslot + l.rslot);
  l.raw = 16;
  l.w = l.raw + stages * l.stage;
  l.ww = l.w + rows * l.Dpad * sz;
  l.rho = l.ww + rows * sz;
  l.kwv = l.rho + rows * sz;
  l.psum = l.kwv + rows * sz;
  l.unit = l.psum + bulk::round16((long long)kSplit * sz);
  l.blk = l.unit + bulk::round16((long long)l.units * 16);
  l.sums = l.blk + bulk::round16((long long)l.nblk * 4);
  const int staged = l.units > 1 ? l.units : 0;   // tile sums, then the parts' sums
  l.kw = l.sums + (long long)staged * l.nblk * kBlock * kBlock * sz;
  l.x = l.kw + (kw_staged ? bulk::slot_bytes((long long)kw_staged * sz) : 0);
  l.total = bulk::round16(l.x + (1LL + l.E) * sz);
  return l;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// index of entry (k, l), k <= l, k < D, among the split design's entries
// (entry_kl's inverse): H's upper triangle row by row, then g
__device__ __forceinline__ int entry_index(int k, int l, int D) {
  return l < D ? k * D - k * (k - 1) / 2 + (l - k) : D * (D + 1) / 2 + k;
}

// The cluster design (the file's header): `per_chunk` CTAs a chunk (1 or
// 8), rounds of G parts, steps of TS tiles of each, `stages` copy stages;
// owner o = g nblk + blk holds part g's sums of block blk. With 8 CTAs a
// chunk, `chunk_sums` [16, 1 + E] and the ticket (an integer the wrapper
// allocates once a device, 0 between launches; two launches that share it
// must not overlap, so the wrapper orders the streams it is used on).
template <typename T, int kItems>
__global__ void __launch_bounds__(kClusterThreads, 1)
normal_equations_cluster(const T* __restrict__ r, const T* __restrict__ J,
                         const T* __restrict__ kp_w, T* __restrict__ cost_out,
                         T* __restrict__ patch, T* __restrict__ g_out, T* __restrict__ H_out,
                         T* __restrict__ chunk_sums, unsigned* __restrict__ ticket, int F, int N,
                         int P, int D, double a, int compensated, int G, int TS, int stages,
                         int per_chunk, int kw_staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int rank = (int)cluster.block_rank();
  const int ranks = per_chunk == 1 ? kChunks : per_chunk;
  // the chunk, and the CTA's parts [b0, b0 + nparts)
  const int c = per_chunk == 1 ? rank : (int)(blockIdx.x / per_chunk);
  const int nparts = kSplit / per_chunk;
  const int b0 = per_chunk == 1 ? 0 : rank * nparts;
  const ClusterLayout lay = cluster_layout(D, G, TS, stages, (int)sizeof(T), kw_staged ? N : 0);
  T* const base = reinterpret_cast<T*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  T* W = reinterpret_cast<T*>(smem + lay.w);
  T* s_ww = reinterpret_cast<T*>(smem + lay.ww);
  T* s_rho = reinterpret_cast<T*>(smem + lay.rho);
  T* s_kwv = reinterpret_cast<T*>(smem + lay.kwv);
  T* s_psum = reinterpret_cast<T*>(smem + lay.psum);
  // a unit's J and r rows (offsets from the start of shared memory), its
  // first row and its row count
  int* s_uj = reinterpret_cast<int*>(smem + lay.unit);
  int* s_ur = s_uj + lay.units;
  int* s_um = s_ur + lay.units;
  int* s_urows = s_um + lay.units;
  unsigned* s_blk = reinterpret_cast<unsigned*>(smem + lay.blk);
  T* S = reinterpret_cast<T*>(smem + lay.sums);
  T* x = reinterpret_cast<T*>(smem + lay.x);
  const long long M = (long long)F * N * P;
  const int E = lay.E, Dpad = lay.Dpad, nblk = lay.nblk, units = lay.units;
  const int rounds = nparts / G;
  const int step_rows = TS * kTileRows;
  constexpr int kBB = kBlock * kBlock;
  // kp_w in shared memory (one more run with step 0's copies), else read
  // from device memory
  const bulk::Run<T> kw_run(kp_w, reinterpret_cast<T*>(smem + lay.kw), kw_staged ? N : 0);

  // part g of round rho: its first row and its row count
  auto part_of = [&](int rho, int g, long long* begin) -> int {
    long long end;
    part_range(M, c, b0 + rho * G + g, begin, &end);
    return (int)(end - *begin);
  };
  // a round's steps: its first part is its longest
  auto round_steps = [&](int rho) -> int {
    long long begin;
    return (part_of(rho, 0, &begin) + step_rows - 1) / step_rows;
  };
  auto locate = [&](int s, int* rho, int* t) -> bool {
    for (*rho = 0; *rho < rounds; ++*rho) {
      const int n = round_steps(*rho);
      if (s < n) {
        *t = s;
        return true;
      }
      s -= n;
    }
    return false;
  };
  // step t of round rho: part g's first row and row count, and the runs its
  // J and r rows lie in (merged: one run each for the round's parts, which
  // the step covers whole; `first` the run's first row)
  struct StepPart {
    long long m0, first;
    int rows;
    bulk::Run<T> j, r;
  };
  auto step_part = [&](int s, int rho, int t, int g) -> StepPart {
    const bool merged = round_steps(rho) == 1;
    unsigned char* stage = smem + lay.raw + (s % stages) * lay.stage;
    long long begin;
    const int len = part_of(rho, g, &begin);
    const long long m0 = begin + (long long)t * step_rows;
    const int left = len - t * step_rows;
    const int rows = left < step_rows ? (left > 0 ? left : 0) : step_rows;
    if (merged) {
      long long first, b_last;
      part_of(rho, 0, &first);
      const int len_last = part_of(rho, G - 1, &b_last);
      const int all = (int)(b_last + len_last - first);
      return {m0, first, rows,
              bulk::Run<T>(J + first * D, reinterpret_cast<T*>(stage), D > 0 ? all * D : 0),
              bulk::Run<T>(r + first, reinterpret_cast<T*>(stage + G * lay.jslot), all)};
    }
    return {m0, m0, rows,
            bulk::Run<T>(J + m0 * D, reinterpret_cast<T*>(stage + g * lay.jslot), D > 0 ? rows * D : 0),
            bulk::Run<T>(r + m0, reinterpret_cast<T*>(stage + G * lay.jslot + g * lay.rslot), rows)};
  };
  // warp 0: the copies of step s (merged: lane 0 J, lane 1 r; else lane 2g
  // part g's J rows, lane 2g + 1 its r; lane 31 kp_w with step 0); the
  // phase's two arrivals (bulk_copy.cuh)
  auto issue = [&](int s) {
    int rho, t;
    if (!locate(s, &rho, &t)) return;
    const bool merged = round_steps(rho) == 1;
    const int g = lane >> 1;
    bool have = false;
    bulk::Run<T> run = kw_run;
    if (g < (merged ? 1 : G)) {
      const StepPart sp = step_part(s, rho, t, g);
      run = (lane & 1) == 0 ? sp.j : sp.r;
      have = true;
    } else if (lane == 31 && s == 0) {
      have = true;   // kw_run
    }
    uint64_t* bar = &bars[s & 1];
    const uint32_t total = __reduce_add_sync(0xffffffffu, have ? run.bytes() : 0u);
    if (lane == 0) bulk::bar_arrive_expect(bar, total);
    __syncwarp();
    if (have) run.issue(bar);
    __syncwarp();
    if (lane == 0) bulk::bar_arrive(bar);
  };
  // the patch costs of groups (f, n) [g_begin, g_end), a thread a group
  // from the last thread down; a thread loads a batch of its group's r at
  // once and sums in order
  auto patch_costs = [&](long long g_begin, long long g_end) {
    for (long long gi = g_begin + (nthreads - 1 - tid); gi < g_end; gi += nthreads) {
      T sum = T(0);
      for (int p0 = 0; p0 < P; p0 += kPatchBatch) {
        T rp[kPatchBatch];
#pragma unroll
        for (int j = 0; j < kPatchBatch; ++j) rp[j] = p0 + j < P ? r[gi * P + p0 + j] : T(0);
#pragma unroll
        for (int j = 0; j < kPatchBatch; ++j)
          if (p0 + j < P) sum += Huber<T>(rp[j], a).rho;
      }
      patch[gi] = sum;
    }
  };

  // warp 0 initialises the barriers and issues the first copies before the
  // block synchronises
  if (warp == 0) {
    if (lane == 0) {
      bulk::bar_init(&bars[0], 2);
      bulk::bar_init(&bars[1], 2);
      bulk::fence_bar_init();
    }
    __syncwarp();
    issue(0);
    if (stages > 1) issue(1);
  }
  // W's padding columns, the sums and the part costs start at 0; the
  // blocks' (k, l) into a table
  for (int i = tid; i < units * kTileRows; i += nthreads)
    for (int d = D + 1; d < Dpad; ++d) W[i * Dpad + d] = T(0);
  for (int i = tid; i < 1 + E; i += nthreads) x[i] = T(0);
  if (tid < kSplit) s_psum[tid] = T(0);
  for (int blk = tid; blk < nblk; blk += nthreads) {
    int bk = 0, rem = blk, len = Dpad / kBlock;
    while (rem >= len) {
      rem -= len;
      ++bk;
      --len;
    }
    s_blk[blk] = (unsigned)(kBlock * bk) << 16 | (unsigned)(kBlock * (bk + rem));
  }
  // the patch costs of this CTA's share of the groups (f, n), while the
  // first copies fly, taken from the last threads
  {
    const long long groups = (long long)F * N;
    const long long GL = (groups + gridDim.x - 1) / gridDim.x;
    const long long g_begin = (long long)blockIdx.x * GL;
    patch_costs(g_begin, g_begin + GL < groups ? g_begin + GL : groups);
  }
  const bool one_step = rounds == 1 && round_steps(0) == 1;

  // owner o = g nblk + blk holds part g's sums of block blk (thread o mod
  // nthreads)
  T acc[kItems][kBB];
#pragma unroll
  for (int j = 0; j < kItems; ++j)
#pragma unroll
    for (int i = 0; i < kBB; ++i) acc[j][i] = T(0);
  T cost = T(0);   // thread g 32 + lane, g < G: the lane's cost over part g's rows

  int s = 0;
  for (int rho = 0; rho < rounds; ++rho) {
    const int nsteps = round_steps(rho);
    for (int t = 0; t < nsteps; ++t, ++s) {
      // the step's units (a tile of a part), while its copies fly
      if (tid < units) {
        const int g = tid / TS, tt = tid - g * TS;
        const StepPart sp = step_part(s, rho, t, g);
        const int left = sp.rows - tt * kTileRows;
        const int at = (int)(sp.m0 - sp.first) + tt * kTileRows;   // its first row in the run
        s_uj[tid] = (int)(sp.j.data() + (long long)at * D - base);
        s_ur[tid] = (int)(sp.r.data() + at - base);
        s_um[tid] = (int)(sp.m0 + tt * kTileRows);
        s_urows[tid] = left < kTileRows ? (left > 0 ? left : 0) : kTileRows;
      }
      __syncthreads();
      bulk::bar_wait(&bars[s & 1], (s >> 1) & 1);
      // the rows' weights: a thread a row of the step's units
      for (int q = tid; q < units * kTileRows; q += nthreads) {
        const int u = q / kTileRows, i = q - u * kTileRows;
        T rw = T(0), ww = T(0), rho_kw = T(0), kw = T(0);
        if (i < s_urows[u]) {
          const int n = ((s_um[u] + i) / P) % N;
          kw = kw_staged ? kw_run[n] : kp_w[n];
          const T rm = base[s_ur[u] + i];
          const Huber<T> h(rm, a);
          rho_kw = h.rho;
          rw = rm * h.w * kw;
          ww = h.w * kw;
        }
        s_ww[q] = ww;
        s_rho[q] = rho_kw;
        s_kwv[q] = kw;
        W[q * Dpad + D] = rw;
      }
      __syncthreads();
      // each part's lane costs, rows in order
      if (tid < G * kTileRows) {
        const int g = tid / kTileRows;
        for (int tt = 0; tt < TS; ++tt) {
          const int q = (g * TS + tt) * kTileRows + lane;
          if (lane < s_urows[g * TS + tt]) cost += s_rho[q] * s_kwv[q];
        }
      }
      // the weighted rows of J, zeros past a part's end: a thread a tangent
      // d of every (nthreads / D)-th row
      if (D > 0 && tid < nthreads / D * D) {
        const int d = tid % D, stride = nthreads / D;
#pragma unroll 4
        for (int q = tid / D; q < units * kTileRows; q += stride) {
          const int u = q / kTileRows, i = q - u * kTileRows;
          W[q * Dpad + d] = i < s_urows[u] ? base[s_uj[u] + i * D + d] * s_ww[q] : T(0);
        }
      }
      __syncthreads();
      // the raw stage is free: the copies of step s + stages fly during the
      // products (with one stage, the next step's: its copies wait for this
      // step's weighting)
      if (warp == 0 && !one_step) issue(s + stages);
      // the tile sums: an item u nblk + blk a tile's block (with a tile a
      // part, the item is its block's owner)
      for (int item = tid; item < units * nblk; item += nthreads) {
        const int u = item / nblk;
        const int blk = item - u * nblk;
        if (s_urows[u] == 0) continue;   // no such tile
        const int k0 = (int)(s_blk[blk] >> 16), l0 = (int)(s_blk[blk] & 0xffff);
        const T* w = W + u * kTileRows * Dpad;
        T tile[kBB];
#pragma unroll
        for (int i = 0; i < kBB; ++i) tile[i] = T(0);
#pragma unroll 8
        for (int row = 0; row < kTileRows; ++row) {
          T uu[kBlock], vv[kBlock];
          load4(w + row * Dpad + k0, uu);
          load4(w + row * Dpad + l0, vv);
#pragma unroll
          for (int i = 0; i < kBlock; ++i)
#pragma unroll
            for (int jj = 0; jj < kBlock; ++jj) tile[i * kBlock + jj] += uu[i] * vv[jj];
        }
        if (TS == 1) {
#pragma unroll
          for (int j = 0; j < kItems; ++j)
            if (j == item / nthreads)
#pragma unroll
              for (int i = 0; i < kBB; ++i) acc[j][i] += tile[i];
        } else {
#pragma unroll
          for (int i = 0; i < kBB; ++i) S[item * kBB + i] = tile[i];
        }
      }
      if (TS > 1) {
        // the owners add the step's tile sums, tiles in order
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int o = tid + j * nthreads;
          if (o >= G * nblk) continue;
          const int g = o / nblk, blk = o - g * nblk;
          for (int tt = 0; tt < TS && s_urows[g * TS + tt] > 0; ++tt) {
            const T* ts = S + ((g * TS + tt) * nblk + blk) * kBB;
#pragma unroll
            for (int i = 0; i < kBB; ++i) acc[j][i] += ts[i];
          }
        }
      }
      if (t == nsteps - 1) {
        // the round's parts into the CTA's sums, in part order: the owners
        // hand their sums to shared memory; each part's cost, its lanes in
        // order
        __syncthreads();
        if (warp < G) {
          T sum = T(0);
          for (int i = 0; i < kTileRows; ++i) sum += __shfl_sync(0xffffffffu, cost, i);
          if (lane == 0) s_psum[rho * G + warp] = sum;
        }
        if (G == 1) {
          // one part: its owners add their blocks
#pragma unroll
          for (int j = 0; j < kItems; ++j) {
            const int blk = tid + j * nthreads;
            if (blk >= nblk) continue;
            const int k0 = (int)(s_blk[blk] >> 16), l0 = (int)(s_blk[blk] & 0xffff);
            int at[kBB];
            T now[kBB];
#pragma unroll
            for (int i = 0; i < kBB; ++i) {
              const int k = k0 + i / kBlock, l = l0 + i % kBlock;
              at[i] = k <= l && l <= D && k < D ? 1 + entry_index(k, l, D) : -1;
              now[i] = at[i] >= 0 ? x[at[i]] : T(0);
            }
#pragma unroll
            for (int i = 0; i < kBB; ++i)
              if (at[i] >= 0) x[at[i]] = now[i] + acc[j][i];
          }
        }
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const int o = tid + j * nthreads;
          if (G == 1 || o >= G * nblk) continue;
#pragma unroll
          for (int i = 0; i < kBB; ++i) S[o * kBB + i] = acc[j][i];
        }
        __syncthreads();
        // a thread a block entry adds the parts in order
        for (int q = tid; G > 1 && q < nblk * kBB; q += nthreads) {
          const int blk = q / kBB, i = q - blk * kBB;
          const int k = (int)(s_blk[blk] >> 16) + i / kBlock;
          const int l = (int)(s_blk[blk] & 0xffff) + i % kBlock;
          if (!(k <= l && l <= D && k < D)) continue;
          T* xe = x + 1 + entry_index(k, l, D);
          T sum = *xe;
          for (int g = 0; g < G; ++g) sum += S[(g * nblk + blk) * kBB + i];
          *xe = sum;
        }
#pragma unroll
        for (int j = 0; j < kItems; ++j)
#pragma unroll
          for (int i = 0; i < kBB; ++i) acc[j][i] = T(0);
        cost = T(0);
      }
      __syncthreads();
    }
  }
  // the cost: the CTA's parts in order (a part without rows adds 0)
  __syncthreads();
  if (tid == 0) {
    T sum = x[0];
    for (int b = 0; b < nparts; ++b) sum += s_psum[b];
    x[0] = sum;
  }

  const int n_e = 1 + E;
  // entry e's 16 chunk sums, in chunk order, into cost, g and H's two triangles
  auto combine = [&](int e, const T* chunk) {
    T sum = T(0), comp = T(0);
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      const T xc = chunk[cc];
      if (compensated && e > 0) {
        const T y = xc - comp;
        const T t = sum + y;
        comp = (t - sum) - y;
        sum = t;
      } else {
        sum += xc;
      }
    }
    if (e == 0) {
      *cost_out = sum;
      return;
    }
    int k, l;
    entry_kl(e - 1, D, &k, &l);
    if (l == D) {
      g_out[k] = sum;
    } else {
      H_out[(long long)k * D + l] = sum;
      H_out[(long long)l * D + k] = sum;
    }
  };

  cluster.sync();
  const int per = (n_e + ranks - 1) / ranks;
  const int e_begin = rank * per;
  const int e_end = e_begin + per < n_e ? e_begin + per : n_e;
  if (per_chunk == 1) {
    // each CTA combines a 16th of the entries from the 16 chunks' CTAs
    for (int e = e_begin + tid; e < e_end; e += nthreads) {
      T chunk[kChunks];
#pragma unroll
      for (int cc = 0; cc < kChunks; ++cc) chunk[cc] = cluster.map_shared_rank(x, cc)[e];
      combine(e, chunk);
    }
    // no CTA leaves while another may still read its shared memory
    cluster.sync();
    return;
  }
  // each CTA of the chunk adds an 8th of the entries over the chunk's parts
  for (int e = e_begin + tid; e < e_end; e += nthreads) {
    T sum = T(0);
    for (int q = 0; q < ranks; ++q) sum += cluster.map_shared_rank(x, q)[e];
    chunk_sums[(long long)c * n_e + e] = sum;
  }
  cluster.sync();
  // the last CTA to finish combines the chunks
  __threadfence();
  __syncthreads();
  int* s_last = s_urows;   // free by now
  if (tid == 0) *s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  // two entries a thread at once: their 32 loads fly together
  for (int e = tid; e < n_e; e += 2 * nthreads) {
    const int e2 = e + nthreads;
    T chunk[kChunks], chunk2[kChunks];
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      chunk[cc] = __ldcg(chunk_sums + (long long)cc * n_e + e);
      chunk2[cc] = e2 < n_e ? __ldcg(chunk_sums + (long long)cc * n_e + e2) : T(0);
    }
    combine(e, chunk);
    if (e2 < n_e) combine(e2, chunk2);
  }
  if (tid == 0) *ticket = 0u;
}

template <typename T, int kItems>
int launch_cluster(const void* r, const void* J, const void* kp_w, void* cost, void* patch,
                   void* g, void* H, void* chunk_sums, void* ticket, int F, int N, int P, int D,
                   double a, int compensated, int G, int TS, int stages, int threads,
                   int per_chunk, int kw_staged, long long smem, void* stream) {
  if ((per_chunk != 1 && per_chunk != kSplit) || (per_chunk == kSplit && G != 1) || G < 1 ||
      kSplit % G != 0 || TS < 1 || G * TS > 32 || (stages != 1 && stages != 2) ||
      threads < 32 * G || threads > kClusterThreads || threads % 32 != 0 ||
      (long long)G * cluster_layout(D, G, TS, stages, (int)sizeof(T), 0).nblk >
          (long long)kItems * threads ||
      smem != cluster_layout(D, G, TS, stages, (int)sizeof(T), kw_staged ? N : 0).total ||
      smem > kMaxShared)
    return (int)cudaErrorInvalidValue;
  auto kernel = normal_equations_cluster<T, kItems>;
  static int ready_on = -1;   // the device whose attributes are set
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != ready_on) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err != cudaSuccess) return (int)err;
    ready_on = device;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kChunks * per_chunk);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = per_chunk == 1 ? kChunks : per_chunk;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const T*)r, (const T*)J, (const T*)kp_w, (T*)cost,
                           (T*)patch, (T*)g, (T*)H, (T*)chunk_sums, (unsigned*)ticket, F, N, P,
                           D, a, compensated, G, TS, stages, per_chunk, kw_staged);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cluster_items(const void* r, const void* J, const void* kp_w, void* cost,
                         void* patch, void* g, void* H, void* chunk_sums, void* ticket, int F,
                         int N, int P, int D, double a, int compensated, int G, int TS,
                         int stages, int items, int threads, int per_chunk, int kw_staged,
                         long long smem, void* stream) {
  if (items == 1)
    return launch_cluster<T, 1>(r, J, kp_w, cost, patch, g, H, chunk_sums, ticket, F, N, P, D,
                                a, compensated, G, TS, stages, threads, per_chunk, kw_staged,
                                smem, stream);
  if (items == 2)
    return launch_cluster<T, 2>(r, J, kp_w, cost, patch, g, H, chunk_sums, ticket, F, N, P, D,
                                a, compensated, G, TS, stages, threads, per_chunk, kw_staged,
                                smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int normal_equations_max_tangents() { return kMaxTangents; }
int normal_equations_chunks() { return kChunks; }
int normal_equations_blocks() { return kChunks * kSplit; }
int normal_equations_cluster_threads() { return kClusterThreads; }

// the split design: scratch `part` [16 x 8, 1 + E] from the wrapper
#define NE_ARGS                                                                        \
  const void *r, const void *J, const void *kp_w, void *part, void *cost, void *patch, \
      void *g, void *H, int F, int N, int P, int D, double a, int compensated, void *stream
#define NE_PASS r, J, kp_w, part, cost, patch, g, H, F, N, P, D, a, compensated, stream

int normal_equations_split_f32(NE_ARGS) { return launch_split<float>(NE_PASS); }
int normal_equations_split_f64(NE_ARGS) { return launch_split<double>(NE_PASS); }

// the cluster design: G parts a round, TS tiles a step, stages, `items`
// blocks a thread, threads a CTA, CTAs a chunk, kp_w staged or not and the
// dynamic shared memory, all from the
// wrapper's layout (checked here); with 8 CTAs a chunk the scratch
// `chunk_sums` [16, 1 + E] and the ticket
#define NC_ARGS                                                                           \
  const void *r, const void *J, const void *kp_w, void *cost, void *patch, void *g,       \
      void *H, void *chunk_sums, void *ticket, int F, int N, int P, int D, double a,      \
      int compensated, int G, int TS, int stages, int items, int threads, int per_chunk,  \
      int kw_staged, long long smem, void *stream
#define NC_PASS                                                                          \
  r, J, kp_w, cost, patch, g, H, chunk_sums, ticket, F, N, P, D, a, compensated, G, TS, \
      stages, items, threads, per_chunk, kw_staged, smem, stream

int normal_equations_f32(NC_ARGS) { return launch_cluster_items<float>(NC_PASS); }
int normal_equations_f64(NC_ARGS) { return launch_cluster_items<double>(NC_PASS); }

}  // extern "C"
