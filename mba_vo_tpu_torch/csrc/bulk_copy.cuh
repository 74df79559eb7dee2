// Bulk copies into shared memory for Hopper (sm_90a): cp.async.bulk (the
// TMA's one-dimensional copy, no tensor map) completed on an mbarrier.
//
// A Run is one contiguous run of n elements in device memory, bound for a
// 16-byte aligned slot of shared memory in which element i lands `lead + i`
// elements in (lead: the run's start modulo 16 bytes). A bulk copy needs its
// source, its destination and its size 16-byte aligned, so it moves the
// run's body, the elements between its first and its last 16-byte boundary;
// the few elements before and after the body (at most 16 bytes less one
// element each) are ordinary loads, which issue makes after the copy.
// Nothing outside the run is read. A slot must hold the run's bytes plus 16
// (slot_bytes). Producer and consumers build the same Run from the same
// pointer and length, so nothing about the copy passes through shared
// memory.
//
// A phase of a barrier has two arrivals (bar_init's count 2): one announcing
// the bytes its bulk copies will deliver (bar_arrive_expect), before they are
// issued, and one after the edges are stored (bar_arrive, which releases
// those stores to the threads that wait on the phase).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the asynchronous proxy (and to
// the cluster); the caller then synchronises the block
__device__ __forceinline__ void fence_bar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one arrival of a phase, announcing the bytes its copies will deliver
__device__ __forceinline__ void bar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// the plain arrival of a phase, after its edges' stores
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__host__ __device__ constexpr long long round16(long long bytes) { return (bytes + 15) / 16 * 16; }

// the shared memory a Run of `bytes` needs, whatever its alignment
__host__ __device__ constexpr long long slot_bytes(long long bytes) { return round16(bytes) + 16; }

template <typename T>
struct Run {
  // the most elements of an edge: one short of 16 bytes
  static constexpr int kEdge = 16 / sizeof(T) - 1;
  const T* g;      // the run in device memory
  T* s;            // its slot in shared memory (16-byte aligned)
  int lead;        // elements of the slot before the run's first
  int n;           // the run's elements
  int body0;       // the body: elements [body0, body1), 16-byte aligned
  int body1;

  __device__ __forceinline__ Run(const T* g_, T* s_, int n_) : g(g_), s(s_), n(n_) {
    const long long a = (long long)(uintptr_t)g_;
    const int off = (int)(a & 15);
    lead = off / (int)sizeof(T);
    const int first = ((16 - off) & 15) / (int)sizeof(T);
    body0 = first < n_ ? first : n_;
    const long long last = (((a + (long long)n_ * (long long)sizeof(T)) & ~15LL) - a) /
                           (long long)sizeof(T);
    body1 = last > body0 ? (int)last : body0;
  }
  // the bytes the bulk copy moves (0: none)
  __device__ __forceinline__ uint32_t bytes() const {
    return (uint32_t)(body1 - body0) * (uint32_t)sizeof(T);
  }
  // the body's bulk copy, then the edges
  __device__ __forceinline__ void issue(uint64_t* bar) const {
    if (body1 > body0) copy(s + lead + body0, g + body0, bytes(), bar);
    if (body0 > 0 || body1 < n) load_edges();
  }
  // the elements before and after the body, by ordinary loads (all in
  // flight at once)
  __device__ __forceinline__ void load_edges() const {
    T head[kEdge], tail[kEdge];
#pragma unroll
    for (int i = 0; i < kEdge; ++i) {
      if (i < body0) head[i] = g[i];
      if (body1 + i < n) tail[i] = g[body1 + i];
    }
#pragma unroll
    for (int i = 0; i < kEdge; ++i) {
      if (i < body0) s[lead + i] = head[i];
      if (body1 + i < n) s[lead + body1 + i] = tail[i];
    }
  }
  // the run's elements in shared memory, once the phase has completed
  __device__ __forceinline__ const T* data() const { return s + lead; }
  __device__ __forceinline__ T operator[](int i) const { return s[lead + i]; }
};

}  // namespace bulk
