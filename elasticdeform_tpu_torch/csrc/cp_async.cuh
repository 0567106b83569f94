// Asynchronous copies of one element from device memory into shared
// memory (cp.async), shared by the shared-memory tiles of K2/K4/K7 and K2's
// writeback product (prefilter.cu), K9 and K9T (filters.cu) and K10's box
// (morphology.cu). Without __CUDA_ARCH__ (a host
// compile of the sources) they are plain copies.
#pragma once

namespace {

// dst = *src, asynchronously
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T))
               : "memory");
#else
  *dst = *src;
#endif
}

// dst = in ? *src : 0, asynchronously: with `in` false the copy's source
// size is 0, it reads nothing and fills zeros
template <typename T>
__device__ __forceinline__ void stage_async_zfill(T* dst, const T* src,
                                                  bool in) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)), "r"(in ? (int)sizeof(T) : 0)
               : "memory");
#else
  *dst = in ? *src : T(0);
#endif
}

// waits for every copy this thread has in flight
__device__ __forceinline__ void stage_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// closes this thread's group of copies in flight (a double buffer's stage)
__device__ __forceinline__ void stage_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void stage_wait_group() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

}  // namespace
