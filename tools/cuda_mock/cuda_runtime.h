// CPU mock of the CUDA runtime for rehearsing csrc/pruning.cu with g++:
// every CUDA thread of a block is a std::thread; __syncthreads and
// __syncwarp are std::barriers; blocks run one after another.
#pragma once
#include <barrier>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <math.h>
#include <float.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
enum { cudaSharedmemCarveoutMaxShared = 100 };
inline int cudaGetLastError() { return 0; }
template <typename K> inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// no card, no occupancy: reports 0 blocks per SM
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 0;
  return cudaSuccess;
}

// stream-ordered allocation: host memory, filled with NaN bytes so that a
// read before a write shows
inline cudaError_t cudaMallocAsync(void** ptr, size_t bytes, cudaStream_t) {
  *ptr = std::malloc(bytes);
  if (*ptr == nullptr) return cudaErrorInvalidValue;
  std::memset(*ptr, 0xff, bytes);
  return cudaSuccess;
}
inline cudaError_t cudaFreeAsync(void* ptr, cudaStream_t) {
  std::free(ptr);
  return cudaSuccess;
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* mock_block_bar = nullptr;
inline thread_local std::barrier<>* mock_warp_bar = nullptr;
inline void __syncthreads() { mock_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { mock_warp_bar->arrive_and_wait(); }
template <typename T> inline T __ldg(const T* p) { return *p; }

namespace {
alignas(16) unsigned char smem[1 << 20];
}

template <typename F, typename... A>
void mock_launch(dim3 grid, dim3 block, size_t shm, cudaStream_t, F kernel, A... args) {
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::memset(smem, 0xff, sizeof(smem));
        std::barrier<> bar(n);
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        for (unsigned w = 0; w < (n + 31) / 32; ++w)
          warps.emplace_back(new std::barrier<>(std::min(32u, n - 32 * w)));
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < n; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            blockDim = block;
            gridDim = grid;
            mock_block_bar = &bar;
            mock_warp_bar = warps[t / 32].get();
            kernel(args...);
          });
        for (auto& th : ts) th.join();
      }
}
