// CPU mock of the CUDA runtime for rehearsing csrc/pruning.cu with g++:
// every CUDA thread of a block is a std::thread; __syncthreads and
// __syncwarp are std::barriers; blocks run one after another; the float64
// warp matrix product (mma.sync m16n8k4) is emulated lane by lane with the
// card's fragment layout and __shfl_xor_sync through per-warp slots; the
// card has IQ_MOCK_SMS multiprocessors (-D to choose the wide passes'
// pattern tile).
#pragma once
#define IQ_CUDA_MOCK 1
#ifndef IQ_MOCK_SMS
#define IQ_MOCK_SMS 1
#endif
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
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = IQ_MOCK_SMS;
  return cudaSuccess;
}
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

// the fragments each lane of a warp hands to an mma, and the values it
// hands to a shuffle (one per warp)
struct MockWarpFrags {
  double a0[32], a1[32], b[32], shfl[32];
};
inline thread_local MockWarpFrags* mock_warp_frags = nullptr;

// mma.sync.aligned.m16n8k4.row.col.f64: D = A B + D for a 16 x 4 A, a 4 x 8
// B and a 16 x 8 D held across the warp, lane l = 4 g + t holding A[g][t]
// (a0), A[g + 8][t] (a1), B[t][g] (b), D[g][2t + i] (d[i]) and
// D[g + 8][2t + i] (d[2 + i]). Every lane of the warp must call it.
inline void iq_mock_mma_m16n8k4(double* d, double a0, double a1, double b) {
  const unsigned lane = threadIdx.x & 31;
  MockWarpFrags& f = *mock_warp_frags;
  f.a0[lane] = a0;
  f.a1[lane] = a1;
  f.b[lane] = b;
  __syncwarp();
  const unsigned g = lane >> 2, t = lane & 3;
  for (unsigned i = 0; i < 4; ++i) {
    const unsigned r = g + 8 * (i >> 1), n = 2 * t + (i & 1);
    double acc = d[i];
    for (unsigned k = 0; k < 4; ++k)  // A[r][k] at lane 4 (r % 8) + k, B[k][n] at 4 n + k
      acc += (r < 8 ? f.a0[4 * r + k] : f.a1[4 * (r - 8) + k]) * f.b[4 * n + k];
    d[i] = acc;
  }
  __syncwarp();  // every lane has read the fragments before they are replaced
}

// __shfl_xor_sync over the whole warp (float or double: each value goes
// through a double exactly). Every lane of the warp must call it.
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  const unsigned lane = threadIdx.x & 31;
  MockWarpFrags& f = *mock_warp_frags;
  f.shfl[lane] = (double)v;
  __syncwarp();
  const T o = (T)f.shfl[lane ^ (unsigned)mask];
  __syncwarp();  // every lane has read its value before the slots are replaced
  return o;
}

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
        std::vector<MockWarpFrags> frags((n + 31) / 32);
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
            mock_warp_frags = &frags[t / 32];
            kernel(args...);
          });
        for (auto& th : ts) th.join();
      }
}
