// A stand-in for the CUDA runtime header, so that a kernel source of
// stochvolmodels_torch/csrc compiles with g++ (-std=c++20) and runs on the
// CPU: one std::thread per CUDA thread, a std::barrier per block for
// __syncthreads, and the blocks of a grid run one after another, so that a
// __shared__ array (a static) belongs to the block that runs.  A launch
// `kernel<<<grid, block, shmem, stream>>>(args...)` must be rewritten into
// `cuda_stub::launch(kernel, grid, block, shmem, stream, args...)` before
// compiling (tests/test_torch_kernel_rehearsal.py does).  One grid at a time.
#pragma once

#include <barrier>
#include <bit>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned int x = 0, y = 0, z = 0;
};
struct __attribute__((aligned(8))) uint2 {
  uint32_t x, y;
};
struct __attribute__((aligned(16))) uint4 {
  uint32_t x, y, z, w;
};

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* cuda_stub_block_barrier = nullptr;

inline void __syncthreads() { cuda_stub_block_barrier->arrive_and_wait(); }

inline float __uint_as_float(uint32_t v) { return std::bit_cast<float>(v); }
inline float __int_as_float(int v) { return std::bit_cast<float>(v); }
inline int __float_as_int(float v) { return std::bit_cast<int>(v); }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
using std::isnan;

namespace cuda_stub {

template <typename Kernel, typename... Args>
void launch(Kernel kernel, unsigned int grid, unsigned int block, int /*shmem*/,
            cudaStream_t /*stream*/, Args... args) {
  gridDim = dim3{grid, 1, 1};
  blockDim = dim3{block, 1, 1};
  for (unsigned int b = 0; b < grid; ++b) {
    blockIdx = dim3{b, 0, 0};
    std::barrier<> sync(block);
    cuda_stub_block_barrier = &sync;
    std::vector<std::thread> threads;
    threads.reserve(block);
    for (unsigned int t = 0; t < block; ++t) {
      threads.emplace_back([=] {
        threadIdx = dim3{t, 0, 0};
        kernel(args...);
      });
    }
    for (auto& th : threads) th.join();
  }
}

}  // namespace cuda_stub
