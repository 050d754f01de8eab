// A stand-in for the CUDA runtime header, so that a kernel source of
// stochvolmodels_torch/csrc compiles with g++ (-std=c++20) and runs on the
// CPU: one std::thread per CUDA thread, a std::barrier per block for
// __syncthreads (and one per warp for the shuffles), and the blocks of a
// grid (one- or two-dimensional) run one after another, so that a
// __shared__ array (a static) belongs to the block that runs.  A launch
// `kernel<<<grid, block, shmem, stream>>>(args...)` must be rewritten into
// `cuda_stub::launch(kernel, grid, block, shmem, stream, args...)` before
// compiling (tests/test_torch_kernel_rehearsal.py does).  One grid at a time.
#pragma once

#include <barrier>
#include <bit>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
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
  unsigned int x, y, z;
  dim3(unsigned int x_ = 1, unsigned int y_ = 1, unsigned int z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct __attribute__((aligned(8))) uint2 {
  uint32_t x, y;
};
struct __attribute__((aligned(16))) uint4 {
  uint32_t x, y, z, w;
};
struct __attribute__((aligned(16))) float4 {
  float x, y, z, w;
};
struct __attribute__((aligned(16))) double2 {
  double x, y;
};

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* cuda_stub_block_barrier = nullptr;

inline void __syncthreads() { cuda_stub_block_barrier->arrive_and_wait(); }

// a warp's exchange: each lane posts its value, the warp meets, reads its
// partner's, and meets again before the slots are reused
struct CudaStubWarp {
  explicit CudaStubWarp(int lanes) : sync(lanes) {}
  std::barrier<> sync;
  uint64_t slots[32];
};
inline thread_local CudaStubWarp* cuda_stub_warp = nullptr;

template <typename T>
T __shfl_xor_sync(unsigned /*mask*/, T v, int lane_mask) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "a shuffle moves at most 8 bytes");
  const unsigned lane = threadIdx.x & 31u;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  cuda_stub_warp->slots[lane] = bits;
  cuda_stub_warp->sync.arrive_and_wait();
  bits = cuda_stub_warp->slots[lane ^ static_cast<unsigned>(lane_mask)];
  cuda_stub_warp->sync.arrive_and_wait();
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}

inline float __uint_as_float(uint32_t v) { return std::bit_cast<float>(v); }
inline float __int_as_float(int v) { return std::bit_cast<float>(v); }
inline int __float_as_int(float v) { return std::bit_cast<int>(v); }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
using std::isnan;

namespace cuda_stub {

template <typename Kernel, typename... Args>
void launch(Kernel kernel, dim3 grid, unsigned int block, int /*shmem*/,
            cudaStream_t /*stream*/, Args... args) {
  gridDim = dim3{grid.x, grid.y, 1};
  blockDim = dim3{block, 1, 1};
  for (unsigned int by = 0; by < grid.y; ++by) {
    for (unsigned int b = 0; b < grid.x; ++b) {
      blockIdx = dim3{b, by, 0};
      std::barrier<> sync(block);
      cuda_stub_block_barrier = &sync;
      std::vector<std::unique_ptr<CudaStubWarp>> warps;
      for (unsigned int w = 0; w < block; w += 32)
        warps.push_back(std::make_unique<CudaStubWarp>(block - w < 32 ? block - w : 32));
      std::vector<std::thread> threads;
      threads.reserve(block);
      for (unsigned int t = 0; t < block; ++t) {
        CudaStubWarp* warp = warps[t / 32].get();
        threads.emplace_back([=] {
          threadIdx = dim3{t, 0, 0};
          cuda_stub_warp = warp;
          kernel(args...);
        });
      }
      for (auto& th : threads) th.join();
    }
  }
}

template <typename Kernel, typename... Args>
void launch(Kernel kernel, unsigned int grid, unsigned int block, int shmem, cudaStream_t stream,
            Args... args) {
  launch(kernel, dim3{grid, 1, 1}, block, shmem, stream, args...);
}

}  // namespace cuda_stub
