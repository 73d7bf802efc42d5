// Host C++ stand-ins for the CUDA dialect the kernels of this directory use,
// so that their logic can be compiled with a host compiler and run on the
// CPU, one std::thread per CUDA thread of a single block:
//
//   g++ -std=c++20 -O2 -ffp-contract=off -DDHTS_CPU_EMULATION -x c++
//       -shared -fPIC -pthread -o libk.so kernel.cu
//
// __syncthreads() is a std::barrier over the block, dynamic shared memory
// one host buffer. Float arithmetic stays IEEE single precision without
// contraction, as on the card with -fmad=false. Only what the kernels use
// is provided: one block, threadIdx.x, no warp intrinsics.
#pragma once

#include <barrier>
#include <math.h>
#include <cstddef>
#include <cstdint>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __align__(n)

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

namespace dhts_emu {
struct Idx { unsigned x = 0, y = 0, z = 0; };
inline thread_local Idx thread_idx;
inline std::barrier<>* block_barrier = nullptr;
inline char* dyn_smem = nullptr;

template <class Kernel, class... Args>
void launch(int threads, size_t smem, Kernel kernel, Args... args) {
  std::vector<char> buf(smem + 16);
  dyn_smem = buf.data();
  std::barrier<> bar(threads);
  block_barrier = &bar;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int i = 0; i < threads; ++i)
    pool.emplace_back([=] {
      thread_idx.x = static_cast<unsigned>(i);
      kernel(args...);
    });
  for (auto& th : pool) th.join();
  block_barrier = nullptr;
  dyn_smem = nullptr;
}
}  // namespace dhts_emu

#define threadIdx (::dhts_emu::thread_idx)
#define __syncthreads() (::dhts_emu::block_barrier->arrive_and_wait())
#define DHTS_DYNAMIC_SMEM(name) char* name = ::dhts_emu::dyn_smem
