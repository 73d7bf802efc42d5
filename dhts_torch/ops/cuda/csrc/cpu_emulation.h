// Host C++ stand-ins for the CUDA dialect the kernels of this directory use,
// so that their logic can be compiled with a host compiler and run on the
// CPU:
//
//   g++ -std=c++20 -O2 -ffp-contract=off -DDHTS_CPU_EMULATION -x c++
//       -shared -fPIC -pthread -o libk.so kernel.cu
//
// Each CUDA thread of a block is a fiber (ucontext) on the calling host
// thread. The fibers run one after another, each up to its next
// __syncthreads() or its end, and a round over all of them is one barrier
// phase; dynamic shared memory is one host buffer. The blocks of a grid run
// one after another. Float arithmetic stays IEEE single precision without
// contraction, as on the card with -fmad=false. Only what the kernels use is
// provided: a 1-D grid, threadIdx.x and blockIdx.x, __syncthreads() reached
// by every thread of the block, no warp intrinsics.
#pragma once

#include <math.h>
#include <ucontext.h>

#include <cstddef>
#include <cstdint>
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
inline Idx thread_idx;
inline Idx block_idx;
inline char* dyn_smem = nullptr;
inline ucontext_t scheduler;
inline ucontext_t* running = nullptr;
inline bool finished = false;
inline void (*body)(void*) = nullptr;
inline void* body_arg = nullptr;

inline void fiber_entry() {
  body(body_arg);
  finished = true;  // returns to `scheduler` through uc_link
}

inline void sync_threads() { swapcontext(running, &scheduler); }

template <class Kernel, class... Args>
void launch(int blocks, int threads, size_t smem, Kernel kernel,
            Args... args) {
  constexpr size_t STACK = size_t(1) << 18;
  std::vector<char> buf(smem + 16);
  std::vector<char> stacks(size_t(threads) * STACK);
  std::vector<ucontext_t> ctx(threads);
  std::vector<char> done(threads);
  auto call = [&] { kernel(args...); };
  using Call = decltype(call);
  body = [](void* p) { (*static_cast<Call*>(p))(); };
  body_arg = &call;
  dyn_smem = buf.data();
  for (int b = 0; b < blocks; ++b) {
    block_idx.x = static_cast<unsigned>(b);
    for (int i = 0; i < threads; ++i) {
      getcontext(&ctx[i]);
      ctx[i].uc_stack.ss_sp = stacks.data() + size_t(i) * STACK;
      ctx[i].uc_stack.ss_size = STACK;
      ctx[i].uc_link = &scheduler;
      makecontext(&ctx[i], fiber_entry, 0);
      done[i] = 0;
    }
    for (int live = threads; live > 0;) {
      for (int i = 0; i < threads; ++i) {
        if (done[i]) continue;
        thread_idx.x = static_cast<unsigned>(i);
        running = &ctx[i];
        finished = false;
        swapcontext(&scheduler, &ctx[i]);
        if (finished) { done[i] = 1; --live; }
      }
    }
  }
  dyn_smem = nullptr;
  running = nullptr;
}
}  // namespace dhts_emu

#define threadIdx (::dhts_emu::thread_idx)
#define blockIdx (::dhts_emu::block_idx)
#define __syncthreads() (::dhts_emu::sync_threads())
#define DHTS_DYNAMIC_SMEM(name) char* name = ::dhts_emu::dyn_smem
