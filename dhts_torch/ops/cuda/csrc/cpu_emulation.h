// Host C++ stand-ins for the CUDA dialect the kernels of this directory use,
// so that their logic can be compiled with a host compiler and run on the
// CPU:
//
//   g++ -std=c++20 -O2 -ffp-contract=off -DDHTS_CPU_EMULATION -x c++
//       -shared -fPIC -pthread -o libk.so kernel.cu
//
// Each CUDA thread of a block is a fiber on the calling host thread,
// switched by a few x86-64 instructions that save the callee-saved
// registers and the stack pointer (an x86-64 host only: ucontext's switch,
// which also saves the signal mask with a system call, made the host
// tests several times slower); the blocks of a grid run one after
// another. A fiber runs until it waits: at __syncthreads() for every live thread of its block, at a warp
// exchange (__syncwarp(), a shuffle) for every live thread of its warp of
// 32. The scheduler resumes the waiting fibers once their group is
// complete, so warps that take different paths between two block barriers
// stay correct. A shuffle is one exchange round among its warp's fibers:
// each writes its value, waits for the warp, and reads its source lane's
// (two slots, used in turn, keep the next round from overwriting a value
// not yet read). Dynamic shared memory is one host buffer. Float arithmetic
// stays IEEE single precision without contraction, as on the card with
// -fmad=false. Only what the kernels use is provided: a 1-D grid,
// threadIdx.x and blockIdx.x, __syncthreads(), __syncthreads_count() (a
// count of the block's live threads) and the warp primitives
// reached by every live thread of their group (the member mask is not
// read), atomicAdd on int, __threadfence(), __ldcg(), a clock64() that
// counts host nanoseconds, and named barriers (PTX bar.sync / bar.arrive
// with an id and a thread count: bar_sync and bar_arrive below; a barrier
// completes when its count of threads has reached it, and then releases
// the threads that wait at it).
#pragma once

#include <math.h>

#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __align__(n)

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

#if !defined(__x86_64__)
#error "the host emulation switches fibers with x86-64 instructions"
#endif

// dhts_emu_swap(&save, load): push the callee-saved registers, the SSE
// control word and the x87 control word on this stack, store the stack
// pointer in `save`, load `load` (a stack left by this function, or a new
// one laid out as it leaves one) and pop them there; hidden and weak, so
// that each library keeps its own and a second copy merges
extern "C" void dhts_emu_swap(void** save, void* load);
__asm__(
    ".text\n"
    ".p2align 4\n"
    ".weak dhts_emu_swap\n"
    ".hidden dhts_emu_swap\n"
    ".type dhts_emu_swap,@function\n"
    "dhts_emu_swap:\n"
    "  pushq %rbp\n"
    "  pushq %rbx\n"
    "  pushq %r12\n"
    "  pushq %r13\n"
    "  pushq %r14\n"
    "  pushq %r15\n"
    "  subq $8, %rsp\n"
    "  stmxcsr (%rsp)\n"
    "  fnstcw 4(%rsp)\n"
    "  movq %rsp, (%rdi)\n"
    "  movq %rsi, %rsp\n"
    "  ldmxcsr (%rsp)\n"
    "  fldcw 4(%rsp)\n"
    "  addq $8, %rsp\n"
    "  popq %r15\n"
    "  popq %r14\n"
    "  popq %r13\n"
    "  popq %r12\n"
    "  popq %rbx\n"
    "  popq %rbp\n"
    "  ret\n"
    ".size dhts_emu_swap, .-dhts_emu_swap\n");

namespace dhts_emu {
struct Idx { unsigned x = 0, y = 0, z = 0; };
inline Idx thread_idx;
inline Idx block_idx;
inline char* dyn_smem = nullptr;
inline void* scheduler = nullptr;  // the scheduler's saved stack pointer
inline void** running = nullptr;   // where the running fiber's is saved
inline bool finished = false;
inline void (*body)(void*) = nullptr;
inline void* body_arg = nullptr;

// what each fiber of the running block waits for
enum Wait : char { RUN, BLOCK, WARP, NAMED, DONE };
constexpr int NAMED_BARRIERS = 16;
inline int named_count[NAMED_BARRIERS];  // threads that reached barrier id
inline char* named_id = nullptr;         // [threads] the barrier it waits at
inline int block_threads = 0;
inline int current = 0;            // the running fiber
inline Wait* waits = nullptr;      // [threads]
inline int* counted = nullptr;     // [threads] __syncthreads_count's term
inline char* parity = nullptr;     // [threads] the slot of its next shuffle
constexpr int SLOT_WORDS = 4;     // a shuffled value: up to 32 bytes
inline uint64_t* slots = nullptr;  // [warps][2][32][SLOT_WORDS] values

// a fiber's first frame: run the kernel, then hand back to the scheduler
// for good
inline void fiber_entry() {
  body(body_arg);
  finished = true;
  dhts_emu_swap(running, scheduler);
  __builtin_unreachable();
}

// the stack pointer of a new fiber on `stack` (`size` bytes): the frame
// dhts_emu_swap pops (the control words of this thread, zeroed callee-saved
// registers) and fiber_entry as its return address, 16-byte aligned as a
// call leaves it
inline void* new_fiber(char* stack, size_t size) {
  uintptr_t top = (reinterpret_cast<uintptr_t>(stack) + size) & ~uintptr_t(15);
  void** sp = reinterpret_cast<void**>(top) - 9;
  uint32_t words[2] = {0, 0};
  __asm__ volatile("stmxcsr %0\n\tfnstcw %1"
                   : "=m"(words[0]), "=m"(words[1]));
  std::memcpy(sp, words, sizeof words);
  for (int i = 1; i < 7; ++i) sp[i] = nullptr;
  sp[7] = reinterpret_cast<void*>(&fiber_entry);
  sp[8] = nullptr;
  return sp;
}

inline void wait_for(Wait w) {
  waits[current] = w;
  dhts_emu_swap(running, scheduler);
}
inline void sync_threads() { wait_for(BLOCK); }
// __syncthreads_count: the live threads whose `pred` is nonzero, after the
// barrier; a second barrier keeps the next count from overwriting a term
// not yet read (a thread that has returned counts 0)
inline int sync_threads_count(int pred) {
  counted[current] = pred != 0;
  sync_threads();
  int n = 0;
  for (int i = 0; i < block_threads; ++i) n += counted[i];
  sync_threads();
  return n;
}
inline void sync_warp() { wait_for(WARP); }

// this fiber reaches named barrier `id` of `count` threads; true when it
// completes the barrier, which then releases its waiters and resets
inline bool named_reach(int id, int count) {
  if (++named_count[id] < count) return false;
  named_count[id] = 0;
  for (int i = 0; i < block_threads; ++i)
    if (waits[i] == NAMED && named_id[i] == id) waits[i] = RUN;
  return true;
}
inline void named_sync(int id, int count) {
  if (named_reach(id, count)) return;
  named_id[current] = static_cast<char>(id);
  wait_for(NAMED);
}
inline void named_arrive(int id, int count) { named_reach(id, count); }

// one exchange round: the value of lane `src` of this fiber's warp (a
// scalar, or a plain struct of up to 32 bytes, which a kernel's CUDA build
// shuffles word by word)
template <class T>
T exchange(T v, int src) {
  static_assert(sizeof(T) <= SLOT_WORDS * sizeof(uint64_t),
                "shuffle of a wide type");
  const int lane = current % 32;
  uint64_t* slot = slots + (size_t(current / 32) * 64 +
                            32 * parity[current]) * SLOT_WORDS;
  parity[current] ^= 1;
  std::memcpy(slot + lane * SLOT_WORDS, &v, sizeof(T));
  sync_warp();
  T out;
  std::memcpy(&out, slot + src * SLOT_WORDS, sizeof(T));
  return out;
}

// release the waiting groups that are complete; false if none is
inline bool release(int threads) {
  int live = 0, at_block = 0;
  for (int i = 0; i < threads; ++i) {
    live += waits[i] != DONE;
    at_block += waits[i] == BLOCK;
  }
  if (live > 0 && at_block == live) {
    for (int i = 0; i < threads; ++i)
      if (waits[i] == BLOCK) waits[i] = RUN;
    return true;
  }
  bool any = false;
  for (int w0 = 0; w0 < threads; w0 += 32) {
    const int w1 = min(w0 + 32, threads);
    int n_live = 0, n_warp = 0;
    for (int i = w0; i < w1; ++i) {
      n_live += waits[i] != DONE;
      n_warp += waits[i] == WARP;
    }
    if (n_live > 0 && n_warp == n_live) {
      for (int i = w0; i < w1; ++i)
        if (waits[i] == WARP) waits[i] = RUN;
      any = true;
    }
  }
  return any;
}

// the fibers' stacks, `bytes` of them, kept from launch to launch on this
// host thread and never cleared (a page a fiber does not touch costs
// nothing)
inline char* fiber_stacks(size_t bytes) {
  static thread_local std::unique_ptr<char[]> buf;
  static thread_local size_t have = 0;
  if (bytes > have) {
    buf.reset(new char[bytes]);
    have = bytes;
  }
  return buf.get();
}

template <class Kernel, class... Args>
void launch(int blocks, int threads, size_t smem, Kernel kernel,
            Args... args) {
  constexpr size_t STACK = size_t(1) << 18;
  const int warps = (threads + 31) / 32;
  std::vector<char> buf(smem + 16);
  char* stacks = fiber_stacks(size_t(threads) * STACK);
  std::vector<void*> ctx(threads);
  std::vector<Wait> wait(threads);
  std::vector<char> par(threads);
  std::vector<char> nid(threads);
  std::vector<int> cnt(threads);
  std::vector<uint64_t> slot(size_t(warps) * 64 * SLOT_WORDS);
  auto call = [&] { kernel(args...); };
  using Call = decltype(call);
  body = [](void* p) { (*static_cast<Call*>(p))(); };
  body_arg = &call;
  dyn_smem = buf.data();
  waits = wait.data();
  parity = par.data();
  named_id = nid.data();
  counted = cnt.data();
  block_threads = threads;
  slots = slot.data();
  for (int b = 0; b < blocks; ++b) {
    block_idx.x = static_cast<unsigned>(b);
    for (int& c : named_count) c = 0;
    for (int i = 0; i < threads; ++i) {
      ctx[i] = new_fiber(stacks + size_t(i) * STACK, STACK);
      wait[i] = RUN;
      par[i] = 0;
      cnt[i] = 0;
    }
    for (int live = threads; live > 0;) {
      for (int i = 0; i < threads; ++i) {
        if (wait[i] != RUN) continue;
        thread_idx.x = static_cast<unsigned>(i);
        current = i;
        running = &ctx[i];
        finished = false;
        dhts_emu_swap(&scheduler, ctx[i]);
        if (finished) { wait[i] = DONE; cnt[i] = 0; --live; }
      }
      // a named barrier may have released fibers this pass has passed
      bool any_run = false;
      for (int i = 0; i < threads; ++i) any_run = any_run || wait[i] == RUN;
      if (live > 0 && !any_run && !release(threads)) {
        std::fprintf(stderr, "cpu_emulation: block %d deadlocked (a "
                     "barrier or warp exchange some threads never reach)\n",
                     b);
        std::abort();
      }
    }
  }
  dyn_smem = nullptr;
  running = nullptr;
  waits = nullptr;
  parity = nullptr;
  named_id = nullptr;
  counted = nullptr;
  slots = nullptr;
}
}  // namespace dhts_emu

#define threadIdx (::dhts_emu::thread_idx)
#define blockIdx (::dhts_emu::block_idx)
#define __syncthreads() (::dhts_emu::sync_threads())
#define __syncthreads_count(p) (::dhts_emu::sync_threads_count(p))
#define DHTS_DYNAMIC_SMEM(name) char* name = ::dhts_emu::dyn_smem

inline void __syncwarp(unsigned = 0xffffffffu) { ::dhts_emu::sync_warp(); }

// PTX bar.sync / bar.arrive: wait at, or only arrive at, named barrier `id`
// (1-15; 0 is __syncthreads') that completes with `count` threads
inline void bar_sync(int id, int count) { ::dhts_emu::named_sync(id, count); }
inline void bar_arrive(int id, int count) {
  ::dhts_emu::named_arrive(id, count);
}

// The shuffles of CUDA's warp-level primitives. `width` splits the warp
// into segments; a lane whose source lies outside its segment (up: below
// it, down: past it) gets its own value.
template <class T>
T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = ::dhts_emu::current % 32;
  const int base = lane / width * width;
  return ::dhts_emu::exchange(v, base + ((src % width) + width) % width);
}
template <class T>
T __shfl_up_sync(unsigned, T v, unsigned delta, int width = 32) {
  const int lane = ::dhts_emu::current % 32;
  const int src = lane % width >= (int)delta ? lane - (int)delta : lane;
  return ::dhts_emu::exchange(v, src);
}
template <class T>
T __shfl_down_sync(unsigned, T v, unsigned delta, int width = 32) {
  const int lane = ::dhts_emu::current % 32;
  const int src = lane % width + (int)delta < width ? lane + (int)delta
                                                    : lane;
  return ::dhts_emu::exchange(v, src);
}

inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// blocks run one after another on one host thread: plain memory suffices
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
inline void __threadfence() {}
template <class T>
T __ldcg(const T* p) {
  return *p;
}
