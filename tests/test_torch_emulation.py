"""The host build's warp primitives (``csrc/cpu_emulation.h``) against a
numpy model of CUDA's shuffles.

A small kernel, compiled with g++ against the header as the kernels'
sources are, runs two warps (64 threads) per block over two blocks: each
thread shuffles its value (``__shfl_sync``, ``__shfl_up_sync`` or
``__shfl_down_sync`` at a segment width of 32 or 8) and then passes the
result one lane up, so that two exchange rounds run back to back. The
model: a lane whose source lies outside its segment (below it for up, past
it for down) keeps its own value. A second kernel runs a different number
of shuffles in each warp between two block barriers, reduces a warp's
maximum with ``__shfl_down_sync`` and reads the other warp's result
through shared memory after ``__syncthreads()`` and ``__syncwarp()``;
``clock64()`` does not run backwards. A third hands values from two
producer warps to a consumer warp through a two-slot ring guarded by
named barriers (``bar_sync`` / ``bar_arrive``, as K1's reduction warp
takes the lanes' records), for longer than the ring. A fourth shuffles a
32-byte struct down in one exchange round (K1's folds shuffle their terms
so, word by word on the card).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from dhts_torch.ops.cuda import _build

SOURCE = r"""
#include "cpu_emulation.h"

struct Args {
  const float* in;
  float *out1, *out2;
  int op, arg, width, n;
  long long* clocks;
};

__global__ void shuffles(Args a) {
  const int i = threadIdx.x, k = blockIdx.x * a.n + i;
  const float v = a.in[k];
  float r = v;
  switch (a.op) {
    case 0: r = __shfl_sync(0xffffffffu, v, a.arg, a.width); break;
    case 1: r = __shfl_up_sync(0xffffffffu, v, a.arg, a.width); break;
    case 2: r = __shfl_down_sync(0xffffffffu, v, a.arg, a.width); break;
  }
  a.out1[k] = r;
  a.out2[k] = __shfl_up_sync(0xffffffffu, r, 1);
}

// warp w runs w + 1 rounds of a max-reduction, then the warps swap their
// maxima through shared memory
__global__ void warps_apart(Args a) {
  DHTS_DYNAMIC_SMEM(smem);
  float* m = reinterpret_cast<float*>(smem);
  const int i = threadIdx.x, w = i / 32, k = blockIdx.x * a.n + i;
  const long long t0 = clock64();
  float v = a.in[k];
  __syncthreads();
  for (int round = 0; round <= w; ++round)
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncwarp();
  if (i % 32 == 0) m[w] = v;
  __syncthreads();
  a.out1[k] = m[(w + 1) % (a.n / 32)];
  a.out2[k] = __shfl_sync(0xffffffffu, v, 0);
  a.clocks[k] = clock64() - t0;
}

// n producer threads write round t's values into slot t % 2 once the
// consumer warp has read round t - 2 (EMPTY, barrier 4 + slot), sync among
// themselves (barrier 1) and hand the slot over (FULL, barrier 2 + slot);
// the consumer warp sums each round's values j and j + 32 of its lane
__global__ void ring(Args a) {
  DHTS_DYNAMIC_SMEM(smem);
  float* slot = reinterpret_cast<float*>(smem);  // [2, n]
  const int i = threadIdx.x, n = a.n, T = a.arg, all = n + 32;
  if (i >= n) {
    for (int s = 0; s < 2 && s < T; ++s) bar_arrive(4 + s, all);
    for (int t = 0; t < T; ++t) {
      bar_sync(2 + t % 2, all);
      float sum = 0.0f;
      for (int j = i - n; j < n; j += 32) sum += slot[t % 2 * n + j];
      a.out1[(blockIdx.x * T + t) * 32 + i - n] = sum;
      if (t + 2 < T) bar_arrive(4 + t % 2, all);
    }
    return;
  }
  for (int t = 0; t < T; ++t) {
    const float v = a.in[blockIdx.x * n + i] * (float)(t + 1);
    bar_sync(4 + t % 2, all);
    slot[t % 2 * n + i] = v;
    bar_sync(1, n);
    bar_arrive(2 + t % 2, all);
  }
}

// a struct of 32 bytes shuffled down by `arg` lanes in one exchange round
struct Wide {
  double a;
  int c[4];
  float d, e;
};
__global__ void wide(Args a) {
  const int i = threadIdx.x, k = blockIdx.x * a.n + i;
  const Wide w{(double)a.in[k], {k, 2 * k, 3 * k, 4 * k}, 0.5f, 0.25f};
  const Wide r = __shfl_down_sync(0xffffffffu, w, a.arg);
  a.out1[k] = (float)r.a;
  a.out2[k] = (float)(r.c[0] + r.c[3]) + r.d + r.e;
}

extern "C" int run(int kernel, const float* in, float* out1, float* out2,
                   int op, int arg, int width, int n, int blocks,
                   long long* clocks) {
  const Args a{in, out1, out2, op, arg, width, n, clocks};
  if (kernel == 0)
    dhts_emu::launch(blocks, n, 0, shuffles, a);
  else if (kernel == 1)
    dhts_emu::launch(blocks, n, 64, warps_apart, a);
  else if (kernel == 2)
    dhts_emu::launch(blocks, n + 32, 2 * n * sizeof(float), ring, a);
  else
    dhts_emu::launch(blocks, n, 0, wide, a);
  return 0;
}
"""

OPS = {"idx": 0, "up": 1, "down": 2}
N, BLOCKS = 64, 2


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    out = tmp_path_factory.mktemp("emu")
    src = out / "shuffles.cu"
    src.write_text(SOURCE)
    so = out / "libshuffles.so"
    subprocess.run([cxx, "-std=c++20", "-O2", "-DDHTS_CPU_EMULATION",
                    "-I", str(_build.CSRC), "-x", "c++", "-shared", "-fPIC",
                    "-o", str(so), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    P = ctypes.c_void_p
    lib.run.argtypes = [ctypes.c_int, P, P, P] + [ctypes.c_int] * 5 + [P]
    lib.run.restype = ctypes.c_int
    return lib


def source_lane(op, arg, width, lane):
    """CUDA's source lane of a shuffle within one warp of 32."""
    base = lane // width * width
    if op == "idx":
        return base + arg % width
    if op == "up":
        return lane - arg if lane % width >= arg else lane
    return lane + arg if lane % width + arg < width else lane


def model(v, op, arg, width):
    out = np.empty_like(v)
    for w0 in range(0, v.size, 32):
        for lane in range(32):
            out[w0 + lane] = v[w0 + source_lane(op, arg, width, lane)]
    return out


def call(lib, kernel, x, op=0, arg=0, width=32):
    out1, out2 = np.zeros_like(x), np.zeros_like(x)
    clocks = np.zeros(x.size, dtype=np.int64)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    assert lib.run(kernel, ptr(x), ptr(out1), ptr(out2), op, arg, width, N,
                   BLOCKS, ptr(clocks)) == 0
    return out1, out2, clocks


@pytest.mark.parametrize("op, arg, width", [
    ("idx", 0, 32), ("idx", 5, 32), ("idx", 31, 32), ("idx", 3, 8),
    ("idx", 11, 8), ("up", 1, 32), ("up", 3, 32), ("up", 1, 8),
    ("up", 5, 8), ("down", 1, 32), ("down", 4, 32), ("down", 1, 8),
    ("down", 6, 8), ("down", 31, 32)])
def test_shuffles_match_the_model(lib, op, arg, width):
    x = np.random.default_rng(arg + width).standard_normal(
        N * BLOCKS).astype(np.float32)
    out1, out2, _ = call(lib, 0, x, OPS[op], arg, width)
    want = np.concatenate([model(b, op, arg, width)
                           for b in x.reshape(BLOCKS, N)])
    np.testing.assert_array_equal(out1, want)
    # the second round, straight after the first: one lane up, lane 0 of
    # each warp keeps its own
    np.testing.assert_array_equal(out2, np.concatenate(
        [model(b, "up", 1, 32) for b in want.reshape(BLOCKS, N)]))


def test_warps_on_different_paths_meet_at_the_barrier(lib):
    x = np.random.default_rng(3).standard_normal(N * BLOCKS).astype(
        np.float32)
    out1, out2, clocks = call(lib, 1, x)
    warp_max = x.reshape(BLOCKS, N // 32, 32).max(-1)
    want1 = np.repeat(np.roll(warp_max, -1, axis=1), 32, axis=1)
    np.testing.assert_array_equal(out1, want1.reshape(-1))
    np.testing.assert_array_equal(out2,
                                  np.repeat(warp_max, 32, axis=1).reshape(-1))
    assert (clocks >= 0).all() and clocks.max() > 0


def test_named_barriers_hand_a_ring_over(lib):
    T = 7  # rounds, more than the ring's two slots
    x = np.random.default_rng(5).standard_normal(N * BLOCKS).astype(
        np.float32)
    out = np.full(BLOCKS * T * 32, np.nan, dtype=np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    assert lib.run(2, ptr(x), ptr(out), ptr(out), 0, T, 32, N, BLOCKS,
                   ptr(np.zeros(1, np.int64))) == 0
    v = x.reshape(BLOCKS, 1, N) * np.arange(1, T + 1, dtype=np.float32)[
        None, :, None]
    want = (np.float32(0) + v[..., :32]) + v[..., 32:]
    np.testing.assert_array_equal(out, want.reshape(-1))


@pytest.mark.parametrize("delta", [1, 4, 16])
def test_a_struct_shuffles_down_as_its_fields(lib, delta):
    x = np.random.default_rng(delta).standard_normal(N * BLOCKS).astype(
        np.float32)
    out1, out2, _ = call(lib, 3, x, 0, delta, 32)
    k = np.arange(N * BLOCKS, dtype=np.float32)
    want_x = np.concatenate([model(b, "down", delta, 32)
                             for b in x.reshape(BLOCKS, N)])
    want_k = np.concatenate([model(b, "down", delta, 32)
                             for b in k.reshape(BLOCKS, N)])
    np.testing.assert_array_equal(out1, want_x)
    np.testing.assert_array_equal(out2, 5 * want_k + np.float32(0.75))
