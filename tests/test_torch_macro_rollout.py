"""Kernel K2, the fused ARZ macro rollout: its plain PyTorch pair against
the JAX package, and the CUDA source (host build) against the plain pair.

* The plain forward and backward (``make_fused_macro_rollout`` on CPU
  tensors: :class:`MacroRolloutFunction` around ``plain_macro_rollout`` and
  its autograd) against ``dhts.ops.pallas.make_fused_macro_rollout`` in
  interpret mode and against the vmapped scan of ``dhts.models.lane``, at
  the JAX package's own tolerances (``tests/test_pallas.py``): rT rtol/atol
  2e-5, yT rtol 2e-4 atol 2e-3, gradients rtol 5e-3 atol 5e-4.
* ``csrc/macro_rollout.cu`` built with g++ against ``csrc/cpu_emulation.h``
  and called through the same C launchers as on the card: forward bit for
  bit equal to the plain version (the same float32 operations in the same
  order), backward (forward-mode tangents) against autograd of the plain
  version at cosine > 0.9999 and allclose(rtol 5e-3, atol 5e-4 * max|g|),
  on random states and on vacuum/jam probes.
* The segmented rollout equals one fused call bit for bit.

JAX's kernel rounds ``dt / dx`` in double, the port in float32; the plain
version is the kernel's specification, so the kernel follows it, and both
lie within the JAX tolerances.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.models import lane as jlane
from dhts.ops import arz as jarz
from dhts.ops.pallas import macro_rollout as jk2
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import macro_rollout as k2

torch.set_num_threads(1)

U_MAX, DT, DX = 30.0, 0.01, 5.0


def case(seed, B=3, C=10, probe=False):
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(0.1, 0.9, (B, C)).astype(np.float32)
    u0 = rng.uniform(2.0, 25.0, (B, C)).astype(np.float32)
    g = [rng.uniform(0.1, 0.9, B), rng.uniform(2.0, 25.0, B),
         rng.uniform(0.1, 0.9, B), rng.uniform(2.0, 25.0, B)]
    if probe:
        r0[:, 1:3], u0[:, 1:3] = 0.0, 0.0  # vacuum
        r0[:, 5:7], u0[:, 5:7] = 1.0, 0.0  # jam
        g[0][:], g[1][:] = 0.0, 0.0
        g[2][:], g[3][:] = 1.0, 0.0
    y0 = np.array(jarz.compute_y(jnp.asarray(r0), jnp.asarray(u0), U_MAX))
    return (r0, y0, *(x.astype(np.float32) for x in g))


def port_inputs(args):
    return [torch.as_tensor(a) for a in args]


def scan_rollout(args, T):
    def one(r, y, blr, blu, brr, bru):
        res = jlane.macro_rollout(r, jarz.compute_u(r, y, U_MAX), blr, blu,
                                  brr, bru, U_MAX, DT, DX, T)
        return res.r, res.y, res.max_wave_speed

    return jax.vmap(one)(*map(jnp.asarray, args))


def loss_weights(B, C):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(B, C)).astype(np.float32),
            rng.normal(size=(B, C)).astype(np.float32))


def test_plain_forward_matches_jax_kernel_and_scan():
    T, args = 60, case(0)
    fn = k2.make_fused_macro_rollout(U_MAX, DT, DX, T, 10, 3, device="cpu")
    rT, yT, wave = (x.numpy() for x in fn(*port_inputs(args)))
    jfn = jk2.make_fused_macro_rollout(U_MAX, DT, DX, T, num_cell=10,
                                       batch=3, interpret=True)
    for ref in (jfn(*map(jnp.asarray, args)), scan_rollout(args, T)):
        np.testing.assert_allclose(rT, np.asarray(ref[0]), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(yT, np.asarray(ref[1]), rtol=2e-4,
                                   atol=2e-3)
    np.testing.assert_allclose(wave, np.asarray(scan_rollout(args, T)[2]),
                               rtol=1e-5)
    assert np.all(wave * DT < DX)


def test_plain_gradients_match_jax_kernel_and_scan():
    T, args = 40, case(1)
    wr, wy = loss_weights(3, 10)
    jfn = jk2.make_fused_macro_rollout(U_MAX, DT, DX, T, num_cell=10,
                                       batch=3, interpret=True)

    def jloss_fused(*a):
        rT, yT, _ = jfn(*a)
        return jnp.sum(rT * wr) + jnp.sum(yT * wy)

    def jloss_scan(*a):
        rT, yT, _ = scan_rollout(a, T)
        return jnp.sum(rT * wr) + jnp.sum(yT * wy)

    ins = [x.requires_grad_(True) for x in port_inputs(args)]
    fn = k2.make_fused_macro_rollout(U_MAX, DT, DX, T, 10, 3, device="cpu")
    rT, yT, _ = fn(*ins)
    (torch.sum(rT * torch.as_tensor(wr)) +
     torch.sum(yT * torch.as_tensor(wy))).backward()
    for jloss in (jloss_fused, jloss_scan):
        want = jax.grad(jloss, argnums=tuple(range(6)))(
            *map(jnp.asarray, args))
        for x, w in zip(ins, want):
            g, w = x.grad.numpy(), np.asarray(w)
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=5e-3, atol=5e-4)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    T, args = 20, case(2)
    consts = k2.MacroConsts(U_MAX, DT, DX, T)
    ins = port_inputs(args)
    counts = (k2.macro_rollout_fwd.launches, k2.macro_rollout_bwd.launches)
    out = k2.macro_rollout_fwd(consts, *ins)
    for a, b in zip(out, k2.plain_macro_rollout(consts, *ins)):
        assert torch.equal(a, b)
    cot = [torch.as_tensor(w) for w in loss_weights(3, 10)]
    got = k2.macro_rollout_bwd(consts, *ins, *cot)
    for a, b in zip(got, k2.plain_macro_rollout_bwd(consts, *ins, *cot)):
        assert torch.equal(a, b)
    assert (k2.macro_rollout_fwd.launches,
            k2.macro_rollout_bwd.launches) == counts


def test_segmented_rollout_equals_one_call():
    T, args = 130, case(7)  # 2 chunks of 50 and a remainder of 30
    one = k2.make_fused_macro_rollout(U_MAX, DT, DX, T, 10, 3, device="cpu")
    seg = k2.make_segmented_macro_rollout(U_MAX, DT, DX, T, 10, 3, chunk=50,
                                          device="cpu")
    outs, grads = [], []
    for fn in (one, seg):
        ins = [x.requires_grad_(True) for x in port_inputs(args)]
        rT, yT, wave = fn(*ins)
        (rT.sum() + 1e-3 * yT.sum()).backward()
        outs.append((rT, yT, wave))
        grads.append([x.grad for x in ins])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_factory_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k2.make_fused_macro_rollout(U_MAX, DT, DX, 10, 10, 1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation("macro_rollout",
                                          tmp_path_factory.mktemp("k2"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k2.bind(ctypes.CDLL(str(path)))


def forward_case(lib, C, probe, T):
    args = case(3, B=4, C=C, probe=probe)
    consts = k2.MacroConsts(U_MAX, DT, DX, T)
    ins = port_inputs(args)
    out = (torch.empty(4, C), torch.empty(4, C), torch.empty(4))
    assert lib.launch_macro_rollout_fwd(
        *k2.kernel_args(consts, (*ins, *out), 4, C, 0)) == 0
    for a, b in zip(out, k2.plain_macro_rollout(consts, *ins)):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("T", [1, 40])
@pytest.mark.parametrize("probe", [False, True], ids=["random", "vac_jam"])
def test_source_forward_is_bit_equal_to_plain_version(lib, probe, T):
    forward_case(lib, 10, probe, T)  # the warp kernel


@pytest.mark.parametrize("T", [1, 40])
@pytest.mark.parametrize("probe", [False, True], ids=["random", "vac_jam"])
def test_source_forward_above_one_warp_is_bit_equal(lib, probe, T):
    forward_case(lib, 40, probe, T)  # the shared-memory kernel


def backward_case(lib, C, probe):
    B, T = 2, 30
    args = case(4, B=B, C=C, probe=probe)
    consts = k2.MacroConsts(U_MAX, DT, DX, T)
    ins = port_inputs(args)
    rng = np.random.default_rng(5)
    cot = [torch.as_tensor(rng.normal(size=(B, C)), dtype=torch.float32)
           for _ in range(2)]
    g_in = torch.empty(B, 2 * C + 4)
    assert lib.launch_macro_rollout_bwd(
        *k2.kernel_args(consts, (*ins, *cot, g_in), B, C, 0)) == 0
    got = g_in.double()
    ref = k2.plain_macro_rollout_bwd(consts, *ins, *cot)
    ref = torch.cat([ref[0], ref[1], torch.stack(ref[2:], 1)], 1).double()
    assert torch.isfinite(got).all() and float(got.norm()) > 0
    a, b = got.flatten(), ref.flatten()
    assert float(a @ b / (a.norm() * b.norm())) > 0.9999
    assert torch.allclose(a, b, rtol=5e-3, atol=5e-4 * float(b.abs().max()))
    assert float(got[:, 2 * C + 2].abs().max()) == 0.0  # d/d br_r


@pytest.mark.parametrize("probe", [False, True], ids=["random", "vac_jam"])
def test_source_backward_matches_autograd(lib, probe):
    backward_case(lib, 6, probe)


@pytest.mark.parametrize("C", [10, 40], ids=["warp", "above_one_warp"])
@pytest.mark.parametrize("probe", [False, True], ids=["random", "vac_jam"])
def test_source_backward_matches_autograd_at_both_kernels(lib, probe, C):
    backward_case(lib, C, probe)


def test_source_rejects_bad_sizes(lib):
    consts = k2.MacroConsts(U_MAX, DT, DX, 5)
    ins = port_inputs(case(0, B=1, C=2))
    out = (torch.empty(1, 2), torch.empty(1, 2), torch.empty(1))
    fwd = list(k2.kernel_args(consts, (*ins, *out), 1, 2, 0))
    bwd = list(k2.kernel_args(consts, (*ins, *out[:2], torch.empty(1, 8)),
                              1, 2, 0))
    for C in (0, 1024):  # no cell; more than a block's threads
        fwd[11] = bwd[11] = C
        assert lib.launch_macro_rollout_fwd(*fwd) == 1
        assert lib.launch_macro_rollout_bwd(*bwd) == 1


@pytest.mark.parametrize("C", [1, 31, 32])
def test_source_lanes_at_the_warp_edge(lib, C):
    """One cell, a full warp of interfaces (C = 31: the right ghost at lane
    31) and the first lane of the shared-memory kernel (C = 32)."""
    forward_case(lib, C, False, 25)


@pytest.mark.parametrize("warp", [1, 0], ids=["warp", "smem"])
def test_clocked_source_matches_and_stamps_every_part(tmp_path, warp):
    """The instrumented build (``-DDHTS_STEP_CLOCK``) through its launcher
    as ``python -m dhts_torch.ops.cuda.step_clock`` calls it: each kernel's
    outputs bit-equal to the plain version, four non-negative part counts
    (host nanoseconds here, cycles on the card)."""
    try:
        path = _build.build_cpu_emulation("macro_rollout", tmp_path,
                                          defines=("DHTS_STEP_CLOCK",))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    lib = k2.bind(ctypes.CDLL(str(path)))
    fn = lib.launch_macro_rollout_fwd_clock
    fn.argtypes = list(k2._ARGTYPES) + [ctypes.c_int, ctypes.c_void_p]
    consts = k2.MacroConsts(U_MAX, DT, DX, 20)
    ins = port_inputs(case(6, B=2, C=10))
    out = (torch.empty(2, 10), torch.empty(2, 10), torch.empty(2))
    cycles = torch.full((4,), -1, dtype=torch.int64)
    assert fn(*k2.kernel_args(consts, (*ins, *out), 2, 10, 0), warp,
              ctypes.c_void_p(cycles.data_ptr())) == 0
    for a, b in zip(out, k2.plain_macro_rollout(consts, *ins)):
        assert torch.equal(a, b)
    assert (cycles >= 0).all() and int(cycles.sum()) > 0
    # the warp kernel takes at most 31 cells
    assert fn(*k2.kernel_args(consts, (*ins, *out), 2, 32, 0), 1,
              ctypes.c_void_p(cycles.data_ptr())) == 1
