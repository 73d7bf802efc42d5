"""Kernel K3, the fused IDM micro rollout: its plain PyTorch pair against
the JAX package, and the CUDA source (host build) against the plain pair.

* The plain forward (``make_fused_micro_rollout`` on CPU tensors) against
  ``dhts.ops.pallas.make_fused_micro_rollout`` in interpret mode and the
  vmapped scan of ``dhts.models.lane`` at the JAX package's tolerances
  (``tests/test_pallas.py``): positions rtol 1e-5 atol 1e-4, speeds rtol
  1e-4 atol 1e-4.
* Gradients, rtol 5e-3 atol 1e-5 * max|g|. The acceleration floor: the port
  gives a speed stopped by the floor a zero gradient
  (``dhts_torch/ops/idm.py``); JAX's scan (``euler_step``) and JAX's K3
  (``vel + dt * acc`` inline, which no wrapper reaches) keep a rounding
  residue. So the port's gradients are held against ``jax.grad`` of the
  scan traced with ``dhts.ops.idm.euler_step`` wrapped to stop that
  gradient, at a draw that hits the floor and one that does not, and
  against JAX's K3 only at the draw where no vehicle reaches the floor.
  Every test prints and asserts the number of floor hits.
* ``csrc/micro_rollout.cu`` built with g++ against ``csrc/cpu_emulation.h``:
  forward bit for bit equal to the plain version, backward against
  autograd of the plain version at cosine > 0.9999 and allclose(rtol 5e-3,
  atol 1e-5 * max|g|), including touching and overlapping vehicles.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.models import lane as jlane
from dhts.models.vehicle import default_params as jdefault_params
from dhts.ops import idm as jidm
from dhts.ops.pallas import micro_rollout as jk3
from dhts_torch.models.vehicle import default_params
from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import micro_rollout as k3

torch.set_num_threads(1)

U_MAX, DT, HPD, HSD = 30.0, 0.01, 1000.0, 0.0


def euler_step_exact_floor(position, speed, acceleration, delta_time):
    """``dhts.ops.idm.euler_step`` whose new speed has a zero gradient
    where the acceleration floor ``-speed / dt`` binds."""
    new_speed = speed + delta_time * acceleration
    stopped = acceleration == (-speed) / delta_time
    return (position + delta_time * speed,
            jnp.where(stopped, jax.lax.stop_gradient(new_speed), new_speed))


def case(seed, B=2, V=6, dense=False):
    """A platoon per scenario; ``dense``: slow vehicles a few decimetres
    apart or overlapping, so the floor binds and vehicles collide."""
    rng = np.random.default_rng(seed)
    if dense:
        gap, vel = rng.uniform(4.0, 5.6, (B, V)), rng.uniform(0, 3, (B, V))
    else:
        gap, vel = rng.uniform(8.0, 20.0, (B, V)), rng.uniform(2, 20, (B, V))
    return (np.cumsum(gap, axis=1).astype(np.float32),
            vel.astype(np.float32))


def consts_for(V, T):
    return k3.micro_consts(default_params(U_MAX, (V,)), HPD, HSD, DT, T,
                           "cpu")


def hits_of(pos0, vel0, T):
    n = int(k3.floor_hits(consts_for(pos0.shape[1], T),
                          torch.as_tensor(pos0), torch.as_tensor(vel0)).sum())
    print(f"floor hits: {n}")
    return n


def port_fn(B, V, T):
    return k3.make_fused_micro_rollout(DT, T, V, B,
                                       default_params(U_MAX, (V,)), HPD, HSD,
                                       device="cpu")


def jax_fns(B, V, T):
    params = jdefault_params(U_MAX, (V,))
    fused = jk3.make_fused_micro_rollout(DT, T, V, B, params, HPD, HSD,
                                         interpret=True)

    def scan(p, v):
        def one(p, v):
            res = jlane.micro_rollout(p, v, params, jnp.ones(V, bool), HPD,
                                      HSD, DT, T)
            return res.position, res.speed

        return jax.vmap(one)(p, v)

    return fused, scan


@pytest.mark.parametrize("dense", [False, True], ids=["spaced", "dense"])
def test_plain_forward_matches_jax_kernel_and_scan(dense):
    T, (pos0, vel0) = 50, case(3, dense=dense)
    assert (hits_of(pos0, vel0, T) > 0) == dense
    pT, vT = (x.numpy() for x in port_fn(2, 6, T)(torch.as_tensor(pos0),
                                                 torch.as_tensor(vel0)))
    for fn in jax_fns(2, 6, T):
        jp, jv = fn(jnp.asarray(pos0), jnp.asarray(vel0))
        np.testing.assert_allclose(pT, np.asarray(jp), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(vT, np.asarray(jv), rtol=1e-4, atol=1e-4)


def port_grads(pos0, vel0, T):
    ins = [torch.as_tensor(a).requires_grad_(True) for a in (pos0, vel0)]
    pT, vT = port_fn(*pos0.shape, T)(*ins)
    (torch.sum(pT ** 2) * 1e-4 + torch.sum(vT ** 2) * 1e-2).backward()
    return [x.grad.numpy() for x in ins]


def jax_grad(fn, pos0, vel0):
    def loss(p, v):
        pT, vT = fn(p, v)
        return jnp.sum(pT ** 2) * 1e-4 + jnp.sum(vT ** 2) * 1e-2

    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(pos0),
                                          jnp.asarray(vel0))


@pytest.mark.parametrize("dense", [False, True], ids=["spaced", "dense"])
def test_plain_gradients_match_scan_with_exact_floor(dense):
    T, (pos0, vel0) = 50, case(4, dense=dense)
    assert (hits_of(pos0, vel0, T) > 0) == dense
    _, scan = jax_fns(2, 6, T)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jidm, "euler_step", euler_step_exact_floor)
        want = jax_grad(scan, pos0, vel0)
    for g, w in zip(port_grads(pos0, vel0, T), want):
        w = np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=5e-3,
                                   atol=1e-5 * np.abs(w).max())


def test_plain_gradients_match_jax_kernel_off_the_floor():
    T, (pos0, vel0) = 50, case(5)
    assert hits_of(pos0, vel0, T) == 0
    fused, _ = jax_fns(2, 6, T)
    for g, w in zip(port_grads(pos0, vel0, T),
                    jax_grad(fused, pos0, vel0)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=5e-3,
                                   atol=1e-5 * np.abs(w).max())


def test_wrapper_runs_plain_version_for_cpu_tensors():
    T, (pos0, vel0) = 20, case(6)
    consts = consts_for(6, T)
    ins = (torch.as_tensor(pos0), torch.as_tensor(vel0))
    counts = (k3.micro_rollout_fwd.launches, k3.micro_rollout_bwd.launches)
    for a, b in zip(k3.micro_rollout_fwd(consts, *ins),
                    k3.plain_micro_rollout(consts, *ins)):
        assert torch.equal(a, b)
    cot = (torch.ones(2, 6), torch.full((2, 6), 0.5))
    for a, b in zip(k3.micro_rollout_bwd(consts, *ins, *cot),
                    k3.plain_micro_rollout_bwd(consts, *ins, *cot)):
        assert torch.equal(a, b)
    assert (k3.micro_rollout_fwd.launches,
            k3.micro_rollout_bwd.launches) == counts


def test_factory_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        k3.make_fused_micro_rollout(DT, 10, 6, 1, default_params(U_MAX, (6,)),
                                    HPD, HSD)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    try:
        path = _build.build_cpu_emulation("micro_rollout",
                                          tmp_path_factory.mktemp("k3"))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return k3.bind(ctypes.CDLL(str(path)))


@pytest.mark.parametrize("T", [1, 60])
@pytest.mark.parametrize("dense", [False, True], ids=["spaced", "dense"])
def test_source_forward_is_bit_equal_to_plain_version(lib, dense, T):
    pos0, vel0 = case(7, B=3, V=8, dense=dense)
    if T > 1:
        assert (hits_of(pos0, vel0, T) > 0) == dense
    consts = consts_for(8, T)
    ins = (torch.as_tensor(pos0), torch.as_tensor(vel0))
    out = (torch.empty(3, 8), torch.empty(3, 8))
    assert lib.launch_micro_rollout_fwd(
        *k3.kernel_args(consts, (*ins, *out), 3, 8, 0)) == 0
    for a, b in zip(out, k3.plain_micro_rollout(consts, *ins)):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("dense", [False, True], ids=["spaced", "dense"])
def test_source_backward_matches_autograd(lib, dense):
    B, V, T = 2, 6, 40
    pos0, vel0 = case(8, B=B, V=V, dense=dense)
    assert (hits_of(pos0, vel0, T) > 0) == dense
    consts = consts_for(V, T)
    ins = (torch.as_tensor(pos0), torch.as_tensor(vel0))
    rng = np.random.default_rng(9)
    cot = [torch.as_tensor(rng.normal(size=(B, V)), dtype=torch.float32)
           for _ in range(2)]
    g_in = torch.empty(B, 2 * V)
    assert lib.launch_micro_rollout_bwd(
        *k3.kernel_args(consts, (*ins, *cot, g_in), B, V, 0)) == 0
    ref = torch.cat(k3.plain_micro_rollout_bwd(consts, *ins, *cot), 1)
    a, b = g_in.double().flatten(), ref.double().flatten()
    assert torch.isfinite(a).all() and float(a.norm()) > 0
    assert float(a @ b / (a.norm() * b.norm())) > 0.9999
    assert torch.allclose(a, b, rtol=5e-3, atol=1e-5 * float(b.abs().max()))
