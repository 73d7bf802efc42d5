"""The port's network step and conversion against :mod:`dhts.models`.

A macro -> micro -> macro chain (the reference's hybrid scene) with dense,
fast traffic on the first lane: vehicles are emitted from its flux
capacitor, cross the micro lane and deposit their mass into the third lane.
Both sides start from the same state (built by ``dhts`` and handed across
as numpy) and step on their own. Event counts, vehicle counts, routes and
ids must match exactly at every step; float state to rtol/atol 1e-5 (the
same float32 ops, up to an ulp in sqrt).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.models import conversion as jconversion
from dhts.models import network as jnetwork
from dhts.models import scene as jscene
from dhts_torch.models import conversion, network, scene
from dhts_torch.models.vehicle import VehicleParams

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)

DT = 0.02
STEPS = 700


def to_torch(x):
    """A dhts state (nested NamedTuples of jax arrays) as the port's."""
    if isinstance(x, jnetwork.NetworkState):
        return network.NetworkState(*(to_torch(v) for v in x))
    if isinstance(x, jnetwork.MacroState):
        return network.MacroState(*(to_torch(v) for v in x))
    if isinstance(x, jnetwork.MicroState):
        return network.MicroState(*(to_torch(v) for v in x))
    if type(x).__name__ == "VehicleParams":
        return VehicleParams(*(to_torch(v) for v in x))
    return torch.as_tensor(np.array(x))


def chains():
    jb = jscene.SceneBuilder(30.0, max_vehicles_per_lane=16)
    tb = scene.SceneBuilder(30.0, max_vehicles_per_lane=16)
    for b in (jb, tb):
        l0 = b.add_macro_lane(50.0, 5.0)
        l1 = b.add_micro_lane(50.0)
        l2 = b.add_macro_lane(50.0, 5.0)
        b.connect(l0, l1)
        b.connect(l1, l2)
    jspec, jstate = jb.build(np.random.default_rng(0))
    tspec, _ = tb.build(np.random.default_rng(0))
    mnext, mprev = jb.random_macro_route(np.random.default_rng(0))
    jstate = jstate._replace(macro_next=jnp.asarray(mnext),
                             macro_prev=jnp.asarray(mprev))
    jstate = jnetwork.set_macro_lane_state(
        jstate, 0, jnp.full(10, 0.7), jnp.full(10, 15.0), jspec)
    jstate = jnetwork.set_external_boundary(jstate, 0, left_r=0.7,
                                            left_u=15.0)
    return jspec, jstate, tspec


def assert_state_close(ts, js, step):
    np.testing.assert_array_equal(ts.micro.count.numpy(),
                                  np.asarray(js.micro.count), f"count@{step}")
    act = ts.micro.active.numpy()
    np.testing.assert_array_equal(ts.micro.vid.numpy() * act,
                                  np.asarray(js.micro.vid) * act)
    np.testing.assert_array_equal(
        ts.micro.route.numpy() * act[..., None],
        np.asarray(js.micro.route) * act[..., None])
    np.testing.assert_array_equal(ts.micro.route_idx.numpy() * act,
                                  np.asarray(js.micro.route_idx) * act)
    for name in ("r", "y", "flux_capacitor"):
        np.testing.assert_allclose(getattr(ts.macro, name).numpy(),
                                   np.asarray(getattr(js.macro, name)),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name}@{step}")
    for name in ("position", "speed"):
        np.testing.assert_allclose(getattr(ts.micro, name).numpy() * act,
                                   np.asarray(getattr(js.micro, name)) * act,
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{name}@{step}")
    np.testing.assert_allclose(ts.micro.params.a.numpy() * act,
                               np.asarray(js.micro.params.a) * act,
                               rtol=1e-5, atol=1e-5)


def test_scene_builder_matches_dhts():
    jspec, jstate, tspec = chains()
    for name in ("is_macro", "length", "num_cell", "cell_length", "cell_mask",
                 "next_lanes", "prev_lanes", "num_next", "num_prev"):
        np.testing.assert_array_equal(getattr(tspec, name).numpy(),
                                      np.asarray(getattr(jspec, name)), name)
    pool_j = jscene.SceneBuilder(30.0)
    pool_t = scene.SceneBuilder(30.0)
    for b in (pool_j, pool_t):
        ids = [b.add_micro_lane(10.0) for _ in range(5)]
        for a, c in [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4), (4, 0)]:
            b.connect(ids[a], ids[c])
    np.testing.assert_array_equal(
        pool_t.build_route_pool(np.random.default_rng(7)).numpy(),
        np.asarray(pool_j.build_route_pool(np.random.default_rng(7))))


@pytest.mark.parametrize("differentiable", [False, True])
def test_network_step_matches_dhts_on_hybrid_chain(differentiable):
    jspec, jstate, tspec = chains()
    tstate = to_torch(jstate)
    jstep = jax.jit(lambda s: jnetwork.network_step(jspec, s, DT,
                                                    differentiable))
    totals = np.zeros(2, int)
    for step in range(STEPS):
        jstate, jd = jstep(jstate)
        tstate, td = network.network_step(tspec, tstate, DT, differentiable)
        ev_j = (int(jd.emitted), int(jd.absorbed), int(jd.num_collisions))
        ev_t = (int(td.emitted), int(td.absorbed), int(td.num_collisions))
        assert ev_t == ev_j, (step, ev_t, ev_j)
        totals += ev_t[:2]
        np.testing.assert_allclose(td.max_wave_speed.numpy(),
                                   np.asarray(jd.max_wave_speed), rtol=1e-5,
                                   atol=1e-4)
        if step % 50 == 49:
            assert_state_close(tstate, jstate, step)
    assert_state_close(tstate, jstate, STEPS)
    # not vacuous: the chain emitted and absorbed vehicles
    assert totals[0] >= 2 and totals[1] >= 1, totals


def test_conversion_apply_matches_dhts():
    """The conversion pass alone, from the same post-lane-step state at
    every step of the chain's rollout (emissions, transits, deposits)."""
    jspec, jstate, tspec = chains()

    def lanes(s):
        s, bv = jnetwork.default_boundary(jspec, s, False)
        return jnetwork.lanes_forward(jspec, s, bv, DT)[0]

    jlanes = jax.jit(lanes)
    japply = jax.jit(lambda s: jconversion.apply(jspec, s, DT))
    seen = np.zeros(2, int)
    for step in range(STEPS):
        mid = jlanes(jstate)
        jstate, je, ja = japply(mid)
        tout, te, ta = conversion.apply(tspec, to_torch(mid), DT)
        assert (int(te), int(ta)) == (int(je), int(ja)), step
        seen += (int(te), int(ta))
        if int(je) or int(ja) or step % 100 == 0:
            assert_state_close(tout, jstate, step)
    assert seen[0] >= 2 and seen[1] >= 1, seen


def test_micro_lane_macro_state_matches_dhts():
    jspec, jstate, tspec = chains()
    jstep = jax.jit(lambda s: jnetwork.network_step(jspec, s, DT, False))
    for _ in range(400):
        jstate, _ = jstep(jstate)
    assert int(jstate.micro.count[1]) > 0
    for diff in (False, True):
        jd, js = jnetwork.micro_lane_macro_state(jspec, jstate, diff)
        td, ts = network.micro_lane_macro_state(tspec, to_torch(jstate), diff)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-5)


def test_tail_insert_rows_matches_dhts():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 5, 3)).astype(np.float32)
    new = rng.normal(size=(6, 3)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 0], bool)
    ref = jnetwork.tail_insert_rows(jnp.asarray(x), jnp.asarray(new),
                                    jnp.asarray(mask))
    got = network.tail_insert_rows(torch.as_tensor(x), torch.as_tensor(new),
                                   torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
