"""The port's MLP controller against :mod:`dhts.apps.control.controller`.

Weights carried across with ``params_from_flax`` must reproduce
``Controller.apply`` to 1e-6 (float32 matmuls of width 256; TF32 off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dhts.apps.control import controller as jcontroller
from dhts_torch.apps.control import controller

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)


@pytest.mark.parametrize("network_size", [(256, 256), (32,), ()])
def test_params_from_flax_reproduces_flax_controller(network_size):
    obs_size, out_size = 1440, 45
    model, params = jcontroller.init_controller(
        jax.random.PRNGKey(0), obs_size, out_size, network_size)
    obs = np.random.default_rng(0).uniform(0, 1, (4, obs_size)).astype(
        np.float32)
    ref = np.asarray(jax.vmap(lambda o: model.apply(params, o))(
        jnp.asarray(obs)))
    np_params = jax.tree.map(np.asarray, params)
    port = controller.Controller(obs_size, out_size, network_size)
    port.load_state_dict(controller.params_from_flax(np_params))
    with torch.no_grad():
        got = port(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)

    low, high = 0.1, 0.9
    ref_a = np.asarray(jcontroller.squash_action(jnp.asarray(ref), low, high))
    got_a = controller.squash_action(torch.as_tensor(got), low, high).numpy()
    np.testing.assert_allclose(got_a, ref_a, rtol=1e-6, atol=1e-6)


def test_init_controller_is_seeded_and_shaped():
    a = controller.init_controller(torch.Generator().manual_seed(3), 20, 6,
                                   device="cpu")
    b = controller.init_controller(torch.Generator().manual_seed(3), 20, 6,
                                   device="cpu")
    for (na, pa), (nb, pb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(pa, pb)
    assert a.hidden[0].weight.shape == (256, 20)
    assert a.head.weight.shape == (6, 256)
    assert float(a.head.bias.detach().abs().max()) == 0.0
    # flax lecun_normal: std 1/sqrt(fan_in), truncated at two std
    w = a.hidden[1].weight.detach()
    assert float(w.abs().max()) <= 2.0 / 256 ** 0.5 / 0.87962566 + 1e-6
    assert abs(float(w.std()) - 1.0 / 256 ** 0.5) < 0.1 / 256 ** 0.5


def test_init_controller_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        controller.init_controller(torch.Generator().manual_seed(0), 4, 2)
