"""K1's backward in straight-through (``st``) mode, compiled for the host,
against autograd of the plain version over fourteen action draws and at a
constant action on the signal-progress grid.

Scene: the two-phase 3x3 hybrid config of
``test_torch_itscp_hybrid_episode_bwd.py`` (T = 160, emissions), the same
random per-step loss weights. Tolerance as there: cosine > 0.999 and
``allclose(rtol=2e-2, atol=2e-3 * max|g|)``, finite and nonzero. The draws
are ``default_rng(0)`` to ``default_rng(13)`` of actions in [0.3, 0.7];
every one is asserted. On the grid (actions 0.45 and 0.5, progress 36 / 80
and 40 / 80) both hard gates of an intersection are red at the tied step,
and the straight-through gradient passes through the soft gates' ties.
"""

import numpy as np
import pytest
import torch

from dhts_torch.ops.cuda import itscp_hybrid_episode as k1
from tests.test_torch_itscp_hybrid_episode_bwd import TWO_PHASE_CFG, case
from tests.test_torch_itscp_hybrid_episode_bwd import lib  # noqa: F401

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)


def check_backward(lib, plan, inputs):
    w = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, plan.T),
                        dtype=torch.float32)
    ref = k1.plain_episode_bwd(plan, w, *inputs).numpy().ravel()
    grad = torch.zeros(plan.n_phases, plan.n_inter)
    assert lib.launch_itscp_hybrid_episode_bwd(
        *k1.kernel_args(plan, inputs, (w, grad), 0)) == 0
    got = grad.numpy().ravel()
    assert np.all(np.isfinite(got)) and np.linalg.norm(got) > 0
    cos = float(got @ ref / (np.linalg.norm(got) * np.linalg.norm(ref)))
    assert cos > 0.999, (cos, got, ref)
    np.testing.assert_allclose(got, ref, rtol=2e-2,
                               atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("seed", range(14))
def test_st_backward_source_matches_autograd_over_draws(lib, seed):
    plan, inputs = case(TWO_PHASE_CFG, "st", seed)
    check_backward(lib, plan, inputs)


@pytest.mark.parametrize("a", [0.45, 0.5])
def test_st_backward_source_matches_autograd_on_the_progress_grid(lib, a):
    plan, inputs = case(TWO_PHASE_CFG, "st")
    action = torch.full_like(inputs[0], a)
    assert bool((plan.prog == action[0, 0]).any())  # a grid point
    check_backward(lib, plan, (action, *inputs[1:]))
