"""The port's copy of CMA-ES (:mod:`dhts_torch.utils.cma_es`) against
:class:`dhts.utils.cma_es.CmaEs`: the same seed and objective give the same
ask/tell sequence, bit for bit (both are NumPy in float64)."""

import numpy as np
import pytest

from dhts.utils.cma_es import CmaEs as JaxCmaEs
from dhts_torch.utils.cma_es import CmaEs


def objective(xs):
    """A shifted quadratic with a mild coupling, optimum inside the box."""
    xs = np.asarray(xs, np.float64)
    c = np.linspace(0.2, 0.8, xs.shape[1])
    return np.sum((xs - c) ** 2, axis=1) + 0.1 * xs[:, 0] * xs[:, -1]


@pytest.mark.parametrize("n,seed", [(4, 1), (20, 3)])
def test_ask_tell_sequence_is_identical(n, seed):
    lo, hi = np.zeros(n), np.ones(n)
    a = CmaEs(np.full(n, 0.5), 0.3, lower=lo, upper=hi, seed=seed)
    b = JaxCmaEs(np.full(n, 0.5), 0.3, lower=lo, upper=hi, seed=seed)
    assert a.popsize == b.popsize == 4 + int(3 * np.log(n))
    for _ in range(6):
        xa, xb = a.ask(), b.ask()
        np.testing.assert_array_equal(xa, xb)
        fa = objective(a.repair(xa))
        pen = a.boundary_penalty(xa, a.repair(xa), fa)
        np.testing.assert_array_equal(
            pen, b.boundary_penalty(xb, b.repair(xb), objective(b.repair(xb))))
        a.tell(xa, fa + pen)
        b.tell(xb, fa + pen)
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.C, b.C)
        assert a.sigma == b.sigma


@pytest.mark.parametrize("bounded", [False, True])
def test_optimize_is_identical(bounded):
    n = 6
    kw = dict(lower=np.zeros(n), upper=np.ones(n)) if bounded else {}
    runs = [cls(np.full(n, 0.9), 0.5, seed=7, **kw).optimize(objective, 40)
            for cls in (CmaEs, JaxCmaEs)]
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    history, asked, best = runs[0]
    assert len(history) == len(asked) == 40
    assert history.min() < history[0]
    if bounded:
        assert np.all((asked >= 0) & (asked <= 1))
