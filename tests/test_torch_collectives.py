"""The lane collectives (``dhts_torch.parallel.collectives``) across S gloo
ranks on the CPU, joined by a ``FileStore`` (no ports;
``dhts_torch.parallel.local_ranks``).

* ``all_gather_lanes`` joins every rank's block of each tensor on the last
  axis in rank order, for tensors of 4- and 8-byte types and of odd sizes
  in one call, as ``jnp.concatenate`` of the blocks would;
* ``psum`` and ``pmax`` reduce elementwise;
* every call counts once under its kind;
* a rank that raises fails the run, naming the rank;
* kept ranks (``LocalRanks``) serve one call after another in the same
  processes until closed.
"""

import numpy as np
import pytest
import torch

from dhts_torch.parallel.local_ranks import LocalRanks, run_local


def blocks(rank):
    """Rank ``rank``'s blocks: float32 [2, 3], int32 [3], float64 [1, 3]."""
    rng = np.random.default_rng(rank)
    return [torch.as_tensor(rng.standard_normal((2, 3)), dtype=torch.float32),
            torch.as_tensor(rng.integers(-9, 9, 3), dtype=torch.int32),
            torch.as_tensor(rng.standard_normal((1, 3)), dtype=torch.float64)]


def _rank(rank, S):
    import torch.distributed as dist

    from dhts_torch.parallel import collectives

    before = dict(collectives.counts)
    before_s = dict(collectives.seconds)
    group = dist.new_group(list(range(S)))
    # (clones: the joined tensors are views of one received buffer)
    joined = [x.clone() for x in collectives.all_gather_lanes(blocks(rank),
                                                              group)]
    (single,) = collectives.all_gather_lanes([blocks(rank)[1]], group, "psum")
    x = torch.tensor([rank, -rank, 2 * rank], dtype=torch.int32)
    counts = {k: collectives.counts[k] - before[k] for k in before}
    timed = {k: collectives.seconds[k] > before_s[k] for k in before_s}
    return dict(joined=joined, single=single,
                sum=collectives.psum(x, group), max=collectives.pmax(x, group),
                counts=counts, timed=timed)


@pytest.mark.parametrize("S", [2, 4])
def test_lane_collectives_join_in_rank_order_and_reduce(S):
    outs = run_local(_rank, S, timeout=120)
    want = [torch.cat(parts, -1) for parts in zip(*(blocks(r)
                                                    for r in range(S)))]
    xs = torch.tensor([[r, -r, 2 * r] for r in range(S)], dtype=torch.int32)
    for o in outs:
        for got, ref in zip(o["joined"], want):
            assert got.dtype == ref.dtype and torch.equal(got, ref)
        assert torch.equal(o["single"], want[1])
        assert torch.equal(o["sum"], xs.sum(0).to(torch.int32))
        assert torch.equal(o["max"], xs.amax(0))
        assert o["counts"] == {"all_gather": 1, "psum": 1, "pmax": 0}
        assert o["timed"] == {"all_gather": True, "psum": True,
                              "pmax": False}


def _failing_rank(rank, S):
    if rank == 1:
        raise ValueError("rank 1 stops here")
    return rank


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 stops here"):
        run_local(_failing_rank, 2, timeout=60)


def _count_gathers(rank, S):
    import torch.distributed as dist

    from dhts_torch.parallel import collectives

    x = torch.tensor([rank], dtype=torch.int32)
    (got,) = collectives.all_gather_lanes([x], dist.group.WORLD)
    return got, collectives.counts["all_gather"]


def test_kept_ranks_run_one_call_after_another():
    """The same processes serve every call until closed: a counter of the
    rank's process keeps rising from call to call, whether the caller
    waits (``run``) or collects a submitted call later."""
    with LocalRanks(2, timeout=120) as ranks:
        first = ranks.run(_count_gathers)
        submitted = ranks.submit(_count_gathers)
        second = ranks.result(submitted)
    for (got1, n1), (got2, n2) in zip(first, second):
        assert torch.equal(got1, torch.tensor([0, 1], dtype=torch.int32))
        assert torch.equal(got2, got1) and n2 == n1 + 1
    with pytest.raises(RuntimeError, match="closed"):
        ranks.run(_count_gathers)
