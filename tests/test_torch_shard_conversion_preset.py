"""The fused conversion's plain step against the seven-body composition
(``tests/test_torch_shard_conversion.py``) at the 3x3 hybrid preset of
``run_itscp_hybrid.sh`` (144 lanes, 30 Hz), steps 140-172 from the plain
single-shard state at 140: emissions, transfers and deposits; S = 2 and
4 local shards, hard and soft, B = 1 and 4.
"""

import pytest
import torch

from tests.test_torch_shard_conversion import check_lockstep

torch.set_num_threads(1)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("mode", ["hard", "soft"])
@pytest.mark.parametrize("S", [2, 4])
def test_fused_conversion_equals_seven_bodies_at_preset(S, mode, B):
    check_lockstep("preset", S, mode, B)
