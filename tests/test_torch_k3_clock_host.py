"""K3's cycle-stamped build (``-DDHTS_STEP_CLOCK``, read by
``dhts_torch.ops.cuda.k3_clock``), compiled for the host, changes nothing.

The stamped and the plain build of ``csrc/micro_rollout.cu`` are compiled
with g++ against ``csrc/cpu_emulation.h`` (where ``clock64()`` counts host
nanoseconds) and called through the launchers ``k3_clock`` calls, on a
spaced and a dense platoon (T = 60, V = 10, B = 2): every kernel's outputs
of the stamped build (PR 6's shared-memory forward and ``Dual`` backward,
the warp forward with and without the trajectory, the reverse sweep over a
saved and a replayed trajectory) equal the plain build's bit for bit, the
forwards' the plain version's too, and each kernel stamps the parts of its
steps and no others.
"""

import ctypes

import pytest
import torch

from dhts_torch.models.vehicle import default_params
from dhts_torch.ops.cuda import _build, k3_clock
from dhts_torch.ops.cuda import micro_rollout as k3

torch.set_num_threads(1)

B, V, T = 2, 10, 60


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = tmp_path_factory.mktemp("k3clock")
    try:
        plain = _build.build_cpu_emulation("micro_rollout", out)
        clocked = _build.build_cpu_emulation("micro_rollout", out,
                                             defines=("DHTS_STEP_CLOCK",))
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return (k3.bind(ctypes.CDLL(str(plain))),
            k3_clock.bind_clock(ctypes.CDLL(str(clocked))))


@pytest.mark.parametrize("dense", [False, True], ids=["spaced", "dense"])
@pytest.mark.parametrize("kernel", list(k3_clock.KERNELS))
def test_stamped_kernel_equals_unstamped(libs, kernel, dense):
    plain_lib, clocked = libs
    direction, kid, launcher, traj_used, parts = k3_clock.KERNELS[kernel]
    consts = k3.micro_consts(default_params(30.0, (V,)), 1000.0, 0.0, 0.01,
                             T, "cpu")
    pos0, vel0 = k3_clock.platoon(V, dense, 21, "cpu")
    ins = (pos0.expand(B, V).contiguous(), vel0.expand(B, V).contiguous())
    runs = []
    for stamped in (True, False):
        traj = torch.full((B, T, 2, V), float("nan")) if traj_used else None
        if direction == "fwd":
            outs = (torch.full((B, V), float("nan")),
                    torch.full((B, V), float("nan")))
            tensors = (*ins, *outs)
        else:
            outs = (torch.full((B, 2 * V), float("nan")),)
            tensors = (*ins, torch.ones(B, V), torch.full((B, V), 0.5),
                       *outs)
            if kernel == "reverse":
                k3.launch_checked(plain_lib, "launch_micro_rollout_fwd_save",
                                  consts, (*ins, torch.empty(B, V),
                                           torch.empty(B, V), traj), B, V, 0)
        cycles = torch.full((len(k3_clock.SLOTS),), -1, dtype=torch.int64)
        if stamped:
            fn = getattr(clocked, f"launch_micro_rollout_{direction}_clock")
            assert fn(*k3.kernel_args(consts, (*tensors, traj), B, V, 0), kid,
                      ctypes.c_void_p(cycles.data_ptr())) == 0
            stamps = dict(zip(k3_clock.SLOTS, cycles.tolist()))
        else:
            k3.launch_checked(plain_lib, launcher, consts,
                              (*tensors, traj) if traj_used else tensors,
                              B, V, 0)
        runs.append([x.clone() for x in outs] +
                    ([traj] if traj_used and direction == "fwd" else []))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    if direction == "fwd":
        for a, b in zip(runs[0], k3.plain_micro_rollout(consts, *ins)):
            assert torch.equal(a, b)
    assert all(torch.isfinite(x).all() for x in runs[0])
    for name, c in stamps.items():
        assert (c > 0) == (name in parts), (name, c)
