"""The next step's A rows written by the lane-sharded step's D3 launch,
compiled for the host, against ``plain_body_A`` on ``plain_body_D``'s
carry with the next step's draws and schedule.

``csrc/itscp_spatial_shard.cu`` is built with g++ against
``csrc/cpu_emulation.h`` and driven through the card's launcher, S = 2 and
4 shards in one process. After C's launch and the gathers after it, a case
rewrites the carry (and, for the conversion's cases, the gathered
post-physics rows) so that the lanes D3 converts, and then summarises for
the next step, meet the situation the case names; D3's launch is then held
against its plain version on the same state (``ShardRun.checked_step``:
the carry, the static terms, the counts and the next step's A rows
bit-equal; the derivative's ``Dual`` launch by ``checked_dual_step``:
values equal, tangents within rtol 1e-5, atol 1e-5 times the largest):

* a head that leaves the network (every fourth lane, no next lane: the
  lane's count and tail after the removal);
* an emission into an empty micro lane (its one vehicle is the tail the
  next step's rows read);
* the injection bit's edges at the boundary micro lanes: a lane full
  (``count == V``), a lane whose waiting pool is empty (``inj_left ==
  0``), a lane whose next draw equals its schedule (``draw < incoming``
  fails), each of them 0, while the other boundary lanes draw 0 and some
  of them inject;
* a NaN carried speed (a micro lane's tail) and a NaN macro cell (its
  first cell's ``y``): NaN in the rows where the plain version has NaN
  (every clamp keeps a NaN), the rest bit-equal.

And: at the last step D3 leaves the A rows as they were (no next step);
with one local shard and no process group the gathered A rows B reads are
D3's own buffer, which D3 rewrites after B read it (stream order), and
the episode stays bit-equal to the plain one, A launched once.

The micro scene at step 20 (heads on every lane) and the hybrid scene at
step 116 (the plain state there), B = 2.
"""

import ctypes

import pytest
import torch
import torch.autograd.forward_ad as fwad

from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from tests.test_torch_card_nan_gate import same
from tests.test_torch_shard_bd3_host import shard_run
from tests.test_torch_shard_conversion_host import (MICRO_STEP, Rows,
                                                     case_no_next, preds)

torch.set_num_threads(1)

B = 2
NAN = float("nan")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("next_a")
    try:
        path = _build.build_cpu_emulation("itscp_spatial_shard", out)
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return ks.bind(ctypes.CDLL(str(path)))


def carry_of(run, lane):
    """The carry views of the shard that holds ``lane`` and its local
    index."""
    s, p_n, b, j = Rows(run).shard(lane)
    return k6.unpack(p_n, b["fbuf"], b["ibuf"])[0], j


def boundary_micro(run):
    """The micro lanes without a previous lane (the injection lanes)."""
    g = run.geom
    return [int(x) for x in torch.nonzero(~g.has_prev & ~g.is_macro)]


def next_rows(run):
    """The A rows every shard's D3 wrote, over the lane axis."""
    return torch.cat([b["sumA_v"] for _, _, b, _ in run.shards], -1)


def craft_exit(run):
    r = Rows(run)
    case_no_next(r)
    r.sync_cap()
    return lambda rows: None


def craft_emit_empty(run):
    """A macro lane p emits into a micro lane Z emptied here: Z's count 0
    in the carry and the gathered rows, no other predecessor's head
    wanting into Z."""
    r, g = Rows(run), run.geom
    veh_len = run.plan.floats[2]
    Z = next(z for z in range(run.plan.L) if not bool(g.is_macro[z]) and
             any(bool(g.is_macro[p]) for p in preds(g, z)))
    p = next(q for q in preds(g, Z) if bool(g.is_macro[q]))
    carry, j = carry_of(run, Z)
    carry[11][:, j] = 0
    r.F[:, ks.F_COUNT, Z] = 0.0
    for q in preds(g, Z):
        r.I[:, ks.I_HNEXT, q] = -2  # no route lane: wants nothing
    r.I[:, ks.I_MN, p] = Z
    r.set_cap(p, Z, 2.0 * veh_len)
    r.sync_cap()
    _, gV = ks.plain_arbitration(run.plan, g, r.F, r.I)
    assert bool((gV[:, 0, Z] == p).all())

    def check(rows):
        assert bool((rows[:, 4, Z] == 1.0).all())  # the emitted vehicle
        assert bool((rows[:, 5, Z] == 0.0).all())  # at the lane's start

    return check


def craft_injection_edges(run, t):
    """Boundary micro lanes: one full, one with no vehicle left to inject,
    one whose next draw equals its schedule; the others draw 0."""
    lanes = boundary_micro(run)
    assert len(lanes) >= 4, lanes
    full, empty_pool, tie, *others = lanes
    rand, sched = run.inputs[1], run.inputs[2]
    carry, j = carry_of(run, full)
    carry[11][:, j] = run.plan.V
    carry, j = carry_of(run, empty_pool)
    carry[15][:, j] = 0
    rand[:, t + 1, tie] = sched[t + 1, tie]
    rand[:, t + 1, others] = 0.0

    def check(rows):
        for lane in (full, empty_pool, tie):
            assert bool((rows[:, 8, lane] == 0.0).all()), lane
        assert float(rows[:, 8, others].sum()) > 0

    return check


CASES = {"exit": ("micro", lambda run, t: craft_exit(run)),
         "emit_empty": ("hybrid", lambda run, t: craft_emit_empty(run)),
         "injection_edges": ("micro", craft_injection_edges)}


def start(lib, scene, S, kind):
    """A run of ``scene`` stepped to its checked step t (the last but
    one); returns the run and t."""
    t = MICRO_STEP if scene == "micro" else None
    run, t0 = shard_run(lib, scene, S, kind != "hard", B, dual=kind == "dual",
                        steps=(t + 2 if t is not None else 2),
                        own_inputs=True)
    t = run.plan.T - 2
    for s in range(t0, t):
        run.step(s)
    return run, t


@pytest.mark.parametrize("kind", ["hard", "soft", "dual"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_next_rows_match_plain_on_crafted_lanes(lib, name, S, kind):
    scene, craft = CASES[name]
    run, t = start(lib, scene, S, kind)
    checks = []

    def edit(run, body):
        if body == "C":
            checks.append(craft(run, t))

    if kind == "dual":
        errs = run.checked_dual_step(t, ("D3",), edit=edit)
        assert "D3" in errs
    else:
        run.checked_step(t, edit=edit)
    assert run.t_next == t + 1 and len(checks) == 1
    checks[0](next_rows(run))


def nan_lanes(run):
    """NaN in the carry after C: a micro lane's tail speed (the lane given
    a vehicle where it has none) and a macro lane's first cell's y
    (episode 0's); returns the two lanes."""
    g = run.geom
    micro = next(lane for lane in range(run.plan.L)
                 if not bool(g.is_macro[lane]))
    macro = next(lane for lane in range(run.plan.L)
                 if bool(g.is_macro[lane]))
    carry, j = carry_of(run, micro)
    carry[11][0, j].clamp_(min=1)
    carry[3][0, 0, j] = NAN
    carry, j = carry_of(run, macro)
    carry[1][0, 0, j] = NAN
    return micro, macro


@pytest.mark.parametrize("kind", ["soft", "dual"])
@pytest.mark.parametrize("S", [2, 4])
def test_next_rows_keep_a_nan(lib, S, kind):
    """The NaN cases: D3's outputs the same as its plain version's (NaN
    positions equal, the rest bit-equal; tangents allclose as
    ``checked_dual_step`` holds them, NaN where the plain's are)."""
    run, t = start(lib, "hybrid", S, kind)
    dual = kind == "dual"
    bodies = run.begin(t)
    for body in bodies[:bodies.index("D3")]:
        run.launch(body, t)
        run.after(body, t)
    micro, macro = nan_lanes(run)
    with torch.no_grad(), fwad.dual_level():
        refs = [{k: v for k, v in run.plain("D3", i, t).items()
                 if k != "events" or not dual}
                for i in range(len(run.shards))]
        refs = [{k: (tuple(fwad.unpack_dual(x) for x in v) if k == "carry"
                     else fwad.unpack_dual(v)) for k, v in ref.items()}
                for ref in refs]
    run.launch("D3", t)
    for i, ref in enumerate(refs):
        if dual:
            got = run._dual_written("D3", i, t)
        else:
            got = {k: tuple((x, None) for x in v) if k == "carry"
                   else (v, None)
                   for k, v in ks.STEP["D3"].written(run.view(i, t)).items()}
        for name, r in ref.items():
            pairs = (zip(r, got[name]) if name == "carry"
                     else [(r, got[name])])
            for (rv, rd), (gv, gd) in pairs:
                assert same(gv, rv.to(gv.dtype)), (name, i)
                if gd is not None and rd is not None:
                    assert torch.allclose(rd, gd, rtol=1e-5, atol=1e-5,
                                          equal_nan=True), (name, i)
    rows = next_rows(run)
    assert bool(rows[0, 6, micro].isnan()) and bool(rows[0, 1, macro].isnan())
    assert not bool(rows[1].isnan().any())  # episode 1 has no NaN


@pytest.mark.parametrize("kind", ["hard", "soft", "dual"])
def test_last_step_leaves_a_rows(lib, kind):
    run, t = start(lib, "micro", 2, kind)
    run.step(t)
    t = run.plan.T - 1
    bodies = run.begin(t)
    assert bodies == ks.EVERY_STEP  # step t's rows came with D3's terms
    for body in bodies:
        if body == "D3":
            rows = [(b["sumA_v"].clone(), b["sumA_d"])
                    for _, _, b, _ in run.shards]
            rows = [(v, None if d is None else d.clone()) for v, d in rows]
        run.launch(body, t)
        run.after(body, t)
    for (v, d), (_, _, b, _) in zip(rows, run.shards):
        assert torch.equal(v, b["sumA_v"])
        assert d is None or torch.equal(d, b["sumA_d"])
    assert run.t_next is None and run.g_next == {}


@pytest.mark.parametrize("mode", ["hard", "soft"])
def test_one_shard_reads_and_rewrites_its_own_buffer(lib, mode):
    """One local shard, no process group: the gathered A rows are the
    shard's own buffer, which B reads and D3 then rewrites for the next
    step; every launch checked, the episode equal to the plain one."""
    run, t0 = shard_run(lib, "micro", 1, mode == "soft", B, steps=40)
    before = dict(ks.launches)
    buf = run.shards[0][2]["sumA_v"]
    aliased = 0
    for t in range(t0, run.plan.T):
        run.checked_step(t)
        aliased += run.g["gA_v"].data_ptr() == buf.data_ptr()
    assert aliased == run.plan.T
    launched = {k: ks.launches[k] - before[k] for k in before}
    assert launched["A"] == 1 and launched["D3"] == run.plan.T
    ref = ks.plain_sharded_episode(run.plan, ks.LaneComm.whole(run.plan.L),
                                   *run.inputs)
    for a, r in zip(run.outputs(), ref):
        assert torch.equal(a, r)
    assert int(ref[1][..., 0].sum()) > 0  # injections
