"""The D3 launch, the lane-sharded step's whole conversion (every lane's
wants into a table in shared memory, one barrier, each lane's arbitration
where it reads a verdict), compiled for the host, against its plain
version ``plain_body_D`` on crafted rows.

``csrc/itscp_spatial_shard.cu`` is built with g++ against
``csrc/cpu_emulation.h`` and driven through the card's launcher, S = 2 and
4 shards in one process. After C's launch and the gathers after it, a
case rewrites the gathered post-physics rows (the next lanes, heads and
counts) and the carry where the rows must agree with it (a lane's count;
its capacitor toward its next lane, whose value C gathers), so that the
conversion meets the situation the case names; then D3's launch is held
against ``plain_body_D`` on the same rows (``ShardRun.checked_step``: the
carry, the static terms and the emit and absorb counts bit-equal; the
derivative's ``Dual`` launch by ``checked_dual_step``: values equal,
tangents within rtol 1e-5, atol 1e-5 times the largest), and the rows'
arbitration (``plain_arbitration``) is asserted to be the one the case
builds:

* every predecessor of a micro lane hands its head on into it: the
  lowest id wins, the others keep their heads;
* every predecessor of a macro lane deposits into it: the lowest wins;
* a macro lane emits from its capacitor and hands its head on into the
  same micro lane, and a lane that is not the micro lane's predecessor
  wants in too and is passed over;
* lanes without a next lane (``mn < 0``) whose heads leave the network
  (``hnext < 0``);
* deposits and next lanes at the last lane, L - 1 (the arbitration's
  "none" is L, clamped to L - 1 where a row is read).

The micro scene at step 20 (heads on every lane) and the hybrid scene at
step 116 (the plain state there), B = 2, T cut to the checked step.
"""

import ctypes

import pytest
import torch

from dhts_torch.ops.cuda import _build
from dhts_torch.ops.cuda import itscp_spatial_shard as ks
from dhts_torch.ops.cuda import itscp_spatial_step as k6
from tests.test_torch_shard_bd3_host import shard_run

torch.set_num_threads(1)

B = 2


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    out = tmp_path_factory.mktemp("conversion")
    try:
        path = _build.build_cpu_emulation("itscp_spatial_shard", out)
    except RuntimeError as err:
        pytest.skip(f"no host build of the kernel source: {err}")
    return ks.bind(ctypes.CDLL(str(path)))


class Rows:
    """What a case edits after C: this step's gathered rows and the carry
    of the shard that holds a lane."""

    def __init__(self, run):
        self.run, self.plan, self.g = run, run.plan, run.geom
        self.F, self.I = run.g["gF_v"], run.g["gI"]
        self.Fd = run.g.get("gF_d")

    def shard(self, lane):
        for i, (s, p_n, b, _) in enumerate(self.run.shards):
            if s.off <= lane < s.off + s.n:
                return s, p_n, b, lane - s.off
        raise IndexError(lane)

    def count(self, lane):
        """The lane's most vehicles over the rows."""
        return int(self.F[:, ks.F_COUNT, lane].max())

    def head_past_end(self, lane, beyond=1.0):
        """The lane's head past its end by ``beyond`` (past its end and its
        own length for a deposit); an empty lane gets one vehicle, in its
        carry's count and in the row F_COUNT (the vehicle keeps what its
        slot held)."""
        s, p_n, b, j = self.shard(lane)
        count = k6.unpack(p_n, b["fbuf"], b["ibuf"])[0][11][:, j]
        count.clamp_(min=1)
        self.F[:, ks.F_COUNT, lane] = count.to(torch.float32)
        veh_len = self.plan.floats[2]
        self.F[:, ks.F_HLEN, lane] = veh_len
        self.F[:, ks.F_HA, lane] = veh_len
        self.F[:, ks.F_HVEL, lane] = 3.0
        self.F[:, ks.F_HPOS, lane] = float(self.g.length[lane]) + beyond

    def slot(self, lane, dest):
        nk = self.g.next_k[:, lane].tolist()
        return nk.index(dest) if dest in nk else -1

    def set_cap(self, lane, dest, value):
        """The lane's capacitor toward ``dest`` (one of its next lanes)."""
        s, p_n, b, j = self.shard(lane)
        k = self.slot(lane, dest)
        assert k >= 0, (lane, dest)
        k6.unpack(p_n, b["fbuf"], b["ibuf"])[0][14][:, k, j] = value

    def sync_cap(self):
        """Every lane's row F_CAP as C gathers it: its capacitor toward
        its next lane (``gI``'s ``mn``), 0 without one (and its tangent in
        a derivative)."""
        nk = self.g.next_k[None]
        match = (nk == self.I[:, ks.I_MN, None]) & (nk >= 0)  # [N, K, L]
        slot = torch.argmax(match.to(torch.int32), 1, keepdim=True)
        for rows, buf in ((self.F, "fbuf"), (self.Fd, "dbuf")):
            if rows is None:
                continue
            cap = torch.cat([k6.unpack(p_n, b[buf], b["ibuf"])[0][14]
                             for _, p_n, b, _ in self.run.shards], -1)
            rows[:, ks.F_CAP] = torch.where(match.any(1), cap.gather(
                1, slot).squeeze(1), 0.0)


def preds(g, lane):
    p = g.prev_k[:, lane]
    return sorted(int(x) for x in p[p >= 0])


def first_lane(g, macro, n_preds):
    """The first lane of the kind with at least ``n_preds``
    predecessors."""
    for lane in range(g.is_macro.shape[0]):
        if bool(g.is_macro[lane]) == macro and len(preds(g, lane)) >= \
                n_preds:
            return lane
    raise LookupError("no such lane in the scene")


def case_transfer_all(r):
    """Every predecessor of a micro lane X hands its head on into it."""
    X = first_lane(r.g, False, 2)
    ps = preds(r.g, X)
    for p in ps:
        r.head_past_end(p)
        r.I[:, ks.I_HNEXT, p] = X
    assert r.count(X) < r.plan.V
    return {"best": {X: ps[0]}, "want": {"transfer": ps}}


def case_deposit_all(r):
    """Every predecessor of a macro lane Y deposits its head into it."""
    Y = first_lane(r.g, True, 2)
    ps = preds(r.g, Y)
    for p in ps:
        r.head_past_end(p, beyond=r.plan.floats[2] + 1.0)
        r.I[:, ks.I_HNEXT, p] = Y
    return {"dep": {Y: ps[0]}, "want": {"deposit": ps}}


def case_emit_and_transfer(r):
    """A macro lane p emits from its capacitor and hands its head on into
    one micro lane Z; a lane q that is not Z's predecessor wants in too."""
    g = r.g
    Z = next(z for z in range(r.plan.L) if not bool(g.is_macro[z]) and
             any(bool(g.is_macro[p]) for p in preds(g, z)))
    p = next(q for q in preds(g, Z) if bool(g.is_macro[q]))
    q = next(x for x in range(r.plan.L) if x not in preds(g, Z) and
             x != Z and bool(g.is_macro[x]) == bool(g.is_macro[p]))
    veh_len = r.plan.floats[2]
    r.I[:, ks.I_MN, p] = Z
    r.set_cap(p, Z, 2.0 * veh_len)
    # room behind Z's tail
    r.F[:, ks.F_TPOS, Z] = float(g.length[Z]) + 2.0 * veh_len
    r.F[:, ks.F_TLEN, Z] = veh_len
    for lane in (p, q):
        r.head_past_end(lane)
        r.I[:, ks.I_HNEXT, lane] = Z
    assert r.count(Z) < r.plan.V
    return {"best": {Z: p}, "want": {"emit": [p], "transfer": [p, q]}}


def case_no_next(r):
    """Every fourth lane has no next lane and its head leaves the
    network."""
    lanes = list(range(0, r.plan.L, 4))
    for lane in lanes:
        r.head_past_end(lane)
        r.I[:, ks.I_MN, lane] = -1
        r.I[:, ks.I_HNEXT, lane] = -1
    return {"want": {"exit": lanes}}


def case_last_lane(r):
    """The last lane's predecessors want into it (a deposit where it is a
    macro lane, a transfer where micro), as does a lane that is not its
    predecessor; a lane's next lane is L - 1."""
    L = r.plan.L
    last = L - 1
    ps = preds(r.g, last)
    other = next(x for x in range(L) if x not in ps and x != last)
    macro = bool(r.g.is_macro[last])
    for lane in ps + [other]:
        r.head_past_end(lane, beyond=r.plan.floats[2] + 1.0 if macro else
                        1.0)
        r.I[:, ks.I_HNEXT, lane] = last
    r.I[:, ks.I_MN, other] = last
    kind = "deposit" if macro else "transfer"
    return {("dep" if macro else "best"): {last: ps[0]},
            "want": {kind: ps + [other]}}


CASES = {"transfer_all": ("micro", case_transfer_all),
         "deposit_all": ("hybrid", case_deposit_all),
         "emit_and_transfer": ("hybrid", case_emit_and_transfer),
         "no_next_micro": ("micro", case_no_next),
         "no_next_hybrid": ("hybrid", case_no_next),
         "last_lane_micro": ("micro", case_last_lane),
         "last_lane_hybrid": ("hybrid", case_last_lane)}
WANTS = {"exit": 0, "emit": 1, "transfer": 2, "deposit": 3}
MICRO_STEP = 20  # the micro scene's checked step: heads on every lane


def crafted(case, expect):
    """The ``edit`` hook of a checked step: after C's gathers, rewrite the
    rows by ``case`` and check that their arbitration is the case's."""

    def edit(run, body):
        if body != "C":
            return
        r = Rows(run)
        want = case(r)
        r.sync_cap()
        pred, gV = ks.plain_arbitration(run.plan, run.geom, r.F, r.I)
        for kind, lanes in want.pop("want").items():
            assert bool(pred[:, WANTS[kind], lanes].all()), (kind, lanes)
        for row, wins in want.items():
            for dest, src in wins.items():
                assert bool((gV[:, int(row == "dep"), dest] == src).all()), (
                    row, dest, src)
        expect.append(want)

    return edit


@pytest.mark.parametrize("kind", ["hard", "soft", "dual"])
@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_d3_launch_matches_plain_on_crafted_rows(lib, name, S, kind):
    scene, case = CASES[name]
    t = MICRO_STEP if scene == "micro" else None
    run, t0 = shard_run(lib, scene, S, kind != "hard", B, dual=kind == "dual",
                        steps=(t + 1 if t is not None else 1))
    for s in range(t0, run.plan.T - 1):
        run.step(s)
    t = run.plan.T - 1
    expect = []
    if kind == "dual":
        errs = run.checked_dual_step(t, ("D3",), edit=crafted(case, expect))
        assert "D3" in errs
    else:
        run.checked_step(t, edit=crafted(case, expect))
    assert len(expect) == 1


def test_d3_refuses_a_table_beyond_its_shared_memory(lib):
    """D3's want table takes 3 L ints of shared memory, within the 48 KB a
    block takes without opting in: a scene of more than 4,096 lanes is
    refused (the launcher's error), not run another way; so is a D3
    without its gathered rows."""
    run, t0 = shard_run(lib, "micro", 2, False, 1, steps=1)
    run.step(t0)
    _, _, _, args = run.shards[0]
    args = ks.ShardArgs.from_buffer_copy(args)
    big = torch.zeros((1, ks.N_F, 4097), dtype=torch.float32)
    big_i = torch.full((1, ks.N_I, 4097), -1, dtype=torch.int32)
    args.gF_v, args.gI = big.data_ptr(), big_i.data_ptr()
    args.d_L = 4097
    d3 = ks.KERNELS.index("D3")
    assert lib.launch_itscp_shard(d3, 0, ctypes.byref(args), 1, None) != 0
    args.gF_v = None
    args.d_L = run.plan.L
    assert lib.launch_itscp_shard(d3, 0, ctypes.byref(args), 1, None) != 0
