"""Collectives over the lane axis (counterparts of ``lax.all_gather(...,
tiled=True)``, ``lax.psum`` and ``lax.pmax`` inside ``shard_map``) on a
``torch.distributed`` process group.

Rank r of the lane group holds lanes ``[r * l, (r + 1) * l)`` of the scene.
:func:`all_gather_lanes` joins the ranks' blocks on the last axis in rank
order; :func:`psum` and :func:`pmax` reduce elementwise.

On an NCCL group CUDA tensors go to the collective directly. A gloo group
takes CPU tensors only, so CUDA tensors are copied to host memory here, on
purpose and in plain sight, and the result is copied back to their device
(each copy waits for the card's stream): ranks that share one card run over
gloo, and their collectives are host traffic, not the card's. On gloo the
gather is one ``all_to_all_single`` in which every rank sends its block to
every rank: gloo's ``all_gather`` passes the blocks round a ring, S - 1
message latencies in a row, where the exchange waits for about one. Every
call is counted in :data:`counts` under its kind, and its wall time added
to :data:`seconds`.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

# collective calls of this process by kind: "all_gather", and "psum" for
# the gathers of per-lane terms that the caller sums in lane order (the
# running means and the queue) and the elementwise sums; "pmax"
counts = {"all_gather": 0, "psum": 0, "pmax": 0}
# the host's wall seconds inside those calls, by kind (on gloo with CUDA
# tensors the staging copies wait for the card's stream, so a call's time
# includes the kernels queued before it)
seconds = {"all_gather": 0.0, "psum": 0.0, "pmax": 0.0}


def _timed(fn):
    def call(*args, kind):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            counts[kind] += 1
            seconds[kind] += time.perf_counter() - t0

    return call


def _staged(group) -> bool:
    """Whether the group's backend takes host tensors only (gloo)."""
    return dist.get_backend(group) == "gloo"


def all_gather_lanes(xs, group, kind: str = "all_gather"):
    """``[x_r[..., l] of every rank r]`` joined on the last axis in rank
    order, for each tensor of ``xs`` (any of 4- and 8-byte types, each of
    the same shape on every rank), in one collective call. Returns a list
    of ``[..., S * l]`` tensors on the device of ``xs``. On a gloo group the
    rows are joined in host memory and copied to the device once."""
    return _gather(xs, group, kind=kind)


@_timed
def _gather(xs, group):
    S = dist.get_world_size(group)
    dev = xs[0].device
    staged = _staged(group)
    words = [x.detach().contiguous().view(-1).view(torch.int32) for x in xs]
    flat = words[0] if len(words) == 1 else torch.cat(words)
    if staged:
        flat = flat.cpu()
    out = torch.empty(S * flat.numel(), dtype=torch.int32, device=flat.device)
    if staged:
        dist.all_to_all_single(out, flat.repeat(S), group=group)
    else:
        dist.all_gather(list(out.chunk(S)), flat, group=group)
    out = out.view(S, -1)
    joined, o = [], 0
    for x, w in zip(xs, words):
        piece = out[:, o:o + w.numel()].contiguous().view(x.dtype)
        o += w.numel()
        piece = piece.view(S, *x.shape).movedim(0, -2)
        joined.append(piece.reshape(*x.shape[:-1], S * x.shape[-1]))
    if not staged:
        return joined
    # one copy to the device; each piece starts at an 8-byte boundary so
    # that its view keeps its type
    parts, offs, o = [], [], 0
    for y in joined:
        w = y.reshape(-1).view(torch.int32)
        pad = w.numel() % 2
        parts += [w, w.new_zeros(pad)] if pad else [w]
        offs.append(o)
        o += w.numel() + pad
    buf = torch.cat(parts).to(dev)
    return [buf[a:a + y.numel() * y.element_size() // 4].view(y.dtype).view(
        y.shape) for a, y in zip(offs, joined)]


@_timed
def _reduce(x, group, op):
    # a copy (on the host for gloo): the caller's tensor stays as it was
    y = x.detach().to("cpu" if _staged(group) else x.device, copy=True)
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def psum(x, group):
    """Elementwise sum of ``x`` over the ranks of ``group``."""
    return _reduce(x, group, dist.ReduceOp.SUM, kind="psum")


def pmax(x, group):
    """Elementwise maximum of ``x`` over the ranks of ``group``."""
    return _reduce(x, group, dist.ReduceOp.MAX, kind="pmax")
