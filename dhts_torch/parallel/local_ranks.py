"""S processes of one machine joined in a gloo process group over a
``FileStore`` in a temporary directory (no ports).

This is how the tests and ``chip_smoke.py`` drive the lane-sharded step
without ``torchrun``. :class:`LocalRanks` starts the ranks once and runs
one function after another in all of them: each rank calls ``fn(rank, S,
*args)`` with the default process group initialised, and the return values
come back in rank order. :func:`run_local` runs one function in ranks of
its own. A rank that raises, or a call that exceeds its time, ends every
rank and raises here: no failure is passed over.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback


def _rank_main(rank, nprocs, tasks, tmp, timeout):
    import torch
    import torch.distributed as dist

    # one intra-op thread per rank: S ranks share the machine's cores
    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}")
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), nprocs)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=nprocs,
            timeout=datetime.timedelta(seconds=timeout))
        call = 0
        while (task := tasks.get()) is not None:
            fn, args = task
            result = fn(rank, nprocs, *args)
            dist.barrier()
            # written whole, then renamed: the parent never reads a part
            torch.save(result, f"{out}.{call}.part")
            os.replace(f"{out}.{call}.part", f"{out}.{call}.pt")
            call += 1
        dist.destroy_process_group()
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


class LocalRanks:
    """``nprocs`` spawned ranks of a gloo group, kept for several calls of
    :meth:`run` until :meth:`close` (or the end of a ``with`` block).
    ``timeout`` bounds each call and the group's collectives, in
    seconds."""

    def __init__(self, nprocs: int, timeout: float = 600.0):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.nprocs, self.timeout, self.calls = nprocs, timeout, 0
        self._tmp = tempfile.TemporaryDirectory()
        self._tasks = [ctx.SimpleQueue() for _ in range(nprocs)]
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, nprocs, self._tasks[r],
                                         self._tmp.name, timeout),
                                   daemon=True)
                       for r in range(nprocs)]
        for p in self._procs:
            p.start()

    def run(self, fn, args=()):
        """``[fn(rank, nprocs, *args) for rank in range(nprocs)]``, each in
        its rank (``fn`` must be importable by module name). Raises
        ``RuntimeError`` with the failing ranks' tracebacks, after ending
        every rank, if a rank fails or the call outlasts ``timeout``."""
        return self.result(self.submit(fn, args))

    def submit(self, fn, args=()):
        """Start :meth:`run`'s call in the ranks and return at once, so that
        this process can work meanwhile; :meth:`result` waits for it."""
        if self._procs is None:
            raise RuntimeError("the ranks are closed")
        call, self.calls = self.calls, self.calls + 1
        for q in self._tasks:
            q.put((fn, tuple(args)))
        return call, time.monotonic() + self.timeout

    def result(self, submitted):
        """The results of a :meth:`submit`, in rank order (as :meth:`run`)."""
        import torch

        if self._procs is None:
            raise RuntimeError("the ranks are closed")
        call, deadline = submitted
        paths = [os.path.join(self._tmp.name, f"rank{r}.{call}.pt")
                 for r in range(self.nprocs)]
        while not all(os.path.exists(p) for p in paths):
            if any(p.exitcode is not None for p in self._procs):
                self._fail("a rank failed")
            if time.monotonic() > deadline:
                self._fail(f"the ranks ran longer than {self.timeout:.0f} s")
            time.sleep(0.05)
        return [torch.load(p, weights_only=False) for p in paths]

    def _fail(self, why: str):
        self._stop()
        errs = []
        for r in range(self.nprocs):
            path = os.path.join(self._tmp.name, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
        codes = [p.exitcode for p in self._procs]
        self._procs = None
        self._tmp.cleanup()
        raise RuntimeError(f"{why} (exit codes {codes})\n" + "\n".join(errs))

    def _stop(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()

    def close(self):
        """End the ranks (each leaves the group once every rank is told)."""
        if self._procs is None:
            return
        for q in self._tasks:
            q.put(None)
        for p in self._procs:
            p.join(60)
        failed = [p.exitcode for p in self._procs if p.exitcode != 0]
        self._stop()
        codes = [p.exitcode for p in self._procs]
        self._procs = None
        self._tmp.cleanup()
        if failed:
            raise RuntimeError(f"a rank failed on closing (exit codes "
                               f"{codes})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        elif self._procs is not None:
            self._stop()
            self._procs = None
            self._tmp.cleanup()
        return False


def run_local(fn, nprocs: int, args=(), timeout: float = 600.0):
    """``[fn(rank, nprocs, *args) for rank in range(nprocs)]`` in
    ``nprocs`` ranks of their own (:class:`LocalRanks`), ended after the
    call."""
    with LocalRanks(nprocs, timeout) as ranks:
        return ranks.run(fn, args)
