"""The harness's data-parallel path: a cell of ``chips`` > 1 runs one
process a card, ranks 0 .. N-1, each driving the program's data-parallel
train step (``train_step.build_train_step_fn`` with the process group) on
its own rows of every global batch.

Rank 0 is the process the benchmark's command started. It builds or loads
the kernel library first, then starts ranks 1 .. N-1 (``python3 -m
portbench.dp SPEC``), which only load it, so no two ranks compile at once.
The ranks join through the program's own ``parallel/dist.join`` (NCCL on
the cards, gloo on the CPU, over ``tcp://127.0.0.1``), and a gloo side
group carries the harness's own barriers, votes and maxima on the host,
which never wait for a card.

A failed rank ends the run with no result: rank 0 polls its ranks every
``POLL_S`` and, when one exits with an error, or the run outlives
``deadline``, kills them all and exits ``EXIT_FAILED``; a rank whose rank 0
is gone exits too; and every collective of the process groups times out
after ``TIMEOUT_S``.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from datetime import timedelta
from pathlib import Path
from typing import List, Optional

EXIT_FAILED = 4  # a rank failed or the run outlived its deadline
TIMEOUT_S = 120  # a collective's limit, in either process group
SETUP_LIMIT_S = 300  # from the ranks' start to the window's end, less
                     # twice its seconds (the traced part and its teardown)
STOP_EVERY = 4  # window steps between two votes on whether to stop
POLL_S = 0.2
ROOT = Path(__file__).resolve().parents[1]
# NCCL between the cards of one host without its shared-memory transport
NCCL_ENV = {"NCCL_SHM_DISABLE": "1"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Watch:
    """Rank 0's guard over the processes of ranks 1 .. N-1 (see the
    module)."""

    def __init__(self, procs: List[subprocess.Popen], deadline: float):
        self.procs = procs
        self.deadline = deadline
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._done.wait(POLL_S):
            self.check()
            if time.monotonic() > self.deadline:
                self.fail("the run outlived its deadline")

    def check(self) -> None:
        """Fail the run if a rank has exited with an error."""
        for r, p in enumerate(self.procs, 1):
            rc = p.poll()
            if rc not in (None, 0):
                self.fail(f"rank {r} exited with {rc}")

    def _end_ranks(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def kill(self) -> None:
        """Stop watching and end the ranks (rank 0 fails on its own)."""
        with self._lock:
            self._done.set()
        self._end_ranks()

    def fail(self, why: str) -> None:
        """End every rank and this process, with no result."""
        with self._lock:
            if self._done.is_set():
                return
            self._done.set()
            print(f"portbench: {why}; ending the run", file=sys.stderr,
                  flush=True)
            self._end_ranks()
            os._exit(EXIT_FAILED)

    def finish(self) -> None:
        """Wait until ranks 1 .. N-1 have ended, each by ``TIMEOUT_S``;
        a rank that fails or does not end fails the run."""
        t = time.monotonic() + TIMEOUT_S
        for r, p in enumerate(self.procs, 1):
            try:
                rc = p.wait(max(t - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                rc = "nothing: it did not end after the window"
            if rc != 0:
                self.fail(f"rank {r} exited with {rc}")
        self._done.set()


def watch_parent(parent: int) -> None:
    """In rank r > 0: exit once rank 0's process is gone."""
    def run():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(EXIT_FAILED)
    threading.Thread(target=run, daemon=True).start()


class Group:
    """This rank's place in the run: its ``rank``, the process group the
    program's step reduces over (``group``), the gloo side group of the
    harness's own host collectives, and on rank 0 the ``Watch`` over the
    other ranks."""

    def __init__(self, ranks, side, watch: Optional[Watch] = None):
        self.rank, self.group, self.side = ranks.rank, ranks.group, side
        self.ranks = ranks
        self.watch = watch

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.side)

    def _reduce_max(self, value: float) -> float:
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.side)
        return float(t.item())

    def vote(self, stop: bool) -> bool:
        """Rank 0's decision, the same on every rank."""
        return self._reduce_max(stop and self.rank == 0) > 0

    def max(self, value: float) -> float:
        return self._reduce_max(value)

    def close(self) -> None:
        """Leave the process groups (every rank at about the same time);
        on rank 0 then wait until every other rank has ended."""
        from rangedet_tpu_torch.parallel import dist as pdist

        pdist.leave(self.ranks)
        if self.watch is not None:
            self.watch.finish()
            self.watch = None

    def abort(self) -> None:
        """On an error in rank 0: a rank that failed (its collective's
        error reaches rank 0 as the rank exits) fails the run as the
        ``Watch`` does; else end the other ranks and leave."""
        from rangedet_tpu_torch.parallel import dist as pdist

        if self.watch is not None:
            time.sleep(2 * POLL_S)
            self.watch.check()
            self.watch.kill()
            self.watch = None
        pdist.leave(self.ranks)


def join(rank: int, world: int, port: int, dev, watch: Optional[Watch]
         ) -> Group:
    """Join the run's process group as ``rank`` on ``dev`` (made current
    first), with ``TIMEOUT_S`` on every collective, and its gloo side
    group."""
    import torch
    import torch.distributed as dist

    from rangedet_tpu_torch.parallel import dist as pdist

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    url = f"tcp://127.0.0.1:{port}"
    timeout = timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend, init_method=url, rank=rank,
                            world_size=world, timeout=timeout)
    ranks = pdist.join(str(dev), backend=backend, rank=rank,
                       world_size=world, init_method=url)
    side = dist.new_group(backend="gloo", timeout=timeout)
    return Group(ranks, side, watch)


def launch(spec: dict, world: int, dev, seconds: float) -> Group:
    """On rank 0, once the kernel library is built: start ranks 1 .. N-1
    with ``spec`` (``rank_main``'s) and join them."""
    os.environ.update(NCCL_ENV)
    port = free_port()
    procs = []
    try:
        for r in range(1, world):
            arg = json.dumps(dict(spec, rank=r, world=world, port=port,
                                  parent=os.getpid()))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.dp", arg], cwd=ROOT,
                stdout=2))
    except OSError:
        for p in procs:
            p.kill()
        raise
    watch = Watch(procs, time.monotonic() + SETUP_LIMIT_S + 2 * seconds)
    try:
        return join(0, world, port, dev, watch)
    except BaseException:
        watch.kill()
        raise


def main(argv=None) -> int:
    from . import run

    spec = json.loads((argv or sys.argv[1:])[0])
    watch_parent(spec["parent"])
    return run.rank_main(spec)


if __name__ == "__main__":
    sys.exit(main())
