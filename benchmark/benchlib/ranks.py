"""The ranks of a cell on more than one card: one process a card, all joined
in one process group (NCCL on cards, gloo on the CPU).

``run.py``'s process is rank 0, on ``cuda:0``.  ``Ranks.start`` picks a free
port of localhost for the group's store and starts ranks 1..W-1 as processes
of their own::

    python3 -m benchmark.benchlib.ranks --rank R --world W --port P --device cuda

rank R on ``cuda:R`` (``--device cpu``: every rank on the CPU).  ``run.py``
starts them before its own ``import torch``, so that all ranks load torch at
once; this module imports torch only inside the functions that use it.
``Ranks.open`` then makes the store (a ``TCPStore``, which the ranks wait
for) and leaves there what every rank must know: the cell as loaded, the
seed, the window's seconds, whether it is traced, the impl.

A thread of rank 0 watches the ranks: where one ends with a status other than
0, it ends the others and the whole run with status 4 (``RANK_FAILED``), and
no result is printed.  A rank whose parent has gone ends itself.  Every wait
on the store or the group has a time limit (``TIMEOUT``).

Between set-up and the check every rank runs the same client calls, each
announced by rank 0 (``Header``): a request's index, ``WARM`` for a warm-up
request, ``STOP`` once the window has closed.  Rank r's part is
``runner.run_rank``; it leaves its report (its card, memory peak, set-up and
trace summary, and the forbidden modules it holds) in the store under
``report/<r>``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import threading
import time

from benchmark.benchlib import spec

#: the longest any rank waits on the store or on a collective
TIMEOUT = datetime.timedelta(seconds=300)
#: the status of a run that a rank's end cut short
RANK_FAILED = 4
#: request headers other than a request's index
WARM, STOP = -2, -1


def log(*parts) -> None:
    print("benchmark:", *parts, file=sys.stderr, flush=True)


def rank_argv(rank: int, world: int, port: int, device_type: str) -> list[str]:
    """The command of rank ``rank`` (>= 1), run from the checkout's root."""
    return [sys.executable, "-m", "benchmark.benchlib.ranks", "--rank", str(rank),
            "--world", str(world), "--port", str(port), "--device", device_type]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join(store, rank: int, world: int, device) -> None:
    """Join the process group of ``store``; returns once every rank has."""
    import torch.distributed as dist

    if device.type == "cuda":
        dist.init_process_group("nccl", store=store, rank=rank, world_size=world,
                                timeout=TIMEOUT, device_id=device)
    else:
        dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                                timeout=TIMEOUT)
    dist.barrier()


class Ranks:
    """Rank 0's hold on ranks 1..W-1: their processes, the thread that
    watches them and, once opened, their store."""

    def __init__(self, world: int, port: int, procs: list):
        self.world, self.port, self.procs = world, port, procs
        self.store = None
        #: called, each with no argument, before a failed rank ends the run
        self.on_failure: list = []
        self._closing = threading.Event()
        self._watcher = threading.Thread(target=self._watch, daemon=True)
        self._watcher.start()

    @classmethod
    def start(cls, world: int, device_type: str) -> Ranks:
        """Start ranks 1..world-1 (``device_type`` "cuda" or "cpu")."""
        port = _free_port()
        procs = [subprocess.Popen(rank_argv(r, world, port, device_type), cwd=spec.ROOT,
                                  stdout=subprocess.DEVNULL)
                 for r in range(1, world)]
        return cls(world, port, procs)

    def open(self, run: dict) -> None:
        """Make the store the ranks wait for and leave ``run`` there."""
        import torch.distributed as dist

        self.store = dist.TCPStore("127.0.0.1", self.port, self.world, is_master=True,
                                   timeout=TIMEOUT, wait_for_workers=False)
        self.store.set("run", json.dumps(run))

    def _watch(self) -> None:
        while not self._closing.wait(0.2):
            self._end_if_a_rank_failed()

    def _end_if_a_rank_failed(self) -> None:
        """Where a rank has ended with a status other than 0: end the others
        and this process, with status ``RANK_FAILED``."""
        failed = {rank: proc.poll() for rank, proc in enumerate(self.procs, 1)
                  if proc.poll() not in (None, 0)}
        if not failed:
            return
        for rank, code in failed.items():
            log(f"rank {rank} ended with status {code}: the run ends with no result")
        for fn in self.on_failure:
            fn()
        self._kill()
        os._exit(RANK_FAILED)

    def reports(self) -> list[dict]:
        """Ranks 1..W-1's reports, in rank order."""
        return [json.loads(self.store.get(f"report/{r}")) for r in range(1, self.world)]

    def _kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs:
            proc.wait()

    def abort(self) -> None:
        """End the ranks at once (the run too, where one of them has failed)
        and leave the group."""
        import torch.distributed as dist

        self._closing.set()
        self._watcher.join()
        self._end_if_a_rank_failed()
        self._kill()
        if dist.is_initialized():
            dist.destroy_process_group()

    def close(self, timeout: float = 120.0) -> None:
        """Leave the group and wait for the ranks to end; one that has not
        after ``timeout`` seconds is killed, and fails the run."""
        import torch.distributed as dist

        deadline = time.monotonic() + timeout
        if dist.is_initialized():
            dist.destroy_process_group()
        for proc in self.procs:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self.abort()


class Header:
    """The word rank 0 sends before each client call: ``announce`` on rank
    0, ``receive`` on the others."""

    def __init__(self, device):
        import torch

        self.word = torch.zeros(1, dtype=torch.int64, device=device)

    def announce(self, value: int) -> None:
        import torch.distributed as dist

        self.word.fill_(value)
        dist.broadcast(self.word, src=0)

    def receive(self) -> int:
        import torch.distributed as dist

        dist.broadcast(self.word, src=0)
        return int(self.word.item())


def _end_with(parent: int) -> None:
    """End this process once its parent, rank 0, has gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(RANK_FAILED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.benchlib.ranks")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    args = ap.parse_args(argv)
    threading.Thread(target=_end_with, args=(os.getppid(),), daemon=True).start()
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.TCPStore("127.0.0.1", args.port, args.world, is_master=False, timeout=TIMEOUT)
    run = json.loads(store.get("run"))
    from benchmark.benchlib import runner

    device = torch.device("cuda", args.rank) if args.device == "cuda" else torch.device("cpu")
    try:
        report = runner.run_rank(spec.cell_from_json(run["cell"]), args.rank, args.world,
                                 device, store, run)
        store.set(f"report/{args.rank}", json.dumps(report))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
