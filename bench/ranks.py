"""The rank launcher: a cell of more than one card runs in one process a
card, all joined in one process group (NCCL on the cards, over
``tcp://localhost`` at a free port; ``gloo`` on the CPU, for rehearsals).

``launch(world, device_type, target, payload)`` starts the ranks and
waits.  Each rank joins the group and calls ``target(rank, world, device,
host, payload)`` (``host``: a ``gloo`` group for the host's own decisions
and tallies, None where the default group is ``gloo`` already); rank 0's
return value is handed to the parent, which returns it once every rank has
ended well.  The ranks write to standard error only: the parent alone
prints the result.  If a rank dies, or the run passes ``deadline``
seconds, the parent ends every rank and raises ``RankFailure``; a
collective that waits longer than ``COLLECTIVE_S`` fails its rank (NCCL's
watchdog, gloo's timeout), so a run never hangs.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import sys
import time

__all__ = ["COLLECTIVE_S", "DEADLINE_S", "RankFailure", "launch"]

COLLECTIVE_S = 300      # a collective that waits longer fails its rank
DEADLINE_S = 1150       # the whole run, first build included


class RankFailure(RuntimeError):
    pass


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _join(rank: int, world: int, port: int, device_type: str):
    """This rank's device and host group, in the process group."""
    import torch
    import torch.distributed as dist
    on_card = device_type == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        # the host's cores shared out, so that the ranks' threads do not
        # crowd each other
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world,
        device_id=dev if on_card else None,
        timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    host = dist.new_group(backend="gloo") if on_card else None
    return dev, host


def _entry(rank, world, port, device_type, target, payload, conn):
    os.dup2(2, 1)               # the parent alone writes standard output
    sys.stdout = sys.stderr
    import torch.distributed as dist
    dev, host = _join(rank, world, port, device_type)
    out = target(rank, world, dev, host, payload)
    dist.barrier(group=host)    # every rank is past its last collective
    if conn is not None:
        conn.send(out)
        conn.close()
    dist.destroy_process_group()


def _end(procs) -> None:
    """End every rank still running and wait for each."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(15)
        if p.is_alive():
            p.kill()
            p.join()


def launch(world: int, device_type: str, target, payload,
           deadline: float = DEADLINE_S):
    """Rank 0's ``target(...)`` return value, once all ``world`` ranks
    have ended with code 0; ``RankFailure`` where one did not, or where
    the run passed ``deadline`` seconds (every rank is ended then)."""
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    mp = multiprocessing.get_context("spawn")
    recv, send = mp.Pipe(duplex=False)
    port = _free_port()
    procs = [mp.Process(target=_entry, daemon=True,
                        args=(r, world, port, device_type, target, payload,
                              send if r == 0 else None))
             for r in range(world)]
    for p in procs:
        p.start()
    send.close()
    got, result = False, None
    end = time.monotonic() + deadline
    try:
        while True:
            if not got and recv.poll(0.2):
                try:
                    result, got = recv.recv(), True
                except EOFError:        # rank 0 ended without a result
                    got = True
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RankFailure(f"rank {bad[0][0]} exited with code "
                                  f"{bad[0][1]}")
            if all(c == 0 for c in codes):
                if not got and recv.poll(1):
                    result = recv.recv()
                break
            if time.monotonic() > end:
                raise RankFailure(f"the run passed its {deadline:.0f} s "
                                  "deadline")
    finally:
        _end(procs)
        recv.close()
    if result is None:
        raise RankFailure("rank 0 ended without a result")
    return result
