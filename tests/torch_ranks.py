"""Spawned ranks for the port's multi-rank tests on the CPU.

``spawn(fn, world, tmp_path, *args)`` runs ``fn(rank, world, out_dir,
*args)`` in ``world`` spawned processes, each with one torch thread and a
``gloo`` default process group over a ``FileStore`` in ``tmp_path`` (no TCP
port, which would collide across test workers), and returns each rank's
return value (saved with ``torch.save``).  The parent never joins a
process group, so none leaks into the test worker; a rank that finished
leaves with ``os._exit`` after a barrier.  A rank that raises
fails the call with its traceback; past ``deadline`` seconds the children
are terminated and the call raises ``TimeoutError``, so a hung collective
fails its test instead of stalling the suite.
"""
import faulthandler
import os
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 300


def _entry(rank, fn, world, store, out, args):
    # a crash in native code leaves its Python stack here for the parent
    faulthandler.enable(open(os.path.join(out, f"rank{rank}.fault"), "w"))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = fn(rank, world, out, *args)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.barrier()        # every rank is past its last collective
    # leave without the interpreter's teardown, which frees the process
    # group under gloo's native threads (a rare crash at exit); the OS
    # closes its sockets
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def spawn(fn, world, tmp_path, *args, deadline=DEADLINE_S):
    out = str(tmp_path)
    ctx = mp.start_processes(
        _entry, args=(fn, world, os.path.join(out, "store"), out, args),
        nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > end:
                raise TimeoutError(f"{fn.__name__} on {world} ranks ran past "
                                   f"its {deadline} s deadline")
    except mp.ProcessExitedException as e:
        stacks = "".join(
            open(os.path.join(out, f"rank{r}.fault")).read()
            for r in range(world)
            if os.path.exists(os.path.join(out, f"rank{r}.fault")))
        raise RuntimeError(f"{fn.__name__}: {e}\n{stacks}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def gathered(tree) -> list:
    """The leaves of a state, ``DTensor``s gathered whole."""
    from torch.distributed.tensor import DTensor

    from repro_torch.pytree import tree_leaves
    return [t.full_tensor() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree)]
