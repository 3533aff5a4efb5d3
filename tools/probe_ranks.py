"""The rank harness of ``tools/tp_serve_probe.py`` and
``tools/tp_train_probe.py``: one process a card, joined in one NCCL
process group (``tcp://localhost``, a free port), or ``gloo`` ranks on the
CPU for a rehearsal (``--device cpu``).

A probe's ``main`` calls ``mesh_shapes(args)`` and then ``launch(rank_main,
args)``; its ``rank_main(rank, args, port)`` calls ``join`` first and uses
``report``, ``free``, ``clock`` and ``checksum``, and ``mesh_axes`` and
``batch_shards`` of each of ``mesh_shapes``' shapes.
"""
from __future__ import annotations

import datetime
import math
import os
import socket


def checksum(t) -> float:
    """The sum of ``t`` in f64, 2^26 elements at a time (no f64 copy of
    the whole leaf)."""
    import torch
    return sum(float(c.sum(dtype=torch.float64))
               for c in t.reshape(-1).split(1 << 26))


def clock(fn, on_card: bool):
    """``(fn(), ms)``: its time by CUDA events on the card, 0.0 on the
    CPU (where no device time is taken)."""
    if not on_card:
        return fn(), 0.0
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def join(rank: int, args, timeout_s: int):
    """This rank's device (card ``rank``, or the CPU on one torch thread),
    in the process group of ``args.cards`` ranks; a collective that waits
    longer than ``timeout_s`` fails the run."""
    import torch
    import torch.distributed as dist
    on_card = args.device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    dist.init_process_group(
        "nccl" if on_card else "gloo",
        init_method=f"tcp://localhost:{args.port}", rank=rank,
        world_size=args.cards, device_id=dev if on_card else None,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def report(rec, cards: int) -> list:
    """Every rank's ``rec``, in rank order, on every rank."""
    import torch.distributed as dist
    every = [None] * cards
    dist.all_gather_object(every, rec)
    return every


def free(on_card: bool) -> None:
    import gc
    gc.collect()
    if on_card:
        import torch
        torch.cuda.empty_cache()


def mesh_shapes(args) -> list:
    """``args.meshes`` ("1x4,2x2,2x1x2") as (data, model) pairs or (pod,
    data, model) triples, each of ``args.cards`` devices; on the card,
    that many cards must be present."""
    shapes = []
    for shape in args.meshes.split(","):
        dims = tuple(int(x) for x in shape.split("x"))
        if len(dims) not in (2, 3) or math.prod(dims) != args.cards:
            raise SystemExit(f"mesh {shape} is not {args.cards} cards over "
                             "(data, model) or (pod, data, model)")
        shapes.append(dims)
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < args.cards:
            raise SystemExit(f"{args.cards} cards asked for, "
                             f"{torch.cuda.device_count()} present")
    return shapes


def mesh_axes(dims: tuple) -> tuple:
    """The axis names of a mesh of shape ``dims``: the JAX package's
    single-pod ("data", "model") or multi-pod ("pod", "data", "model")."""
    return ("pod", "data", "model")[-len(dims):]


def batch_shards(dims: tuple) -> int:
    """The shards of a batch over the mesh's batch axes (all but
    "model")."""
    return math.prod(dims[:-1])


def launch(rank_main, args, **env) -> int:
    """``rank_main(rank, args)`` in ``args.cards`` spawned processes, with
    ``args.port`` a free local port and the environment defaults ``env``
    besides NCCL's asynchronous error handling."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        args.port = s.getsockname()[1]
    import torch.multiprocessing as mp
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    for name, value in env.items():
        os.environ.setdefault(name, value)
    mp.start_processes(rank_main, args=(args,), nprocs=args.cards,
                       start_method="spawn")
    return 0
