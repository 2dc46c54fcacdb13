"""Spawn ``torch.distributed`` ranks and bring their results back.

:func:`spawn` starts ``world`` processes (the ``spawn`` start method),
joins them into one process group through a ``file://`` store, runs the
rank body in each and returns what every rank returned, in rank order.
The backend is gloo for CPU ranks and NCCL for cards (rank r on
``cuda:r``).  The rank body is a function of this package named as
``'module:function'``, called as ``body(mesh, payload)`` with the rank's
:class:`~.mesh.ProcessMesh`; ranks import nothing but torch, numpy and
this package, and run ``torch.set_num_threads(1)``.  A rank starts
with the knobs' defaults and the environment's ``SPARK_RAPIDS_TORCH_*``
values: a ``config.set`` in the parent does not reach it (pass knobs in
the payload).

A hung collective fails the call instead of hanging its caller: the
process group gets a ``timeout``, and the parent waits at most
``wall_s`` seconds for all ranks, then kills every one still alive and
raises :class:`TimeoutError`.  A rank that raises fails the call with its
traceback.
"""

from __future__ import annotations

import datetime
import importlib
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Optional

import torch


def _rank_main(rank: int, world: int, init_file: str, backend: str,
               device: str, target: str, payload, pg_timeout_s: float,
               conn) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=pg_timeout_s))
        try:
            from .mesh import ProcessMesh

            mod, fn = target.split(":")
            body = getattr(importlib.import_module(mod), fn)
            mine = payload[rank] if isinstance(payload, _PerRank) \
                else payload
            out = body(ProcessMesh(device=device), mine)
        finally:
            dist.destroy_process_group()
        conn.send(("ok", out))
    except BaseException:  # noqa: BLE001 - sent to the parent, re-raised
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class _PerRank(list):
    """A payload list whose element ``r`` goes to rank ``r``."""


def per_rank(payloads) -> _PerRank:
    """Mark ``payloads`` as one payload per rank (rank r gets element r)
    instead of one payload every rank gets."""
    return _PerRank(payloads)


def spawn(world: int, target: str, payload=None,
          backend: Optional[str] = None, wall_s: float = 120.0,
          pg_timeout_s: Optional[float] = None) -> list:
    """Run ``target`` on ``world`` fresh ranks; return their results.

    ``backend``: ``'gloo'`` (CPU ranks, the default without CUDA) or
    ``'nccl'`` (rank r on ``cuda:r``; needs ``world`` cards).
    ``payload`` goes to every rank, or element r to rank r when wrapped
    by :func:`per_rank`; it and the results must pickle.  ``wall_s``
    bounds the whole call; ``pg_timeout_s`` (default: ``wall_s``) bounds
    each collective.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and torch.cuda.device_count() < world:
        raise RuntimeError(f"NCCL needs one card per rank: {world} ranks, "
                           f"{torch.cuda.device_count()} cards")
    ctx = mp.get_context("spawn")
    fd, init_file = tempfile.mkstemp(prefix="srj_pg_")
    os.close(fd)
    os.unlink(init_file)  # the store creates it
    procs, conns = [], []
    try:
        for r in range(world):
            parent, child = ctx.Pipe(duplex=False)
            dev = f"cuda:{r}" if backend == "nccl" else "cpu"
            p = ctx.Process(
                target=_rank_main, daemon=True,
                args=(r, world, init_file, backend, dev, target, payload,
                      pg_timeout_s or wall_s, child))
            p.start()
            child.close()
            procs.append(p)
            conns.append(parent)
        deadline = time.monotonic() + wall_s
        results = [None] * world
        pending = dict(zip(conns, range(world)))
        while pending:
            left = deadline - time.monotonic()
            ready = wait(list(pending), max(left, 0.0))
            if not ready:
                raise TimeoutError(
                    f"ranks {sorted(pending.values())} of {world} gave no "
                    f"result within {wall_s} s (target {target})")
            for conn in ready:
                r = pending.pop(conn)
                try:
                    status, out = conn.recv()
                except EOFError:
                    procs[r].join(5.0)
                    raise RuntimeError(
                        f"rank {r} of {world} died (exit code "
                        f"{procs[r].exitcode})") from None
                if status != "ok":
                    raise RuntimeError(f"rank {r} of {world} failed:\n"
                                       f"{out}")
                results[r] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5.0)
        for c in conns:
            c.close()
        if os.path.exists(init_file):
            os.unlink(init_file)
