"""Start one process per rank on this host and run a function in each.

``spawn_ranks(fn, n_ranks, args)`` runs ``fn(rank, n_ranks, device,
*args)`` in ``n_ranks`` spawned processes, each inside an initialised
default process group: ``nccl`` with rank r on card r, which is the
default and raises without a card, or ``gloo`` when the caller asks for
``device="cpu"`` (rendezvous over a file in a directory of its own).
A rank that fails, or has not finished by the deadline, ends the call:
the ranks still running are killed and the error carries every failed
rank's traceback, so a hung rank holds nothing up.

``fn`` must be a module-level function (``spawn`` pickles it by name and
re-imports its module in every rank).  Under a launcher that starts the
ranks itself (``torchrun``), call ``comm.init_process_group`` instead.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch

from . import comm


def _rank_main(fn, rank, n_ranks, device, args, workdir, group_timeout_s):
    err = os.path.join(workdir, f"err_{rank}.txt")
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank)
        else:
            dev = torch.device(device)
            # one intra-op thread per rank: the ranks share the host's cores
            torch.set_num_threads(1)
        comm.init_process_group(
            dev, f"file://{os.path.join(workdir, 'rendezvous')}", n_ranks,
            rank, timeout_s=group_timeout_s)
        fn(rank, n_ranks, dev, *args)
        comm.destroy_process_group()
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, n_ranks: int, args: Sequence = (),
                device: Optional[str] = None, deadline_s: float = 600.0,
                group_timeout_s: float = 120.0,
                workdir: Optional[str] = None) -> None:
    """Run ``fn(rank, n_ranks, device, *args)`` on ``n_ranks`` ranks and
    wait for them; raises RuntimeError if a rank fails or the deadline
    passes.  ``device`` is "cuda" (also when None: the ranks run on the
    cards, and the call raises without one) or "cpu".  ``workdir`` (a
    temporary directory when None) holds the rendezvous file and the
    ranks' error files."""
    device = comm.device_of(device).type
    with tempfile.TemporaryDirectory() as tmp:
        wd = tmp if workdir is None else str(workdir)
        os.makedirs(wd, exist_ok=True)
        for name in os.listdir(wd):
            if name == "rendezvous" or name.startswith("err_"):
                os.remove(os.path.join(wd, name))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(
            target=_rank_main,
            args=(fn, r, n_ranks, device, tuple(args), wd, group_timeout_s),
            daemon=True) for r in range(n_ranks)]
        for pr in procs:
            pr.start()
        end = time.monotonic() + deadline_s
        failed = None
        while any(pr.is_alive() for pr in procs):
            if time.monotonic() > end:
                failed = f"ranks still running after {deadline_s:g} s"
                break
            if any(pr.exitcode not in (None, 0) for pr in procs):
                failed = "a rank failed"
                break
            time.sleep(0.05)
        if failed is None and any(pr.exitcode != 0 for pr in procs):
            failed = "a rank failed"
        for pr in procs:
            if pr.is_alive():
                pr.kill()
            pr.join()
        if failed is None:
            return
        logs = []
        for r in range(n_ranks):
            path = os.path.join(wd, f"err_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    logs.append(f"rank {r}:\n{f.read()}")
        raise RuntimeError(
            f"{getattr(fn, '__name__', fn)} on {n_ranks} ranks: {failed} "
            f"(exit codes {[pr.exitcode for pr in procs]})\n"
            + "\n".join(logs))
