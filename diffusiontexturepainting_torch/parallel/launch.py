"""A process's local ranks as spawned processes.

`run_local_ranks(fn, args)` starts one process a rank with
torch.multiprocessing's spawn start method (never fork: the parent may
have initialised CUDA), runs fn(*args[i]) in process i and returns the
results in rank order. Each result travels back as a pickle file in a
temporary directory. The parent waits on the processes and, where one
exits with an error, or where `timeout` seconds pass, stops every other
one (terminate, then kill) and raises with the failed rank's traceback, so
that no rank is left waiting in a collective for a peer that died.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback


def _child(fn, args, out_path: str) -> None:
    """A spawned rank: fn(*args), its result or its traceback pickled to
    `out_path`; a failure exits with status 1."""
    try:
        result = ("ok", fn(*args))
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        result = ("error", traceback.format_exc())
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)
    if result[0] != "ok":
        sys.exit(1)


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]  # started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + 10
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()


def run_local_ranks(fn, args: list, timeout: float | None = None) -> list:
    """fn(*args[i]) in a spawned process for each i; returns the results
    in order. Raises RuntimeError naming the first rank that failed (with
    its traceback), TimeoutError after `timeout` seconds; either way every
    process is stopped first."""
    import torch.multiprocessing as mp
    from multiprocessing.connection import wait

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="dtp_ranks_")
    paths = [os.path.join(tmp, f"rank{i}.pkl") for i in range(len(args))]
    procs = [ctx.Process(target=_child, args=(fn, a, path), daemon=True)
             for a, path in zip(args, paths)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        pending = dict(enumerate(procs))
        while pending:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"ranks {sorted(pending)} still running "
                                   f"after {timeout} s")
            wait([p.sentinel for p in pending.values()],
                 timeout=None if left is None else min(left, 5.0))
            for i, p in list(pending.items()):
                if p.is_alive():
                    continue
                p.join()
                del pending[i]
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {i} failed (exit code "
                                       f"{p.exitcode}):\n{_error(paths[i])}")
        results = []
        for path in paths:
            with open(path, "rb") as f:
                results.append(pickle.load(f)[1])
        return results
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _error(path: str) -> str:
    try:
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        return value if status == "error" else ""
    except OSError:
        return "(the process left no result: killed?)"
