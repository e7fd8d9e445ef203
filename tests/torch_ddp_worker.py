"""Gloo process groups on the CPU for the port's data-parallel tests
(``tests/test_torch_port_ddp*.py``).

:func:`spawn` starts a world of ranks and returns each rank's results;
:class:`Shared` does so once a test session for the xdist workers that
need the same world. Each rank joins the group on one torch thread, runs
``torch_ddp_jobs.<job>(inputs, directory)`` on the inputs the test saved in
``directory/inputs.pt`` and saves what it returns to
``directory/rank<r>.pt``; its output goes to ``directory/rank<r>.log``.
The ranks fork from a ``multiprocessing`` forkserver that has imported
torch and the jobs once for this test process (a fresh interpreter a rank
would import torch each time); they import no JAX.
"""

import multiprocessing
import os
import pathlib
import socket
import sys
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _context():
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", "torch.distributed", "torch_ddp_jobs"])
    return ctx


def _rank(job: str, directory: str, rank: int, world: int, port: int) -> None:
    """One rank: its output to its log, the group joined, the job run, its
    results saved; exit code 1 (the traceback in the log) on any error."""
    log = os.open(os.path.join(directory, f"rank{rank}.log"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(log, 1)
    os.dup2(log, 2)
    sys.stdout = os.fdopen(1, "w", buffering=1)
    sys.stderr = os.fdopen(2, "w", buffering=1)
    try:
        import torch
        import torch.distributed as dist

        import torch_ddp_jobs
        from hvt_torch import parallel

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=world)
        try:
            inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
            out = getattr(torch_ddp_jobs, job)(inputs, pathlib.Path(directory))
            torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
        finally:
            parallel.destroy()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _start(job: str, world: int, directory, inputs) -> list:
    """Save ``inputs`` and start ``world`` ranks of ``job``."""
    import torch

    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, directory / "inputs.pt")
    ctx = _context()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(job, str(directory), rank, world, port))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs


def _collect(job: str, directory, procs, timeout: float) -> list:
    """Wait for the ranks; their results by rank, or a RuntimeError with a
    failed rank's output."""
    import torch

    directory = pathlib.Path(directory)
    failed = []
    try:
        for rank, p in enumerate(procs):
            p.join(timeout)
            if p.exitcode != 0:
                failed.append(rank)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        text = "\n".join(f"--- rank {r}:\n{(directory / f'rank{r}.log').read_text()[-6000:]}"
                         for r in failed)
        raise RuntimeError(f"{job} failed on ranks {failed}:\n{text}")
    return [torch.load(directory / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def spawn(job: str, world: int, directory, inputs=None, timeout: float = 240.0) -> list:
    """Run ``job`` on ``world`` gloo ranks with ``inputs`` (saved for them);
    returns the ranks' results, by rank. Raises with a rank's output when any
    rank fails."""
    return _collect(job, directory, _start(job, world, directory, inputs), timeout)


class Shared:
    """One run of ``job`` on ``world`` ranks for a whole test session: the
    xdist workers that need ``key`` share it through a lock in the session's
    common temporary directory. The first to ask starts the ranks and
    returns at once; :meth:`get` (inputs, results) waits for them, so a test
    computes its reference first and waits only for what remains. A worker
    that finds the lock held waits in :meth:`get` for the owner's saved
    results (and runs the job itself if the owner left none)."""

    def __init__(self, key: str, job: str, world: int, tmp_path_factory, make_inputs,
                 timeout: float = 240.0):
        import fcntl

        root = tmp_path_factory.getbasetemp()
        if os.environ.get("PYTEST_XDIST_WORKER"):
            root = root.parent
        self.job, self.world, self.timeout, self.make_inputs = job, world, timeout, make_inputs
        self.directory = root / f"ddp-{key}"
        self.done = root / f"ddp-{key}.pkl"
        self.lock = open(root / f"ddp-{key}.lock", "w")
        self.value = self.procs = None
        try:
            fcntl.flock(self.lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return  # another worker runs it
        if not self.done.is_file():
            self.inputs = make_inputs()
            self.procs = _start(job, world, self.directory, self.inputs)

    def get(self):
        import fcntl
        import pickle

        if self.value is None:
            if self.procs is None:
                fcntl.flock(self.lock, fcntl.LOCK_EX)  # the owner holds it until it has saved
                if not self.done.is_file():
                    self.inputs = self.make_inputs()
                    self.procs = _start(self.job, self.world, self.directory, self.inputs)
            if self.procs is not None:
                try:
                    value = (self.inputs, _collect(self.job, self.directory, self.procs,
                                                   self.timeout))
                except BaseException:
                    fcntl.flock(self.lock, fcntl.LOCK_UN)  # a waiter then tries for itself
                    raise
                finally:
                    self.procs = None
                tmp = self.done.with_suffix(f".{os.getpid()}")
                tmp.write_bytes(pickle.dumps(value))
                os.replace(tmp, self.done)
            self.value = pickle.loads(self.done.read_bytes())
            fcntl.flock(self.lock, fcntl.LOCK_UN)
        return self.value
