"""One rank per device on torch.distributed: launch, process groups and the
collectives of the mesh engines (panagram_tpu.parallel.mesh on a JAX mesh).

A mesh of N devices is N ranks, each a process with one device: cuda:<local
rank> on NCCL, or the CPU on Gloo.  ``launch`` starts a process's ranks with
torch.multiprocessing in the spawn start method and joins them; a rank that
fails makes ``launch`` raise (the others are stopped), and a hung collective
fails when the process group's timeout runs out.  With P processes (hosts)
of N/P ranks each, process i holds the global ranks i*N/P .. (i+1)*N/P - 1.

Every rank runs the same program (SPMD).  The first rank of each process is
its *writer*: it alone writes that process's files, and results are gathered
to the writers only.  The process groups:

* the default group carries the data collectives of a stage (all_to_all
  routing, gathers of chunk results to the writers, overflow sums), during
  which every rank is busy, so it has the short DATA_TIMEOUT; with several
  processes, each process's ranks form a group of the same backend too
  (gathers of bitmap rows to the process's own writer);
* a Gloo group carries the control plane (barriers, lockstep checks) and
  the host copies of the dictionary shards on their way to the writers: a
  rank may wait there while the writer works alone (counting, writing
  tables), so it has the long CONTROL_TIMEOUT.  A peer that dies breaks its
  Gloo connections, so a wait there fails at once and not at the timeout.

Every control decision is taken from values that all ranks gathered, so no
rank takes another branch than its peers.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import socket
import time

import torch
import torch.distributed as dist

from ..ops import kernels

DATA_TIMEOUT = datetime.timedelta(seconds=900)
CONTROL_TIMEOUT = datetime.timedelta(hours=24)
# how often launch() polls its ranks
_POLL_S = 0.2


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: `size` ranks, `local_size` per
    process, `device` this rank's device, `control` the Gloo group."""

    size: int
    rank: int
    local_size: int
    device: torch.device
    control: object = None
    # this process's ranks as a group of the default backend (None: one
    # process, whose ranks are the default group)
    local_group: object = None

    @property
    def process_index(self) -> int:
        return self.rank // self.local_size

    @property
    def process_count(self) -> int:
        return self.size // self.local_size

    @property
    def writer(self) -> bool:
        return self.rank % self.local_size == 0

    def local_ranks(self) -> range:
        """The global ranks of this rank's process."""
        first = self.process_index * self.local_size
        return range(first, first + self.local_size)

    def writer_ranks(self) -> range:
        """The global rank of every process's writer."""
        return range(0, self.size, self.local_size)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def join_mesh(size: int, rank: int, local_size: int,
                           device: torch.device, init_method: str) -> Mesh:
    """Join the process group as `rank` of `size` (NCCL for a CUDA device,
    Gloo for the CPU), create the Gloo control group and, with several
    processes, each process's group (every rank creates every group)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, world_size=size,
                            rank=rank, timeout=DATA_TIMEOUT)
    control = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
    mesh = Mesh(size, rank, local_size, device, control)
    if mesh.process_count > 1:
        for first in mesh.writer_ranks():
            g = dist.new_group(list(range(first, first + local_size)),
                               timeout=DATA_TIMEOUT)
            if first == mesh.local_ranks()[0]:
                mesh.local_group = g
    return mesh


def sharded_writes_enabled(mesh: Mesh) -> bool:
    """True when a multi-process mesh build writes per-process bitmap pieces
    that process 0 stitches (the default with more than one process);
    PANAGRAM_TPU_SHARD_WRITES=0 makes every process write every file under
    its own prefix instead."""
    return writes_pieces(mesh.process_count)


def writes_pieces(process_count: int) -> bool:
    """sharded_writes_enabled for a build of `process_count` processes."""
    if os.environ.get("PANAGRAM_TPU_SHARD_WRITES", "1") == "0":
        return False
    return process_count > 1


def barrier(mesh: Mesh):
    """Wait for every rank, on the control group."""
    dist.barrier(group=mesh.control)


def check_lockstep(mesh: Mesh, tag: str, value):
    """Raise on every rank when `value` differs between ranks: a stage-skip
    decision that differs would make the ranks call different collectives.
    A collective: every rank calls it at the same point."""
    h = hashlib.sha256(repr(value).encode()).digest()[:8]
    mine = torch.tensor([int.from_bytes(h, "little", signed=True)],
                        dtype=torch.int64)
    every = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(every, mine, group=mesh.control)
    if any(int(t) != int(mine) for t in every):
        raise RuntimeError(
            f"multi-process build desync at '{tag}': ranks disagree on a "
            f"cached-stage decision (value here: {value!r}).  All processes "
            "must start from equivalent stage states: use fresh or equal "
            "output dirs, or pass --force to every process.")


def lockstep_decision(mesh: Mesh, tag: str, decide):
    """decide() on every rank once the writers' earlier writes are done,
    checked equal across ranks (check_lockstep)."""
    barrier(mesh)
    value = decide()
    check_lockstep(mesh, tag, value)
    return value


def all_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Elementwise sum of `t` over the ranks (in place, returned)."""
    dist.all_reduce(t)
    return t


def gather_to_writers(mesh: Mesh, t: torch.Tensor, local: bool = False):
    """Every rank's `t` (same shape on every rank) on each writer rank, as
    a list in rank order; None on the other ranks.  One gather to each
    writer; with local=True only this process's ranks, to its own writer,
    over its process group (what a writer of per-process pieces needs)."""
    t = t.contiguous()
    if local:
        ranks = mesh.local_ranks()
        writers, group = ranks[:1], mesh.local_group
    else:
        ranks, writers, group = range(mesh.size), mesh.writer_ranks(), None
    mine = None
    for w in writers:
        out = [torch.empty_like(t) for _ in ranks] if mesh.rank == w else None
        dist.gather(t, out, dst=w, group=group)
        if out is not None:
            mine = out
    return mine


def gather_rows_to_writers(mesh: Mesh, t: torch.Tensor):
    """Every rank's CPU tensor `t`, whose first dimension may differ
    between ranks, concatenated in rank order on each writer rank; None on
    the other ranks.  Over the Gloo control group, so that no device holds
    more than its own rank's rows: the row counts first, then the rows
    padded to the longest."""
    n = torch.tensor([t.shape[0]], dtype=torch.int64)
    every = [torch.empty_like(n) for _ in range(mesh.size)]
    dist.all_gather(every, n, group=mesh.control)
    counts = [int(c) for c in every]
    pad = t.contiguous()
    if t.shape[0] < max(counts):
        pad = t.new_zeros((max(counts),) + tuple(t.shape[1:]))
        pad[:t.shape[0]] = t
    mine = None
    for w in mesh.writer_ranks():
        out = ([torch.empty_like(pad) for _ in range(mesh.size)]
               if mesh.rank == w else None)
        dist.gather(pad, out, dst=w, group=mesh.control)
        if out is not None:
            mine = torch.cat([g[:c] for g, c in zip(out, counts)])
    return mine


def all_to_all(mesh: Mesh, t: torch.Tensor, send_counts: torch.Tensor):
    """Rows of `t` grouped by destination rank (send_counts int64 [S] rows
    for each) -> (the rows this rank receives, grouped by source rank, and
    their counts as a list).  The counts travel first, so each rank
    receives exactly its rows."""
    recv_counts = torch.empty_like(send_counts)
    dist.all_to_all_single(recv_counts, send_counts)
    send, recv = send_counts.tolist(), recv_counts.tolist()
    out = t.new_empty((sum(recv),) + tuple(t.shape[1:]))
    dist.all_to_all_single(out, t.contiguous(), recv, send)
    return out, recv


@dataclasses.dataclass
class RankResult:
    """What one rank of ``launch`` sends back: fn's return value, the
    kernel launches the rank counted (ops/kernels.launches) and its peak
    device memory (torch.cuda.max_memory_allocated; 0 on the CPU)."""

    rank: int
    value: object
    launches: dict
    peak_bytes: int


def _rank_main(local_rank: int, fn, args, size: int, local_size: int,
               process_id: int, init_method: str, device_type: str,
               results):
    """Body of one spawned rank: join the group, run fn(mesh, *args), send
    back its RankResult."""
    if device_type == "cpu":
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1)
                                         // local_size)))
        device = torch.device("cpu")
    else:
        device = torch.device(device_type, local_rank)
    rank = process_id * local_size + local_rank
    mesh = join_mesh(size, rank, local_size, device, init_method)
    try:
        out = fn(mesh, *args)
        peak = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device)
        results.put(RankResult(rank, out, dict(kernels.launches), peak))
    finally:
        dist.destroy_process_group()


def check_ranks(size: int, device_type: str, num_processes: int = 1) -> int:
    """The ranks of this process in a `size`-rank mesh over num_processes
    processes on `device_type`; raises when they do not divide or, on
    cuda, when this process sees fewer cards than it runs ranks."""
    if size < 1 or num_processes < 1 or size % num_processes:
        raise ValueError(f"--mesh {size} is not a multiple of "
                         f"--num-processes {num_processes}")
    local_size = size // num_processes
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--mesh on cuda: torch.cuda.is_available() is "
                               "false")
        visible = torch.cuda.device_count()
        if local_size > visible:
            raise RuntimeError(
                f"--mesh {size}: {local_size} ranks of this process need "
                f"{local_size} CUDA devices but {visible} are visible (one "
                "rank per card: NCCL does not run two ranks on one card)")
    elif device_type != "cpu":
        raise ValueError(f"--mesh runs on cuda or cpu, not {device_type!r}")
    return local_size


def launch(fn, args: tuple, size: int, device_type: str,
           num_processes: int = 1, process_id: int = 0,
           coordinator: str | None = None, timeout: float | None = None):
    """Run fn(mesh, *args) on this process's size / num_processes ranks of
    a `size`-rank mesh, each a spawned process with its own device, and
    wait for them.  Returns this process's ranks' RankResults in rank
    order (this process's kernels.launches counts none of their launches).

    device_type "cuda" gives local rank r the card cuda:r and needs that
    many visible cards; "cpu" runs every rank on the CPU.  Several
    processes meet at `coordinator` (host:port, served by process 0);
    one process picks a free local port.  A failed rank raises here and
    the others are stopped; so does the `timeout` (seconds) running out."""
    import torch.multiprocessing as mp

    local_size = check_ranks(size, device_type, num_processes)
    if num_processes > 1 and not coordinator:
        raise ValueError("a mesh over several processes needs a coordinator "
                         "(host:port)")
    init_method = f"tcp://{coordinator or f'127.0.0.1:{free_port()}'}"
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(fn, args, size, local_size, process_id,
                          init_method, device_type, results),
        nprocs=local_size, join=False, daemon=True, start_method="spawn")
    got = {}

    def drain():
        while not results.empty():
            r = results.get()
            got[r.rank] = r

    t0 = time.monotonic()
    try:
        while True:
            drain()
            if procs.join(timeout=_POLL_S):
                break
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise TimeoutError(f"mesh ranks still running after "
                                   f"{timeout} s")
        drain()
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    return [got[r] for r in sorted(got)]
