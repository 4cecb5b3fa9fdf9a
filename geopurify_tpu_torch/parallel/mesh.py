"""Process groups, the data axis, and the collectives the port issues.

Port of geopurify_tpu/parallel/mesh.py. JAX drives a (data, model) mesh of
local devices from one process with ``shard_map``; here a rank is one
process driving one device, launched by ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``) or by
``spawn`` below. The data axis is the default process group: ``psum`` /
``pmean`` become all-reduces, ``ppermute`` a pairwise exchange.

Every collective goes through one helper here. NCCL takes CUDA tensors
only; gloo takes CPU tensors for everything and CUDA tensors for
all-reduce and broadcast. Where a backend cannot take a tensor where it
lies (gloo's point-to-point on the card, NCCL on the CPU),
the helper copies it to where the backend can, runs the collective there
and copies the result back, and logs once that it does so: the
computation around it stays on its device. That is how several ranks
share one card over gloo (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from geopurify_tpu_torch import resolve_device

log = logging.getLogger("geopurify.parallel")

# collectives gloo runs on CUDA tensors in place
_GLOO_ON_CARD = ("all_reduce", "broadcast")


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = 60.0) -> torch.device:
    """Join the default process group and return this rank's device.

    ``backend`` defaults to NCCL for ``cuda`` and gloo for ``cpu``. The
    rendezvous, rank and world size come from the environment (``env://``,
    as ``torchrun`` sets it) unless given. Each rank drives one card,
    ``cuda:<LOCAL_RANK>`` (modulo the cards present, so that ranks over
    gloo may share one). A group that already exists is kept: an entry
    point called inside ``spawn`` joins its caller's group."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=int(os.environ["RANK"]) if rank is None else rank,
            world_size=int(os.environ["WORLD_SIZE"]) if world_size is None else world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def world() -> Tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh(NamedTuple):
    """The data axis: ``dp`` ranks, this process's ``rank`` on it, and the
    ``group`` its collectives run over (None without a process group: one
    process, no collective issued)."""

    dp: int
    rank: int
    group: Optional[Any]


# geopurify_tpu/parallel/mesh.py:12-26
def make_mesh(dp: int = -1, tp: int = 1) -> Mesh:
    """The data axis over the default group. ``dp == -1`` takes the world
    size; another ``dp`` must equal it, as JAX asserts ``dp * tp`` equals
    the device count. ``tp > 1`` raises: JAX builds the ``model`` axis but
    nothing in its package shards over it."""
    if tp != 1:
        raise NotImplementedError(
            f"parallel.tp={tp}: nothing shards over the model axis (the JAX "
            "package only builds it); the port has the data axis only")
    rank, n = world()
    if dp == -1:
        dp = n
    if dp != n:
        raise ValueError(f"parallel.dp={dp} but the world has {n} process(es); "
                         "launch dp ranks (torchrun --nproc_per_node=dp ... --distributed)")
    return Mesh(dp, rank, dist.group.WORLD if dist.is_initialized() else None)


# geopurify_tpu/parallel/mesh.py:34-41 (data_sharding / shard_batch)
def scene_index(it: int, mesh: Mesh, n_scenes: int) -> int:
    """The scene rank ``mesh.rank`` takes at step ``it`` of a list of
    ``n_scenes``: the leading (scene) axis sharded over the data axis."""
    return (it * mesh.dp + mesh.rank) % n_scenes


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _note_staging(op: str, backend: str, src: str, dst: str) -> None:
    log.info("%s cannot run %s on %s tensors: staged through %s memory", backend, op,
             src, dst)


def _staging_device(t: torch.Tensor, op: str, group) -> Optional[torch.device]:
    """Where ``op`` must run when the backend cannot take ``t`` where it
    lies; None when it can."""
    backend = dist.get_backend(group)
    if backend == "nccl" and not t.is_cuda:
        dev = torch.device("cuda", torch.cuda.current_device())
    elif backend == "gloo" and t.is_cuda and op not in _GLOO_ON_CARD:
        dev = torch.device("cpu")
    else:
        return None
    _note_staging(op, backend, t.device.type, dev.type)
    return dev


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """In-place all-reduce of ``t``; returns ``t``."""
    dev = _staging_device(t, "all_reduce", group)
    if dev is None:
        dist.all_reduce(t, op=op, group=group)
        return t
    buf = t.to(dev)
    dist.all_reduce(buf, op=op, group=group)
    return t.copy_(buf)


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In-place broadcast of rank ``src``'s ``t``; returns ``t``."""
    dev = _staging_device(t, "broadcast", group)
    if dev is None:
        dist.broadcast(t, src, group=group)
        return t
    buf = t.to(dev)
    dist.broadcast(buf, src, group=group)
    return t.copy_(buf)


def exchange(t: torch.Tensor, peer: int, group=None) -> torch.Tensor:
    """Send ``t`` to rank ``peer`` and return ``peer``'s tensor of the same
    shape and dtype (the pairwise ``ppermute`` of a hypercube round)."""
    dev = _staging_device(t, "send/recv", group) or t.device
    buf = t.contiguous().to(dev)
    got = torch.empty_like(buf)
    if dist.get_backend(group) == "nccl":
        # one NCCL group call: a bare send ahead of the receive would block
        # both ranks' streams
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, peer, group),
                                       dist.P2POp(dist.irecv, got, peer, group)])
    else:
        reqs = [dist.isend(buf, peer, group=group), dist.irecv(got, peer, group=group)]
    for req in reqs:
        req.wait()
    return got.to(t.device)


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` whose backward sums the cotangents over it too:
    the transpose JAX gives ``psum`` under ``value_and_grad`` inside
    ``shard_map(check_vma=False)``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), group=ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable all-reduce (sum) over ``group``."""
    return _AllReduceSum.apply(t, group)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], n: int, group=None) -> None:
    """``pmean`` of several tensors of one dtype and device in place, as one
    flat all-reduce: the sum over the ranks, then divided by ``n``."""
    flat = all_reduce_(torch.cat([t.reshape(-1) for t in tensors]), group=group)
    flat /= n
    off = 0
    for t in tensors:
        t.copy_(flat[off: off + t.numel()].view_as(t))
        off += t.numel()


def replicas_equal(tensors: Sequence[torch.Tensor], group=None) -> bool:
    """Whether every rank holds bit-equal ``tensors`` (rank 0's, broadcast).
    The answer is the same on every rank."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = broadcast_(flat.clone(), 0, group=group)
    same = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    return bool(all_reduce_(same, op=dist.ReduceOp.MIN, group=group).item())


# ---------------------------------------------------------------------------
# spawning ranks on one host
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, nproc: int, init_method: str, device: str,
               backend: Optional[str], timeout_s: float, args, results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    # the host's cores split between the ranks
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // nproc))
    try:
        dev = init_distributed(device, backend, init_method, rank, nproc, timeout_s)
        results.put((rank, True, fn(dev, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nproc: int, device="cpu", backend: Optional[str] = None,
          args: tuple = (), timeout_s: float = 600.0,
          init_timeout_s: float = 60.0) -> List[Any]:
    """Run ``fn(device, *args)`` in ``nproc`` fresh processes (the spawn
    start method), each a rank of one process group that rendezvous
    through a file in a temporary directory. ``fn`` must be importable
    (a module-level function) and its result picklable. Returns the
    results in rank order; a rank that fails raises here with its
    traceback (one that dies without one, with its exit code), and ranks
    still running after ``timeout_s`` are killed and raise
    ``TimeoutError``."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="geopurify_pg_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, nproc, init_method, str(device),
                                                  backend, init_timeout_s, args, results))
             for r in range(nproc)]
    deadline = time.monotonic() + timeout_s
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < nproc:
            left = deadline - time.monotonic()
            waiting = sorted(set(range(nproc)) - set(got))
            # a rank that has exited has flushed its result, if it had one
            dead = [r for r in waiting if procs[r].exitcode is not None]
            try:
                rank, ok, out = results.get(timeout=min(max(left, 0.01), 1.0))
            except queue.Empty:
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a result "
                                       f"(exit codes {[procs[r].exitcode for r in dead]})"
                                       ) from None
                if left <= 0:
                    raise TimeoutError(f"ranks {waiting} still running after {timeout_s} s"
                                       ) from None
                continue
            got[rank] = (ok, out)
            if not ok:
                break
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    failed = {r: out for r, (ok, out) in got.items() if not ok}
    if failed:
        raise RuntimeError("rank(s) failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items())))
    return [got[r][1] for r in range(nproc)]
