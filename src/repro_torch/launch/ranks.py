"""Ranks: one process per shard, joined by ``torch.distributed``.

The port's one-process meshes (:class:`~repro_torch.launch.mesh.Mesh`)
keep every shard on one device as a leading tensor axis.  A rank mesh
runs each shard in a process of its own, as the reference runs each on
a device of its own, and moves data between them with collectives.
:func:`init_ranks` forms the default group from the environment that
``python -m torch.distributed.run`` sets (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
or from a file (``REPRO_RANKS_FILE``, which :func:`spawn_ranks` sets:
two groups on one host never meet at one port), with a collective
timeout, and puts the rank on ``cuda:(local_rank %
device_count)``, or on the CPU when asked.

The backend is a decision made once, before the group forms, and
printed by the callers: :func:`choose_backend`.  It never changes after
a failure: a group that does not form, a rank that dies and a collective
that times out raise, and the process exits nonzero.

The sharded assembly's collectives (:func:`exchange`, :func:`gather`,
:func:`reduce`) are the plain ``torch.distributed`` ones, which both
backends carry on CUDA tensors.  DTensor's functional collectives are
not carried by a ``gloo`` group of CUDA tensors on torch 2.11:
:func:`init_ranks` then routes them through the plain ones
(:func:`sync_functional_collectives`), a choice made by the backend
before the first collective, never after a failure.
"""
from __future__ import annotations

import dataclasses
import os
from datetime import timedelta

import torch

#: the collective timeout of a group that :func:`init_ranks` forms: a
#: rank that waits longer for its peers raises instead of hanging
TIMEOUT_S = 120


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """What :func:`init_ranks` set up: this process's rank, the world,
    the rank's device and the group's backend."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str

    def describe(self) -> str:
        return (f"rank {self.rank} of {self.world} on {self.device} "
                f"({self.backend})")


_INFO: RankInfo | None = None


def choose_backend(device_type: str, *, ranks_on_host: int,
                   cards: int) -> str:
    """The group's backend: ``"nccl"`` when every rank of a host has a
    card of its own, ``"gloo"`` when ranks share a card or run on the
    CPU."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"ranks run on 'cuda' or 'cpu', not "
                         f"{device_type!r}")
    return "nccl" if 0 < ranks_on_host <= cards else "gloo"


def init_ranks(device=None, *, timeout_s: float = TIMEOUT_S) -> RankInfo:
    """Form the default process group and place this rank on its device.

    The rank and the world are ``RANK`` and ``WORLD_SIZE``; the group
    meets in the file ``REPRO_RANKS_FILE`` names, else at
    ``MASTER_ADDR:MASTER_PORT`` (the ``env://`` rendezvous of
    ``torch.distributed.run``).  ``device`` is ``"cpu"`` or None (the
    card ``cuda:(LOCAL_RANK % device_count)``; without a card it raises,
    as every entry point of the port does).  Idempotent: a second call
    returns the first one's :class:`RankInfo`.
    """
    global _INFO
    import torch.distributed as dist

    if _INFO is not None and dist.is_initialized():
        return _INFO
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    on_host = int(env.get("LOCAL_WORLD_SIZE", world))
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the ranks on the CPU")
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        cards = 0
        dev = torch.device(kind)
    backend = choose_backend(kind, ranks_on_host=on_host, cards=cards)
    init = ("file://" + env["REPRO_RANKS_FILE"]
            if env.get("REPRO_RANKS_FILE") else "env://")
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    if backend == "gloo" and kind == "cuda":
        sync_functional_collectives("CUDA")
    _INFO = RankInfo(rank, world, local_rank, dev, backend)
    return _INFO


def close_ranks() -> None:
    """End the group that :func:`init_ranks` formed and forget it, with
    everything made over it: the rank meshes that ``launch/mesh.py``
    memoises and ``sparse2``'s cached plans (a rank plan holds its
    mesh).  A later :func:`init_ranks` in the same process forms a new
    group, and the meshes and plans are made anew over it."""
    global _INFO
    import sys

    import torch.distributed as dist

    from . import mesh

    mesh.make_data_mesh.cache_clear()
    mesh._rank_mesh.cache_clear()
    matlab = sys.modules.get("repro_torch.sparse.matlab")
    if matlab is not None:
        matlab.plan_cache_clear()
    _INFO = None
    if dist.is_initialized():
        dist.destroy_process_group()


def rank0_print(info: RankInfo):
    """``print`` on rank 0 and a function that prints nothing on every
    other rank: a launcher's lines, once for the group."""
    return print if info.rank == 0 else _quiet


def _quiet(*args, **kwargs):
    """The print of a rank other than 0."""


def rank_info() -> RankInfo | None:
    """The :class:`RankInfo` of this process's group, or None when no
    group of more than one rank was formed by :func:`init_ranks`."""
    import torch.distributed as dist

    if _INFO is None or not dist.is_initialized() or _INFO.world < 2:
        return None
    return _INFO


def spawn_ranks(argv: list[str], world: int, *, timeout_s: float,
                env: dict | None = None, rendezvous: str,
                cwd: str | None = None) -> list[tuple[int, str, str]]:
    """Run ``argv`` as ``world`` ranks of one group and wait for them.

    Each child gets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE`` and ``REPRO_RANKS_FILE=rendezvous`` (a path
    that must not exist yet; :func:`init_ranks` meets there).  Returns
    ``(returncode, stdout, stderr)`` a rank.  When a rank exits nonzero,
    or the ranks outlast ``timeout_s``, the others are killed and it
    raises with every rank's last output: no rank carries on alone.
    """
    import subprocess
    import tempfile
    import time

    if os.path.exists(rendezvous):
        raise FileExistsError(f"the rendezvous file {rendezvous} exists: "
                              "a group meets in a new file")
    base = dict(os.environ if env is None else env)
    procs, outs = [], []
    for r in range(world):
        child = {**base, "RANK": str(r), "WORLD_SIZE": str(world),
                 "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(world),
                 "REPRO_RANKS_FILE": rendezvous}
        out = (tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
        outs.append(out)
        procs.append(subprocess.Popen(argv, env=child, cwd=cwd,
                                      stdout=out[0], stderr=out[1],
                                      text=True))
    deadline = time.monotonic() + timeout_s
    def exits():
        return ", ".join(f"rank {r} exited {p.returncode}"
                         for r, p in enumerate(procs)
                         if p.returncode not in (None, 0))

    try:
        while any(p.poll() is None for p in procs):
            failed = exits()
            if failed:
                break
            if time.monotonic() > deadline:
                failed = f"the ranks outlasted {timeout_s} s"
                break
            time.sleep(0.05)
        else:
            failed = exits()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    results = []
    for p, (o, e) in zip(procs, outs):
        o.seek(0)
        e.seek(0)
        results.append((p.returncode, o.read(), e.read()))
        o.close()
        e.close()
    if failed:
        tails = "\n".join(f"--- rank {r} (exit {rc}):\n{so[-2000:]}\n"
                          f"{se[-2000:]}" for r, (rc, so, se)
                          in enumerate(results))
        raise RuntimeError(f"{failed}; the other ranks were stopped\n"
                           f"{tails}")
    return results


# ---------------------------------------------------------------------------
# DTensor's collectives on a gloo group of CUDA tensors
# ---------------------------------------------------------------------------
_SYNC_LIB = None


def sync_functional_collectives(dispatch_key: str = "CUDA") -> None:
    """Run the functional collectives (``_c10d_functional``, which DTensor
    issues for every redistribution) on ``dispatch_key`` tensors as the
    plain ``torch.distributed`` collectives, synchronously.

    On a ``gloo`` group the plain collectives carry CUDA tensors, but the
    functional ones crash the process on torch 2.11 (a segmentation
    fault at the first one; ``PERF.md``), so :func:`init_ranks` installs
    this for a gloo group of CUDA ranks, chosen by the backend before
    any collective runs.  Each op returns its result at once, so the
    ``wait_tensor`` that follows finds no pending work.  Process-wide,
    installed once; ``dispatch_key="CPU"`` lets the tests run the same
    kernels on CPU tensors.
    """
    global _SYNC_LIB
    if _SYNC_LIB is not None:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "product": dist.ReduceOp.PRODUCT}

    def reduce_(x, op, name):
        g = _resolve_process_group(name)
        dist.all_reduce(x, op=ops[op], group=g)
        if op == "avg":
            x.div_(dist.get_world_size(g))
        return x

    def gather_out(x, size, name, out):
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(name))
        return out

    def gather(x, size, name):
        out = x.new_empty((x.shape[0] * size, *x.shape[1:]))
        return gather_out(x, size, name, out)

    def scatter_out(x, op, size, name, out):
        g = _resolve_process_group(name)
        dist.reduce_scatter_tensor(out, x.contiguous(), op=ops[op], group=g)
        if op == "avg":
            out.div_(size)
        return out

    def scatter(x, op, size, name):
        out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
        return scatter_out(x, op, size, name, out)

    def all_to_all(x, out_sizes, in_sizes, name):
        out_sizes = [int(n) for n in out_sizes]
        rows = sum(out_sizes) if out_sizes else x.shape[0]
        out = x.new_empty((rows, *x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), out_sizes or None,
                               [int(n) for n in in_sizes] or None,
                               group=_resolve_process_group(name))
        return out

    def broadcast_(x, src, name):
        g = _resolve_process_group(name)
        dist.broadcast(x, dist.get_global_rank(g, src), group=g)
        return x

    lib = torch.library.Library("_c10d_functional", "IMPL")
    impls = {
        "all_reduce": lambda x, op, name: reduce_(x.clone(), op, name),
        "all_reduce_": reduce_,
        "all_reduce_coalesced": lambda xs, op, name: [
            reduce_(x.clone(), op, name) for x in xs],
        "all_reduce_coalesced_": lambda xs, op, name: [
            reduce_(x, op, name) for x in xs],
        "all_gather_into_tensor": gather,
        "all_gather_into_tensor_out": gather_out,
        "all_gather_into_tensor_coalesced": lambda xs, size, name: [
            gather(x, size, name) for x in xs],
        "reduce_scatter_tensor": scatter,
        "reduce_scatter_tensor_out": scatter_out,
        "reduce_scatter_tensor_coalesced": lambda xs, op, size, name: [
            scatter(x, op, size, name) for x in xs],
        "all_to_all_single": all_to_all,
        "broadcast": lambda x, src, name: broadcast_(x.clone(), src, name),
        "broadcast_": broadcast_,
    }
    import warnings

    with warnings.catch_warnings():  # "overriding a registered kernel"
        warnings.simplefilter("ignore")
        for op, fn in impls.items():
            lib.impl(op, fn, dispatch_key)
    _SYNC_LIB = lib


# ---------------------------------------------------------------------------
# The collectives of the sharded assembly
# ---------------------------------------------------------------------------
def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """The tiled all-to-all: ``x`` is ``[p, ...]``, row ``d`` sent to
    rank ``d``; row ``s`` of the result came from rank ``s``."""
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis, rank order."""
    import torch.distributed as dist

    x = x.contiguous()
    p = dist.get_world_size(group)
    out = torch.empty(p * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.reshape(-1), group=group)
    return out.view(p, *x.shape)


def reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op="sum"``) or maximised (``"max"``) over the
    group's ranks; a new tensor."""
    import torch.distributed as dist

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    x = x.clone()
    dist.all_reduce(x, op=ops[op], group=group)
    return x
