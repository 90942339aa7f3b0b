"""Device meshes: the sharded assembly path's and the LM stack's.

Counterpart of ``repro/launch/mesh.py``: ``make_data_mesh`` (the
sharded assembly), ``make_host_mesh`` with ``batch_axes``, ``tp_size``
and ``dp_size`` (the serving launcher and the MoE mesh dispatch), and
``make_production_mesh``: the 16 x 16 pod (``("data", "model")``) or
the 2 x 16 x 16 pair of pods (``("pod", "data", "model")``) as a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`
over a default process group of 256 or 512 ranks.  The dry run
(``launch/dryrun.py``) makes that group on the ``"fake"`` backend, so
that the mesh needs no cards; importing this module makes no group and
no mesh.  :func:`axis_size` reads an axis's size from any of the three
kinds of mesh the rules meet: this module's :class:`Mesh`, a
``DeviceMesh`` and a duck-typed mesh with a ``shape`` dict and
``axis_names``.

On a default group of more than one rank (:func:`init_ranks`, one
process a shard, ``launch/ranks.py``), :func:`make_data_mesh` and
:func:`make_host_mesh` return a ``DeviceMesh`` with one shard a rank,
as the reference meshes over all present devices: the sharded assembly
and the LM step then exchange data between processes.
:func:`is_rank_mesh` tells the two kinds apart, :func:`mesh_device`
gives either kind's device (a rank mesh's: this rank's).

A :class:`Mesh` names its axes, their sizes and the device of every
shard.  The port keeps a mesh's shards as the leading axis of every
sharded tensor, so several shards may share one device:
``make_data_mesh(4)`` puts four shards on the current card, as the
reference's tests put four on forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``).  A
:class:`Mesh` whose shards span more than one device is refused: a
mesh over several devices is a rank mesh, one process a device.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..kernels.common import resolve_device
from .ranks import init_ranks, rank_info  # noqa: F401 - init_ranks: API


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of shards, each placed on a device.

    axis_names : the axes, in order (``("data",)`` for the assembly path)
    sizes      : the number of shards along each axis
    devices    : the device of every shard, in row-major order of the grid

    ``shape`` maps each axis name to its size, as the reference mesh's
    does (``mesh.shape["data"] == p``).  Frozen and hashable: plan
    caches key on it through
    :func:`repro_torch.sparse.sharded.mesh_fingerprint`.
    """

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    devices: tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(
                n < 1 for n in self.sizes):
            raise ValueError(
                f"a mesh needs one size >= 1 for each axis, got axes "
                f"{self.axis_names} and sizes {self.sizes}")
        if math.prod(self.sizes) != len(self.devices):
            raise ValueError(
                f"a mesh of sizes {self.sizes} needs "
                f"{math.prod(self.sizes)} shard devices, got "
                f"{len(self.devices)}")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                f"the mesh's shards span {len(set(self.devices))} devices: "
                "a Mesh runs every shard on one device; a mesh over "
                "several devices is a rank mesh, one process a shard "
                "(make_data_mesh on a group of ranks: ROADMAP queue A, "
                "item 14)")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def device(self) -> torch.device:
        """The one device every shard lives on."""
        return self.devices[0]


def _pinned(device: torch.device) -> torch.device:
    """``"cuda"`` as the card it names now, so that equal meshes compare
    and hash equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@functools.lru_cache(maxsize=None)
def make_data_mesh(n: int | None = None, *, axis: str = "data",
                   device=None) -> Mesh:
    """One-axis mesh of ``n`` shards, the default of the sharded path.

    On a group of more than one rank (:func:`init_ranks`) it is a
    ``DeviceMesh`` of one shard a rank (``n`` None or the world size),
    on the rank's device unless ``device`` names another kind.  With
    ``n=None`` there is one shard per visible CUDA device (one on a
    machine with one card; a machine with several gets a mesh the port
    refuses, see :class:`Mesh`).  A given ``n`` puts all ``n`` shards on
    one device: the current card, or ``device`` when the caller passes
    one (``device="cpu"`` runs the plain versions of the kernels).  As
    every entry point of the port, it raises with no card unless asked
    for the CPU.  Memoised, as the reference's is: the default mesh is
    resolved on every ``sparse2`` call.
    """
    if n is not None and int(n) < 1:
        raise ValueError(f"a mesh needs n >= 1 shards, got {n}")
    info = rank_info()
    if info is not None:
        if n is not None and int(n) != info.world:
            raise ValueError(
                f"a group of {info.world} ranks meshes {info.world} "
                f"shards, one a rank; got n={n}")
        return _rank_mesh((info.world,), (axis,), _rank_kind(device))
    if device is None:
        resolve_device(None)  # raises when there is no card
        if n is None:
            devices = tuple(torch.device("cuda", i)
                            for i in range(torch.cuda.device_count()))
        else:
            devices = (_pinned(torch.device("cuda")),) * int(n)
    else:
        devices = (_pinned(torch.device(device)),) * (1 if n is None
                                                      else int(n))
    return Mesh((axis,), (len(devices),), devices)


def make_host_mesh(*, data: int | None = None, model: int = 1,
                   device=None) -> Mesh:
    """A ``("data", "model")`` mesh (tests, the launchers).

    As the reference's, ``data`` defaults to the present devices over
    ``model``.  On a group of more than one rank (:func:`init_ranks`) it
    is a ``DeviceMesh`` of one shard a rank, ``data * model`` the world
    size, on the rank's device unless ``device`` names another kind.
    Otherwise the devices are one, and a given ``data`` puts ``data *
    model`` shards on that device.
    """
    info = rank_info()
    if info is not None:
        if data is None:
            data = info.world // model
        if data * model != info.world:
            raise ValueError(
                f"a ({data}, {model}) mesh needs {data * model} ranks; "
                f"the group has {info.world}")
        return _rank_mesh((data, model), ("data", "model"),
                          _rank_kind(device))
    dev = _pinned(resolve_device(device))
    if data is None:
        data = 1 // model
    return Mesh(("data", "model"), (data, model), (dev,) * (data * model))


def _rank_kind(device) -> str:
    """The device type of a rank mesh: ``device``'s, else the rank's."""
    if device is not None:
        return torch.device(device).type
    return rank_info().device.type


@functools.lru_cache(maxsize=None)
def _rank_mesh(shape: tuple, names: tuple, kind: str):
    """The ``DeviceMesh`` of ``shape`` over the default group, one per
    shape and kind: forming a mesh of several dims is itself a
    collective (its subgroups), which every rank must run alike."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(kind, shape, mesh_dim_names=names)


def is_rank_mesh(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` over ranks, as against the
    port's one-process :class:`Mesh`."""
    return mesh is not None and not isinstance(mesh, Mesh) and \
        hasattr(mesh, "get_group")


def mesh_device(mesh) -> torch.device:
    """The device a mesh's shard lives on in this process: a
    :class:`Mesh`'s one device, a rank mesh's card for this rank (the
    current card) or the CPU."""
    if isinstance(mesh, Mesh):
        return mesh.device
    return _pinned(torch.device(mesh.device_type))


#: the production meshes' shapes and axes, single pod and two pods
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production ``DeviceMesh``: 16 x 16 over ``("data", "model")``,
    or 2 x 16 x 16 over ``("pod", "data", "model")`` with ``multi_pod``.

    It needs a default process group of exactly 256 or 512 ranks (the
    dry run's ``"fake"`` group), as the reference's ``jax.make_mesh``
    needs that many devices.  The mesh's device type is ``"cuda"``
    unless the caller asks for ``device="cpu"``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != need:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={bool(multi_pod)}) needs a "
            f"default process group of exactly {need} ranks, got "
            f"{'none' if have is None else have}")
    kind = "cuda" if device is None else torch.device(device).type
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple[str, ...]:
    """A mesh's axis names: ``mesh_dim_names`` of a ``DeviceMesh``,
    ``axis_names`` of any other."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh.axis_names if names is None else names)


def axis_size(mesh, axis) -> int:
    """The number of shards along ``axis`` (a name, or a tuple of names:
    their product; the empty tuple gives 1), on a :class:`Mesh` or a
    duck-typed mesh (``shape`` a dict) or a ``DeviceMesh`` (``shape`` a
    tuple in the order of ``mesh_dim_names``)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    shape = mesh.shape
    if not isinstance(shape, dict):
        shape = dict(zip(axis_names(mesh), shape))
    return math.prod(shape[a] for a in axes)


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh axes that carry data parallelism."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def tp_size(mesh) -> int:
    return axis_size(mesh, "model")


def dp_size(mesh) -> int:
    return axis_size(mesh, batch_axes(mesh))
