"""The in-process device mesh of the distributed engine.

The reference runs one program over a JAX device mesh (``shard_map``) and
moves data between devices with ``ppermute`` ring shifts.  Its counterpart
here is a mesh of R *ranks* inside one process: each rank is a position on
the named axes and a torch device (all on ``cuda:0`` with one card,
``cuda:i % n`` with n cards, or the host).  A collective is a Python
function over the list of the ranks' tensors; :meth:`Mesh.shift` is the
ring shift, a rotation of that list followed by ``.to(receiver's device)``.

Ranks are numbered x-major over the axes in the mesh's order:
``rank = ((c0 · n1) + c1) · n2 + c2``, the linearization of
``DomainConfig.device_coords``.  :meth:`Mesh.ordered` gives the same ranks
numbered over another order of the axes (the distributed engine numbers
them in ``DomainConfig.mesh_axes`` order).

``make_production_mesh`` gives the reference's deployment meshes, (16, 16)
and (2, 16, 16), on the meta device: the dry-run (``launch/dryrun.py``)
plans them.

Two more views of a mesh serve the dry-run:

* ``count_shift_bytes()`` counts the bytes each rank sends through
  :meth:`Mesh.shift`, the distributed engine's only collective (the
  reference's ``collective-permute``).
* ``device_mesh(mesh)`` is a ``torch.distributed`` ``DeviceMesh`` of the
  mesh's shape and axis names over the default process group, which the
  caller initialises: ``fake_group(size)`` (the dry-run: the process is
  rank 0 of ``size``, and every collective only shapes its output), or any
  real group (gloo, NCCL).  DTensors placed on it carry the LM cells'
  shardings (``sharding.distribute_tree``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device


def _tree_to(tree: Any, device: torch.device):
    """Every tensor of a (dict / list / tensor) tree moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor of a (dict / list / tensor) tree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return tree.nbytes if isinstance(tree, torch.Tensor) else 0


# ``fn(sender, axis, nbytes)`` for each rank's value ``Mesh.shift`` moves.
shift_observers: List[Callable[[int, str, int], None]] = []


@dataclasses.dataclass
class ShiftBytes:
    """Bytes sent through :meth:`Mesh.shift`, ``sent[(rank, axis)]``."""

    sent: Dict[Tuple[int, str], int] = dataclasses.field(
        default_factory=collections.Counter)

    def ranks(self) -> Dict[int, int]:
        """``{rank: bytes}`` over every rank that sent."""
        out: Dict[int, int] = collections.Counter()
        for (r, _), n in self.sent.items():
            out[r] += n
        return dict(out)

    def on_axes(self, rank: int) -> Dict[str, int]:
        """``{axis: bytes}`` that ``rank`` sent along each axis."""
        return {a: n for (r, a), n in self.sent.items() if r == rank}


@contextlib.contextmanager
def count_shift_bytes() -> Iterator[ShiftBytes]:
    """Within the context, the bytes each rank sends through
    :meth:`Mesh.shift`."""
    count = ShiftBytes()

    def observe(rank: int, axis: str, nbytes: int) -> None:
        count.sent[rank, axis] += nbytes

    shift_observers.append(observe)
    try:
        yield count
    finally:
        shift_observers.remove(observe)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over R ranks, each with its device.

    axis_names: the axis names, in rank-numbering order.
    axis_sizes: the extent of each axis.
    devices:    one torch device a rank, in rank order.
    """

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.axis_sizes)} sizes")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")
        if len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for {self.size} ranks")

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def rank_coords(self, rank: int) -> Tuple[int, ...]:
        """The coordinates of ``rank`` on the axes, in axis order."""
        coords = []
        for n in reversed(self.axis_sizes):
            coords.append(rank % n)
            rank //= n
        return tuple(coords[::-1])

    def rank_of(self, coords: Sequence[int]) -> int:
        rank = 0
        for c, n in zip(coords, self.axis_sizes):
            rank = rank * n + int(c) % n
        return rank

    def axis_index(self, rank: int, axis: str) -> int:
        """``jax.lax.axis_index(axis)`` as seen by ``rank``."""
        return self.rank_coords(rank)[self.axis_names.index(axis)]

    def shift(self, values: Sequence[Any], axis: str, direction: int) -> list:
        """The ring shift of ``_shift``/``ppermute``: rank i's value goes to
        the rank ``direction`` steps further along ``axis`` (mod its size),
        the other coordinates kept.  ``values`` holds one tensor (or tree of
        tensors) a rank; the result is indexed by the receiving rank and lies
        on its device."""
        if len(values) != self.size:
            raise ValueError(f"shift: {len(values)} values for {self.size} ranks")
        d = self.axis_names.index(axis)
        out = [None] * self.size
        for rank, value in enumerate(values):
            if shift_observers:
                nbytes = tree_nbytes(value)
                for observe in shift_observers:
                    observe(rank, axis, nbytes)
            coords = list(self.rank_coords(rank))
            coords[d] += direction
            dest = self.rank_of(coords)
            out[dest] = _tree_to(value, self.devices[dest])
        return out

    def ordered(self, axes: Sequence[str]) -> "Mesh":
        """The same ranks numbered x-major over ``axes`` (every axis of the
        mesh that is longer than 1 must be among them; the others are
        dropped)."""
        axes = tuple(axes)
        missing = [a for a in axes if a not in self.axis_names]
        if missing:
            raise ValueError(f"axes {missing} are not axes of the mesh {self.axis_names}")
        left = [a for a in self.axis_names if a not in axes and self.shape[a] != 1]
        if left:
            raise ValueError(f"mesh axes {left} are not decomposed: every axis longer "
                             f"than 1 must be named")
        sizes = tuple(self.shape[a] for a in axes)
        out = Mesh(axis_names=axes, axis_sizes=sizes,
                   devices=tuple(self.devices[0] for _ in range(math.prod(sizes))))
        devices = []
        for rank in range(out.size):
            named = dict(zip(axes, out.rank_coords(rank)))
            devices.append(self.devices[self.rank_of([named.get(a, 0)
                                                      for a in self.axis_names])])
        return dataclasses.replace(out, devices=tuple(devices))


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None) -> Mesh:
    """A mesh of ``prod(shape)`` ranks on the named ``axes``.

    ``devices``: ``None`` / ``"cuda"`` spreads the ranks over the cards
    (rank i on ``cuda:i % n``; raises without a card), ``"cpu"`` puts them
    all on the host, ``"meta"`` on the meta device (the dry-run's plans: no
    storage), a sequence gives one device a rank."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    size = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        dev = resolve_device(devices)
        if dev.type == "cuda" and (devices is None or torch.device(devices).index is None):
            n = torch.cuda.device_count()
            devs = tuple(torch.device("cuda", i % n) for i in range(size))
        else:
            devs = (dev,) * size
    else:
        devs = tuple(resolve_device(d) for d in devices)
    return Mesh(axis_names=axes, axis_sizes=shape, devices=devs)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's deployment meshes on the meta device (the dry-run
    plans them; nothing runs there): one pod, (16, 16) ``("data",
    "model")`` = 256 devices, or two, (2, 16, 16) ``("pod", "data",
    "model")`` = 512, whose leading axis crosses the inter-pod links."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices="meta")


def device_mesh(mesh: Mesh, device_type: str = "cpu"):
    """``mesh``'s shape and axis names as a ``DeviceMesh`` over the default
    process group, which must hold ``mesh.size`` ranks (rank i at the
    coordinates ``mesh.rank_coords(i)``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("device_mesh: no process group; initialise one first "
                           "(fake_group for a plan)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"device_mesh: the process group has {dist.get_world_size()} ranks, "
                         f"the mesh {mesh.size}")
    ranks = torch.arange(mesh.size).reshape(mesh.axis_sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=mesh.axis_names)


@contextlib.contextmanager
def fake_group(size: int, rank: int = 0) -> Iterator[None]:
    """The default process group as ``torch.distributed``'s ``"fake"``
    backend over ``size`` ranks, this process being ``rank``: nothing is
    sent, a collective only gives its output's shape.  Destroyed on exit;
    raises if a group is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already initialised")
    if "fake" not in dist.Backend.backend_list:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers it)
    dist.init_process_group("fake", rank=rank, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
