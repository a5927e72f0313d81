"""The process mesh, port of ``tpunet/parallel/mesh.py``.

tpunet lays its devices out as a 4-D ``jax.sharding.Mesh`` with axes
``('data', 'seq', 'pipe', 'model')`` and lets GSPMD insert the
collectives. Here one process drives one card, the processes form the
same grid in the same axis order (row-major: the ranks of one 'model'
group are consecutive, so tensor parallelism stays inside the closest
cards), and each axis gets the ``torch.distributed`` group of the ranks
that differ only along it. Every rank creates every group, in the same
order, as ``dist.new_group`` requires; an axis that spans the whole
world uses the default group (``None``), so a mesh of 'data' alone is
exactly the data-parallel setup of ``tpunet_torch.parallel.dist``, and
an axis of size 1 uses ``dist.SELF``, over which every collective is
the identity.

:func:`make_mesh` builds the mesh of a ``MeshConfig`` and installs it as
the process's current mesh; :func:`axis_group`, :func:`axis_size` and
:func:`axis_index` read it. Without an installed mesh the 'data' axis is
every process (``process_count``/``process_index``) and the other axes
have size 1, so code written against the axes runs unchanged in a
data-parallel or single-process run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as tdist

from tpunet_torch.config import MeshConfig
from tpunet_torch.parallel import dist

AXES = ("data", "seq", "pipe", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The grid: ``shape`` {axis: size}, this rank's ``coords`` {axis:
    index}, and ``groups`` {axis: process group, None for the whole
    world}."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]

    @property
    def size(self) -> int:
        n = 1
        for a in AXES:
            n *= self.shape[a]
        return n


_CURRENT: Optional[Mesh] = None


def _rank_of(point: Tuple[int, ...], shape: Tuple[int, ...]) -> int:
    r = 0
    for i, n in zip(point, shape):
        r = r * n + i
    return r


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of ``cfg`` over this run's processes, installed as the
    current mesh. Raises unless the axes' product is the number of
    processes."""
    cfg = cfg or MeshConfig()
    world, rank = dist.process_count(), dist.process_index()
    shape = cfg.shape(world)
    if _prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} "
                         f"(data x seq x pipe x model) needs {_prod(shape)} "
                         f"processes, have {world}")
    coords, rest = [], rank
    for n in reversed(shape):
        coords.append(rest % n)
        rest //= n
    coords = tuple(reversed(coords))
    groups: Dict[str, object] = {}
    for ax, n in enumerate(shape):
        if n == world or n == 1:
            groups[AXES[ax]] = None if n == world else dist.SELF
            continue
        # Every group of this axis, in one order on every rank: the
        # points that agree on the other axes.
        others = [i for i in range(len(shape)) if i != ax]
        mine = None
        for fixed in _grid([shape[i] for i in others]):
            point = [0] * len(shape)
            for i, v in zip(others, fixed):
                point[i] = v
            ranks = []
            for v in range(n):
                point[ax] = v
                ranks.append(_rank_of(tuple(point), shape))
            g = tdist.new_group(ranks) if dist.is_initialized() else None
            if rank in ranks:
                mine = g
        groups[AXES[ax]] = mine
    mesh = Mesh(dict(zip(AXES, shape)), dict(zip(AXES, coords)), groups)
    set_mesh(mesh)
    return mesh


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= x
    return n


def _grid(sizes):
    if not sizes:
        yield ()
        return
    for i in range(sizes[0]):
        for rest in _grid(sizes[1:]):
            yield (i,) + rest


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install ``mesh`` as this process's current mesh (None: none)."""
    global _CURRENT
    _CURRENT = mesh


def axis_size(axis: str) -> int:
    """The size of ``axis`` in the current mesh; without one, 'data' is
    every process and the others 1."""
    if _CURRENT is not None:
        return _CURRENT.shape[axis]
    return dist.process_count() if axis == "data" else 1


def axis_index(axis: str) -> int:
    """This rank's index along ``axis``."""
    if _CURRENT is not None:
        return _CURRENT.coords[axis]
    return dist.process_index() if axis == "data" else 0


def axis_group(axis: str):
    """The process group of ``axis`` (None: the whole world, which is
    the 'data' axis without a mesh; ``dist.SELF``: this rank alone)."""
    if _CURRENT is not None:
        return _CURRENT.groups[axis]
    return None if axis == "data" else dist.SELF


def mesh_shape_dict(mesh: Optional[Mesh] = None) -> Dict[str, int]:
    """Axis sizes as a plain dict (``{"data": 2, "seq": 1, ...}``), the
    JSON-able mesh identity; the current mesh by default."""
    mesh = mesh or _CURRENT
    if mesh is None:
        return {a: axis_size(a) for a in AXES}
    return {a: int(mesh.shape[a]) for a in AXES}
