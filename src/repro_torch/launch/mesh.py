"""Rank meshes (port of ``repro/launch/mesh.py``): the reference's named
device mesh as a grid of ``torch.distributed`` ranks.

A :class:`RankMesh` is a shape over named axes, ``('data', 'model')`` or,
multi-pod, ``('pod', 'data', 'model')``. Rank r sits at the row-major
coordinates of r (the last axis fastest), as ``jax.make_mesh`` lays a
host's devices out, so a dim sharded over ``('data', 'model')`` is cut in
the reference's order: block ``data * n_model + model``. A mesh made over
running ranks (:func:`make_host_mesh`) holds this rank's place and one
process group for every line of every axis and every set of axes (each
rank creates every group, in the same order, as ``new_group`` requires,
and keeps its own line's); a mesh of shape only
(:func:`make_production_mesh`) holds no rank, and specs and a dry run read
its shape.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass
class RankMesh:
    """``shape`` maps each axis name to its size, in the mesh's axis order;
    ``rank`` (None on a shape-only mesh) is this process's global rank,
    ``device`` its device, ``groups`` its line's group for each tuple of
    axes (in mesh order)."""
    shape: Dict[str, int]
    rank: Optional[int] = None
    device: Optional[torch.device] = None
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis."""
        out, r = {}, self.rank
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return dict((a, out[a]) for a in self.axis_names)

    def axes(self, axis) -> Tuple[str, ...]:
        """``axis`` (a name, a tuple of names, or None) as a tuple of names
        in mesh order; an axis the mesh lacks raises."""
        if axis is None:
            return ()
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.shape:
                raise ValueError(f'mesh {self.shape} has no axis {a!r}')
        order = [a for a in self.axis_names if a in names]
        if order != list(names):
            raise ValueError(f'axes {names} are not in mesh order '
                             f'{self.axis_names}')
        return names

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[a] for a in self.axes(axis))

    def index(self, axis) -> int:
        """This rank's block index along ``axis``: its coordinates on the
        axes, flattened with the last fastest (the reference's order)."""
        c, i = self.coords, 0
        for a in self.axes(axis):
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axis):
        """The process group of this rank's line along ``axis`` (group
        rank = :meth:`index`), or None when the line is this rank alone."""
        names = self.axes(axis)
        if self.axis_size(names) == 1:
            return None
        return self.groups[names]


def _subsets(names):
    for n in range(1, len(names) + 1):
        yield from itertools.combinations(names, n)


def _build_groups(mesh: RankMesh) -> None:
    """Every line of every tuple of axes as a group, made in the same order
    on every rank; this rank keeps its own lines'."""
    coords = mesh.coords
    for axes in _subsets(mesh.axis_names):
        if math.prod(mesh.shape[a] for a in axes) == 1:
            continue
        if len(axes) == len(mesh.axis_names):
            mesh.groups[axes] = dist.group.WORLD
            continue
        rest = [a for a in mesh.axis_names if a not in axes]
        for fixed in itertools.product(*(range(mesh.shape[a])
                                         for a in rest)):
            at = dict(zip(rest, fixed))
            members = []
            for r in range(mesh.size):
                c, q = {}, r
                for a in reversed(mesh.axis_names):
                    c[a] = q % mesh.shape[a]
                    q //= mesh.shape[a]
                if all(c[a] == at[a] for a in rest):
                    members.append(r)
            g = dist.new_group(members)
            if all(coords[a] == at[a] for a in rest):
                mesh.groups[axes] = g


def make_host_mesh(n_model: int = 1, *, device=None) -> RankMesh:
    """The running ranks (``distributed/ranks.py``) as a (data = world /
    n_model, model = n_model) mesh; every rank must call it, in the same
    order as its other group creations. Outside a group: one rank."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % n_model:
        raise ValueError(f'{n} ranks do not divide n_model={n_model}')
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = RankMesh(dict(data=n // n_model, model=n_model), rank=rank,
                    device=None if device is None else torch.device(device))
    if n > 1:
        _build_groups(mesh)
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> RankMesh:
    """The reference's production meshes, shape only: one pod (data = 16,
    model = 16), 256 chips; multi-pod (pod = 2, data = 16, model = 16).
    DP spans ('pod', 'data'); TP/EP stay on 'model'."""
    if multi_pod:
        return RankMesh(dict(pod=2, data=16, model=16))
    return RankMesh(dict(data=16, model=16))


def shape_mesh(shape: Dict[str, int], rank: Optional[int] = None
               ) -> RankMesh:
    """A mesh of ``shape`` with no groups: the specs read its shape, and
    with ``rank`` :func:`repro_torch.distributed.sharding.shard_tree` cuts
    that rank's blocks."""
    return RankMesh(dict(shape), rank=rank)
