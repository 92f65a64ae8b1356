"""Auto-parallel: annotation-driven sharding over the port's ranks.

Counterpart of ``paddle_tpu/distributed/auto_parallel/__init__.py`` (the
reference's ``auto_parallel``: ``ProcessMesh``, ``shard_tensor``,
``shard_op`` and the ``Resharder``). In the JAX package annotation is
placement: a ``ProcessMesh`` wraps a ``jax.sharding.Mesh`` and
``shard_tensor`` puts the array in the annotated layout at once. Here a
rank is a process, so annotation cuts the rank's block:

- :class:`ProcessMesh` lays the given process ids (ranks of the world,
  in any order) out on named dimensions and builds one process group per
  dimension slice (every rank of the world calls it, in the same order);
  ``.mesh`` is the rank's ``spmd.Mesh`` (its coordinates and groups),
  which ``with ProcessMesh(...):`` makes the active mesh.
- :func:`shard_tensor` turns ``dims_mapping`` (mesh dimension per tensor
  dimension, -1 replicated) into a partition spec and keeps this rank's
  block of the tensor (``spmd.shard_tensor``), in place on a given
  tensor, recording the layout (``.spec``, ``._dist_layout``,
  ``._full_shape`` and the mesh) for :func:`reshard`.
- :func:`shard_op` cuts an op's annotated inputs before calling it.
- :func:`reshard` gathers a tensor whole from its recorded layout over
  its mesh's groups (a collective of that mesh's ranks), then cuts the
  target's block: any two meshes and layouts.

The JAX ``reshard`` refuses a traced value (a jitted program cannot
change mesh); the port traces nothing, so it has no such refusal.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import env
from ..spmd import Mesh, P, shard_layout, shard_tensor as _cut

__all__ = ["ProcessMesh", "shard_tensor", "shard_op", "reshard",
           "get_mesh"]


def _mesh_over(arr: np.ndarray, names: Sequence[str]) -> Mesh:
    """The rank's ``spmd.Mesh`` over the process-id array ``arr``: its
    coordinate (None when the rank is not in it) and, per dimension, the
    group of the ids that share every other coordinate."""
    from ..collective import Group, new_group
    rank = env.get_rank()
    hit = np.argwhere(arr == rank)
    coords = tuple(int(c) for c in hit[0]) if len(hit) else None
    groups = {}
    for ax, name in enumerate(names):
        mine = None
        lines = np.moveaxis(arr, ax, -1).reshape(-1, arr.shape[ax])
        for line in lines:
            ranks = [int(r) for r in line]
            g = (new_group(ranks, axis_name=name) if len(ranks) > 1
                 else Group(ranks, -1, axis_name=name))
            # the ids along the dimension in coordinate order (a group
            # lists its ranks sorted)
            g.coord_ranks = ranks
            if rank in ranks:
                mine = g
        groups[name] = mine
    return Mesh(dict(zip(names, (int(d) for d in arr.shape))), groups,
                coords)


class ProcessMesh:
    """Logical process topology (the reference's ``ProcessMesh``).

    ``mesh``: a nested list of process ids (its shape is the topology);
    ``dim_names`` default to ``d0 .. dn``. Every rank of the world must
    build it, in the same order (it creates the dimensions' groups)."""

    def __init__(self, mesh, dim_names: Optional[Sequence[str]] = None,
                 process_ids=None):
        arr = np.asarray(mesh)
        if arr.ndim == 0:
            raise ValueError("mesh must be at least 1-D")
        self.topology = list(arr.shape)
        self.process_ids = [int(i) for i in arr.reshape(-1)]
        self.dim_names = list(dim_names) if dim_names else \
            [f"d{i}" for i in range(arr.ndim)]
        world = env.get_world_size()
        n = int(np.prod(self.topology))
        if n > world:
            raise ValueError(f"mesh needs {n} ranks, the world has {world}")
        bad = [i for i in self.process_ids if i >= world or i < 0]
        if bad:
            raise ValueError(f"process ids {bad} out of range (the world "
                             f"has {world} ranks)")
        if len(set(self.process_ids)) != len(self.process_ids):
            raise ValueError("duplicate process ids in mesh")
        self.mesh = _mesh_over(arr.astype(np.int64), self.dim_names)

    @property
    def shape(self):
        return self.topology

    def __enter__(self):
        self._prev = env.get_mesh()
        env.set_mesh(self.mesh)
        return self

    def __exit__(self, *exc):
        env.set_mesh(self._prev)


def _spec_from_dims_mapping(dim_names: Sequence[str], dims_mapping,
                            ndim: int) -> P:
    """``dims_mapping[i]`` is the mesh dimension that splits tensor
    dimension i (-1: none); a short mapping pads replicated."""
    dm = list(dims_mapping if dims_mapping is not None else [-1] * ndim)
    dm += [-1] * (ndim - len(dm))
    return P(*[None if m == -1 else dim_names[m] for m in dm])


def _resolve_mesh(process_mesh):
    if process_mesh is None:
        mesh = env.get_mesh()
        if mesh is None:
            raise ValueError("no target mesh: pass process_mesh= or enter "
                             "a `with ProcessMesh(...):` block")
        return mesh, list(mesh.axis_names)
    if isinstance(process_mesh, ProcessMesh):
        return process_mesh.mesh, process_mesh.dim_names
    if isinstance(process_mesh, Mesh):
        return process_mesh, list(process_mesh.axis_names)
    pm = ProcessMesh(process_mesh)
    return pm.mesh, pm.dim_names


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else \
        torch.as_tensor(np.asarray(x))


def _place(t: torch.Tensor, full: torch.Tensor, mesh: Mesh, spec: P):
    """``t`` becomes this rank's block of ``full`` under ``spec`` on
    ``mesh`` (the whole of it on a rank outside the mesh), with the
    layout recorded."""
    layout = shard_layout(spec, full.shape, mesh) \
        if mesh.coords is not None else {}
    block = _cut(full, layout, mesh).contiguous().clone() if layout \
        else full
    with torch.no_grad():
        t.data = block
    t.spec = spec
    t._dist_layout = layout
    t._full_shape = tuple(full.shape)
    t._dist_mesh = mesh
    return t


def shard_tensor(x, dist_attr: Optional[Dict] = None, process_mesh=None,
                 dims_mapping=None):
    """Cut a whole tensor to this rank's block of the annotated layout
    (the reference's ``shard_tensor``). Takes the reference's dict form
    (``{"process_mesh": ..., "dims_mapping": [...]}``) or the keywords.
    A tensor is cut in place and returned; anything else becomes a CPU
    tensor first."""
    if dist_attr:
        process_mesh = dist_attr.get("process_mesh", process_mesh)
        dims_mapping = dist_attr.get("dims_mapping", dims_mapping)
    mesh, dim_names = _resolve_mesh(process_mesh)
    t = _as_tensor(x)
    spec = _spec_from_dims_mapping(dim_names, dims_mapping, t.dim())
    return _place(t, t.detach(), mesh, spec)


def shard_op(op_fn, dist_attr: Optional[Dict] = None):
    """Wrap ``op_fn`` so that its annotated inputs are cut to their
    layouts before the call (the reference's ``shard_op``). An input's
    attribute is keyed by the input object (the reference form) or by
    its position (for a wrapper called many times)."""
    dist_attr = dist_attr or {}
    pmesh = dist_attr.get("process_mesh")
    if pmesh is not None and not isinstance(pmesh, ProcessMesh):
        pmesh = ProcessMesh(pmesh)

    def wrapped(*args, **kwargs):
        placed = []
        for i, a in enumerate(args):
            attr = dist_attr.get(i)
            if attr is None and isinstance(a, torch.Tensor):
                attr = next((v for k, v in dist_attr.items() if k is a),
                            None)
            if attr is not None and pmesh is not None:
                placed.append(shard_tensor(
                    a, process_mesh=pmesh,
                    dims_mapping=attr.get("dims_mapping")))
            else:
                placed.append(a)
        return op_fn(*placed, **kwargs)

    return wrapped


def _gather(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor from every rank's block of ``t``'s recorded
    layout (a collective over its mesh's groups; blocks ordered by the
    dimension's coordinates)."""
    from ..collective import all_gather
    layout = getattr(t, "_dist_layout", None)
    mesh = getattr(t, "_dist_mesh", None)
    out = t.detach()
    if not layout or mesh is None or mesh.coords is None:
        return out
    for dim, axes in sorted(layout.items(), reverse=True):
        for ax in reversed(axes):
            g = mesh.group(ax)
            blocks = list(all_gather(out.contiguous(), group=g).unbind(0))
            order = getattr(g, "coord_ranks", g.ranks)
            blocks = [blocks[g.ranks.index(r)] for r in order]
            out = torch.cat(blocks, dim)
    return out


def reshard(x, process_mesh=None, dims_mapping=None, spec=None):
    """Move a tensor between two distributed layouts (the reference's
    ``Resharder``): gather it whole from the layout it carries (a
    collective of its mesh's ranks; a tensor without one is whole
    already), then keep this rank's block of the target's. The meshes may
    differ in names, shapes and process order. ``spec`` takes a
    partition spec directly, ``dims_mapping`` the reference's ``[-1, 0,
    ...]`` form; neither replicates."""
    mesh, dim_names = _resolve_mesh(process_mesh)
    t = _as_tensor(x)
    full = _gather(t)
    if spec is None:
        spec = _spec_from_dims_mapping(dim_names, dims_mapping, full.dim())
    return _place(t, full, mesh, P(*spec))


def get_mesh():
    return env.get_mesh()
