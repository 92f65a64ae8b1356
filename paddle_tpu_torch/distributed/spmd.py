"""The mesh, partition specs and parameter shardings of the port.

Counterpart of ``paddle_tpu/distributed/spmd.py``. The JAX package lays
one ``jax.sharding.Mesh`` over the chips and lets GSPMD partition each
program by the arrays' ``PartitionSpec``s. The port runs one process
per rank: a :class:`Mesh` is this rank's coordinates on named axes and
one ``torch.distributed`` group per axis (the ranks that differ from
this one on that axis only), and :func:`apply_param_shardings` cuts
each parameter in place to this rank's slice of its ``.spec``, as the
JAX ``device_put`` lays it out. The model's own modules then insert the
collectives GSPMD would (``meta_parallel.parallel_layers.mp_layers``):
a module that defines ``_on_mesh(mesh)`` is told the mesh after its
parameters were cut.

:class:`P` is the port's own ``PartitionSpec`` (a tuple of axis names,
tuples of names or None per dimension). Rank coordinates and axis order
are the JAX package's (``fleet.topology``): rank ``r`` holds the same
slice of every parameter in both packages.

Not ported, and why: ``constrain`` and ``shard_map`` are directives to
the XLA compiler (a layout pin, a manual-SPMD region); an eager rank
has no compiler to direct, and the modules' collectives take their
place (and with ``constrain`` its ``BATCH`` sentinel).

Tensor-parallel serving: :data:`SERVE_KV_SPEC` shards a paged K/V pool
``[L, P, bs, H, D]`` over its heads on ``mp`` (and an int8 cache's
``[L, P, bs, H]`` scale pools the same way), so an mp rank holds
``H/mp`` heads of every page; :func:`shard_serving_cache` cuts a whole
cache to that block, and :func:`serving_heads` says which heads a rank
holds. Pages and block tables stay whole: a page holds every head.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from . import env

__all__ = ["P", "PartitionSpec", "Mesh", "make_mesh", "current_mesh",
           "data_axes", "degrade_spec", "apply_param_shardings",
           "apply_hybrid_specs", "shard_layout", "shard_tensor", "cut_block",
           "gather_tensor", "mesh_slice", "loss_average_groups",
           "loss_sum_groups", "count_over_data", "SERVE_KV_SPEC",
           "serving_heads", "shard_serving_cache"]

_DATA_AXES = ("dp", "sharding")


class P(tuple):
    """``PartitionSpec(*entries)``: per dimension an axis name, a tuple
    of axis names (major first) or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


PartitionSpec = P


class Mesh:
    """This rank's place on named axes: ``axis_names`` (outermost
    first), ``shape`` (name -> size), the rank's coordinate on each axis
    (:meth:`axis_rank`) and one group per axis (:meth:`group`: the
    ranks that share every other coordinate). Rank ``r`` of the world
    sits at the row-major coordinate of ``r`` (the last axis minor)."""

    def __init__(self, axis_sizes: Dict[str, int], groups: Dict[str, object],
                 coords: Optional[Tuple[int, ...]]):
        self.axis_names = tuple(axis_sizes)
        self.shape = dict(axis_sizes)
        self._groups = groups
        self.coords = coords

    def group(self, axis: str):
        return self._groups[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        if axis not in self.shape:
            return 0
        return self.coords[self.axis_names.index(axis)]

    def __repr__(self):
        return f"Mesh({self.shape}, coords={self.coords})"


def make_mesh(axis_sizes: Dict[str, int], devices=None) -> Mesh:
    """A mesh over the first ``prod(axis_sizes)`` ranks of the world
    (``devices`` is accepted for the JAX signature; a rank is a device
    here). Every process must call it, in the same order: it creates
    one process group per axis slice (none for an axis of size 1)."""
    from .collective import Group, new_group
    from .fleet.topology import CommunicateTopology
    names = tuple(axis_sizes)
    sizes = tuple(int(v) for v in axis_sizes.values())
    n = math.prod(sizes)
    world = env.get_world_size()
    if n > world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n} ranks, the "
                         f"world has {world}")
    topo = CommunicateTopology(names, sizes)
    rank = env.get_rank()
    coords = topo.get_coord(rank) if rank < n else None
    groups = {}
    for ax, size in zip(names, sizes):
        mine = None
        for ranks in topo.get_comm_list(ax):
            if size > 1:
                g = new_group(ranks, axis_name=ax)
            else:
                g = Group(ranks, -1, axis_name=ax)
            if rank in ranks:
                mine = g
        groups[ax] = mine
    return Mesh(dict(zip(names, sizes)), groups, coords)


def current_mesh() -> Optional[Mesh]:
    return env.get_mesh()


_LOSS_SCOPE = threading.local()


@contextlib.contextmanager
def loss_average_groups(groups: Sequence,
                        sum_groups: Sequence = ()) -> Iterator[None]:
    """The loss computed inside this block is averaged over ``groups``
    once it returns (a data-parallel ``TrainStep``'s data axes, each
    rank holding an equal block of the global batch) and summed over
    ``sum_groups`` (the sp group of a sequence-parallel step, each rank
    holding a shard of every row): a criterion that divides by a count
    of its own positions (a masked mean) takes that count over every
    rank (:func:`count_over_data`), so the result is the global batch's
    mean, as the JAX mesh step computes it over the whole array."""
    stack = _LOSS_SCOPE.__dict__.setdefault("stack", [])
    stack.append((tuple(groups), tuple(sum_groups)))
    try:
        yield
    finally:
        stack.pop()


def _loss_scope():
    stack = _LOSS_SCOPE.__dict__.get("stack")
    return stack[-1] if stack else ((), ())


def loss_sum_groups() -> Tuple:
    """The active :func:`loss_average_groups`' ``sum_groups``."""
    return _loss_scope()[1]


def count_over_data(count: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``count`` (taken over this rank's positions) summed over the
    active :func:`loss_average_groups` (both kinds), and the number of
    ranks the loss is averaged over; ``(count, 1)`` outside of one."""
    groups, sums = _loss_scope()
    if not groups and not sums:
        return count, 1
    from .collective import all_reduce
    count = count.detach().clone()
    n = 1
    for g in groups:
        all_reduce(count, group=g)
        n *= g.nranks
    for g in sums:
        all_reduce(count, group=g)
    return count, n


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes the batch dim is sharded over (dp + ZeRO
    sharding) whose ranks replicate every parameter; never ``pp``, whose
    stages all see the same rows. An ``ep`` axis also cuts the batch
    (``data_spec=P("ep")``), but its ranks hold different experts:
    ``TrainStep`` averages the loss over it and treats the gradients
    apart."""
    return tuple(a for a in _DATA_AXES if a in mesh.axis_names)


def _degrade_entry(s, names):
    if isinstance(s, str):
        return s if s in names else None
    if isinstance(s, (tuple, list)):
        kept = tuple(a for a in s if a in names)
        return kept if kept else None
    return s


def degrade_spec(spec, mesh: Mesh) -> P:
    """``spec`` with the axes that ``mesh`` lacks degraded to replicated,
    the JAX rule: a model annotated for mp composes with any mesh."""
    names = set(mesh.axis_names)
    return P(*(_degrade_entry(s, names) for s in tuple(spec)))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_slice(mesh: Mesh, entry, length: int) -> Tuple[int, int]:
    """``(start, size)`` of this rank's block of a dimension of
    ``length`` sharded over ``entry``'s axes (row-major over a tuple)."""
    axes = _axes(entry)
    n = math.prod(mesh.axis_size(a) for a in axes)
    if n == 1:
        return 0, length
    if length % n:
        raise ValueError(f"a dimension of {length} does not split over "
                         f"{axes} ({n} ranks)")
    idx = 0
    for a in axes:
        idx = idx * mesh.axis_size(a) + mesh.axis_rank(a)
    size = length // n
    return idx * size, size


def shard_layout(spec, shape: Sequence[int], mesh: Mesh) -> Dict[int, tuple]:
    """``{dim: axes}`` for each dimension of ``shape`` that ``spec``
    shards over mesh axes of more than one rank."""
    spec = degrade_spec(spec, mesh)
    out = {}
    for i, (entry, _) in enumerate(zip(tuple(spec), shape)):
        axes = tuple(a for a in _axes(entry) if mesh.axis_size(a) > 1)
        if axes:
            out[i] = axes
    return out


def shard_tensor(full: torch.Tensor, layout: Dict[int, tuple],
                 mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``layout`` (a view)."""
    out = full
    for dim, axes in layout.items():
        start, size = mesh_slice(mesh, axes, full.shape[dim])
        out = out.narrow(dim, start, size)
    return out


def cut_block(full: torch.Tensor, layout: Dict[int, tuple], mesh: Mesh,
              zero=None) -> torch.Tensor:
    """This rank's block of ``full`` (contiguous): cut by ``layout``
    (:func:`shard_tensor`), then narrowed over ``zero``, a ZeRO ``(dim,
    group)`` (None: none). A step's state and a checkpoint's leaves are
    cut by it."""
    t = shard_tensor(full, layout, mesh) if layout else full
    if zero is not None:
        dim, group = zero
        n = t.shape[dim] // group.nranks
        t = t.narrow(dim, group.rank * n, n)
    return t.contiguous()


def gather_tensor(local: torch.Tensor, layout: Dict[int, tuple],
                  mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's block (a collective over each
    sharded dimension's axis groups; every rank of the groups calls it).
    A dimension sharded over a tuple of axes is gathered over the inner
    axis first: its blocks are laid out with the outer axis major, as
    :func:`mesh_slice` cuts them (the JAX ``P(("dp", "sharding"))``)."""
    from .collective import all_gather
    out = local
    for dim, axes in sorted(layout.items(), reverse=True):
        for ax in reversed(axes):
            blocks = all_gather(out.contiguous(), group=mesh.group(ax))
            out = torch.cat(list(blocks.unbind(0)), dim)
    return out


@torch.no_grad()
def apply_param_shardings(layer, mesh: Optional[Mesh] = None):
    """Cut every parameter of ``layer`` that carries a ``.spec`` to this
    rank's block, in place (the Parameter objects stay, so an optimizer
    built before keeps them), recording ``p._dist_layout`` (``{dim:
    axes}``) and ``p._full_shape``; then call ``_on_mesh(mesh)`` on
    every module that defines it. Idempotent. Returns ``layer``."""
    mesh = mesh or env.get_mesh()
    if mesh is None:
        raise ValueError("no active mesh; call fleet.init or pass mesh=")
    for _, p in layer.named_parameters():
        if hasattr(p, "_dist_layout"):
            continue
        spec = getattr(p, "spec", None) or P()
        layout = shard_layout(spec, p.shape, mesh)
        p._full_shape = tuple(p.shape)
        p._dist_layout = layout
        if layout:
            p.data = shard_tensor(p.data, layout, mesh).contiguous().clone()
    for m in layer.modules():
        hook = getattr(m, "_on_mesh", None)
        if hook is not None:
            hook(mesh)
    return layer


_TP_COLUMN = ("q_proj.weight", "k_proj.weight", "v_proj.weight",
              "linear1.weight")
_TP_ROW = ("out_proj.weight", "linear2.weight")
_TP_COLUMN_BIAS = ("q_proj.bias", "k_proj.bias", "v_proj.bias",
                   "linear1.bias")
_VOCAB = ("word_embeddings.weight",)


def apply_hybrid_specs(layer, mp_axis: str = "mp"):
    """Stamp the Megatron-style specs on a model built from
    ``nn.MultiHeadAttention`` / ``TransformerEncoder`` by parameter name,
    as the JAX function does (column-parallel q/k/v and ffn in-proj,
    row-parallel out-projections, vocab-sharded word embeddings,
    everything else replicated). The specs only: a model of the port
    runs them once its modules insert the collectives, which
    ``models.gpt`` does and the encoder layers do not yet."""
    for name, p in layer.named_parameters():
        if getattr(p, "spec", None) not in (None, P()):
            continue
        if name.endswith(_VOCAB):
            p.spec = P(mp_axis, None)
        elif name.endswith(_TP_COLUMN):
            p.spec = P(None, mp_axis)
        elif name.endswith(_TP_ROW):
            p.spec = P(mp_axis, None)
        elif name.endswith(_TP_COLUMN_BIAS):
            p.spec = P(mp_axis)
        else:
            p.spec = P()
    return layer


#: layout of a serving paged K/V pool ``[L, P, bs, H, D]`` under tensor
#: parallelism: heads over ``mp``, the split the model's q/k/v heads
#: take (``qkv_weight`` P(None, None, 'mp', None)), so a rank writes and
#: reads its own heads with no collective; layers, pages and the
#: positions of a page stay whole (the host block tables index them)
SERVE_KV_SPEC = P(None, None, None, "mp", None)


def serving_heads(num_heads: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """``(first head, heads)`` of this rank's block of a serving cache's
    ``num_heads`` under :data:`SERVE_KV_SPEC` (all of them without a
    mesh, or on a mesh without an mp axis: the JAX ``degrade_spec``
    rule)."""
    if mesh is None:
        return 0, int(num_heads)
    return mesh_slice(mesh, degrade_spec(SERVE_KV_SPEC, mesh)[3],
                      int(num_heads))


@torch.no_grad()
def shard_serving_cache(cache, mesh: Mesh):
    """Cut a serving ``PagedKVCache``'s pools to this rank's heads under
    :data:`SERVE_KV_SPEC` (an int8 cache's ``[L, P, bs, H]`` scale pools
    on the same dimension), in place on the cache object, so a rank's
    device memory holds ``1/mp`` of the K/V. A cache built for a mesh
    (``PagedKVCache(..., mesh=)``, as the engine builds it) or cut
    before is returned as it is. Returns ``cache``."""
    if cache.head_block is not None:
        return cache
    h0, n = serving_heads(cache.num_heads, mesh)
    cache.head_block = (h0, n, cache.num_heads)
    if n == cache.num_heads:
        return cache
    cut = lambda t: None if t is None else \
        t.narrow(3, h0, n).contiguous().clone()      # noqa: E731
    cache.k, cache.v = cut(cache.k), cut(cache.v)
    cache.k_scale, cache.v_scale = cut(cache.k_scale), cut(cache.v_scale)
    cache.num_heads = n
    return cache
