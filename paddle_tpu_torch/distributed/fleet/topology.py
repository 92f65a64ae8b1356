"""Hybrid-parallel topology: rank coordinates and one group per axis.

Counterpart of ``paddle_tpu/distributed/fleet/topology.py``, with its
axis order (``dp, pp, sharding, sp, mp``, outermost first) and its rank
coordinates (``:78-131``): rank ``r`` is the same ``(dp, pp, sharding,
sp, mp)`` coordinate in both packages. There the rank mesh is a
``jax.sharding.Mesh`` and a group a named axis; here it is
``spmd.make_mesh``'s process groups, one per axis slice, and each
getter returns the group that holds this rank.

Every axis runs: data parallelism, ZeRO over ``dp`` or ``sharding``
(beside ``mp`` too), tensor (mp) parallelism, the pipeline over ``pp``,
where a stage is a process: each rank's previous and next stage are the
ranks that share its (dp, sharding, sp, mp) coordinate one pp step away
(:meth:`HybridCommunicateGroup.get_prev_stage_rank`), and the mp
collectives inside a stage run on the mp group of that stage's pp
coordinate; and sequence parallelism over ``sp``
(:meth:`HybridCommunicateGroup.get_sequence_parallel_group`, the group
``ops.ring_attention`` and a ``sequence_parallel`` GPT run over).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from .. import env

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group",
           "MeshTopologyError", "validate_topology"]

# axis order: outermost -> innermost
_AXIS_ORDER = ("dp", "pp", "sharding", "sp", "mp")


class MeshTopologyError(ValueError):
    """The hybrid-parallel degrees do not factor the world."""


def validate_topology(degrees: Dict[str, int], n_devices: int) -> int:
    """The degrees must be >= 1 and their product must divide
    ``n_devices`` (here: ranks); raises :class:`MeshTopologyError`
    naming the configuration, else returns the product."""
    bad = {k: v for k, v in degrees.items() if int(v) < 1}
    if bad:
        raise MeshTopologyError(
            f"hybrid-parallel degrees must be >= 1, got {bad} "
            f"(full config: {dict(degrees)})")
    n = math.prod(int(v) for v in degrees.values()) if degrees else 1
    desc = "x".join(f"{k}{int(v)}" for k, v in degrees.items())
    if n > n_devices:
        raise MeshTopologyError(
            f"mesh {desc} needs {n} ranks, but the world has {n_devices}. "
            "Lower a degree, or start more ranks.")
    if n_devices % n:
        raise MeshTopologyError(
            f"mesh {desc} ({n} ranks) does not factor the {n_devices} "
            f"ranks of the world ({n_devices} % {n} = {n_devices % n}). "
            "Pick degrees whose product divides the world size.")
    return n


class CommunicateTopology:
    """Cartesian rank-coordinate math (row-major, the last axis minor)."""

    def __init__(self, hybrid_group_names: Sequence[str] = _AXIS_ORDER,
                 dims: Sequence[int] = (1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(int(d) for d in dims)
        self._world = math.prod(self._dims)
        coords = list(itertools.product(*(range(d) for d in self._dims)))
        self._coord_of_rank = dict(enumerate(coords))
        self._rank_of_coord = {c: r for r, c in enumerate(coords)}

    def get_hybrid_group_names(self) -> List[str]:
        return list(self._parallel_names)

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world

    def get_rank(self, **axis_coords) -> int:
        coord = tuple(axis_coords[n] for n in self._parallel_names)
        return self._rank_of_coord[coord]

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return self._coord_of_rank[rank]

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """All ranks whose coordinate on ``axis_name`` is ``index``."""
        ax = self._parallel_names.index(axis_name)
        return sorted(r for r, c in self._coord_of_rank.items()
                      if c[ax] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The rank groups that communicate along ``axis_name``: one per
        combination of the other axes' coordinates."""
        ax = self._parallel_names.index(axis_name)
        groups = []
        for combo in itertools.product(
                *(range(self._dims[i]) for i in range(len(self._dims))
                  if i != ax)):
            ranks = []
            for k in range(self._dims[ax]):
                coord = list(combo)
                coord.insert(ax, k)
                ranks.append(self._rank_of_coord[tuple(coord)])
            groups.append(ranks)
        return groups


class HybridCommunicateGroup:
    """The hybrid mesh over the world and one group per axis.

    Builds ``spmd.make_mesh`` over the five axes (every process calls
    it, in the same order) and keeps the groups that hold this rank.
    """

    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 dp_degree: int = 1, mp_degree: int = 1, pp_degree: int = 1,
                 sharding_degree: int = 1, sp_degree: int = 1,
                 devices=None):
        if topology is not None:
            dims = {n: topology.get_dim(n) for n in
                    topology.get_hybrid_group_names()}
            dp_degree = dims.get("dp", 1)
            pp_degree = dims.get("pp", 1)
            sharding_degree = dims.get("sharding", 1)
            sp_degree = dims.get("sp", 1)
            mp_degree = dims.get("mp", 1)
        self._dp_degree = dp_degree
        self._mp_degree = mp_degree
        self._pp_degree = pp_degree
        self._sharding_degree = sharding_degree
        self._sp_degree = sp_degree
        degrees = {"dp": dp_degree, "pp": pp_degree,
                   "sharding": sharding_degree, "sp": sp_degree,
                   "mp": mp_degree}
        world = env.get_world_size() if devices is None else len(devices)
        validate_topology(degrees, world)
        self._topo = CommunicateTopology(_AXIS_ORDER,
                                         tuple(degrees.values()))
        self.nranks = self._topo.world_size()
        from ..spmd import make_mesh
        self.mesh = make_mesh(degrees)
        env.set_mesh(self.mesh)
        self.global_rank = env.get_rank()
        self._groups = {ax: self.mesh.group(ax) for ax in _AXIS_ORDER}

    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_global_rank(self) -> int:
        return self.global_rank

    def _axis_rank(self, ax: str) -> int:
        return self._topo.get_coord(self.global_rank)[_AXIS_ORDER.index(ax)]

    # data parallel
    def get_data_parallel_rank(self) -> int:
        return self._axis_rank("dp")

    def get_data_parallel_world_size(self) -> int:
        return self._dp_degree

    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_data_parallel_group_src_rank(self) -> int:
        return self._groups["dp"].ranks[0]

    # model (tensor) parallel
    def get_model_parallel_rank(self) -> int:
        return self._axis_rank("mp")

    def get_model_parallel_world_size(self) -> int:
        return self._mp_degree

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_model_parallel_group_src_rank(self) -> int:
        return self._groups["mp"].ranks[0]

    # pipeline
    def get_stage_id(self) -> int:
        return self._axis_rank("pp")

    def get_pipe_parallel_world_size(self) -> int:
        return self._pp_degree

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_p2p_groups(self):
        """The stage handoff's channels: this rank's pp group both ways
        (a send or receive names its peer's global rank)."""
        return (self._groups["pp"], self._groups["pp"])

    def get_prev_stage_rank(self) -> Optional[int]:
        """The global rank of the previous stage at this rank's (dp,
        sharding, sp, mp) coordinate; None on the first stage."""
        s = self.get_stage_id()
        return None if s == 0 else self._groups["pp"].ranks[s - 1]

    def get_next_stage_rank(self) -> Optional[int]:
        """The global rank of the next stage; None on the last."""
        s = self.get_stage_id()
        ranks = self._groups["pp"].ranks
        return None if s == len(ranks) - 1 else ranks[s + 1]

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self._pp_degree - 1

    # sharding (ZeRO)
    def get_sharding_parallel_rank(self) -> int:
        return self._axis_rank("sharding")

    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding_degree

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self) -> int:
        return self._groups["sharding"].ranks[0]

    # sequence parallel
    def get_sequence_parallel_rank(self) -> int:
        return self._axis_rank("sp")

    def get_sequence_parallel_world_size(self) -> int:
        return self._sp_degree

    def get_sequence_parallel_group(self):
        return self._groups["sp"]

    def get_parallel_mode(self) -> str:
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding"
        if self._mp_degree > 1:
            return "model"
        if self._dp_degree > 1:
            return "data"
        return "single"


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg: Optional[HybridCommunicateGroup]):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
