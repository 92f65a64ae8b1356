"""paddle_tpu_torch.distributed: data and tensor parallelism over
``torch.distributed``.

Counterpart of ``paddle_tpu.distributed``. A rank is a process: NCCL
between cards, gloo on the CPU or when a node's ranks outnumber its
cards (``init_parallel_env``). The collectives take each rank's own
tensor (:mod:`.collective`); the hybrid topology and its groups are
:mod:`.fleet`; :mod:`.spmd` cuts parameters to a rank's block of their
``.spec``; :mod:`.meta_parallel` holds the tensor-parallel layers and
the pipeline (a stage a process: ``PipelineStageStack`` with 1F1B and
fill-drain, ``PipelineParallel`` over a ``PipelineLayer``);
``fleet.meta_optimizers`` LocalSGD; ``fleet.utils.recompute`` is
activation recompute; :mod:`.checkpoint` the single-process commit
protocol. ``spawn`` and ``launch`` start a world. :mod:`.ps` is the
parameter server: host sparse tables, the C++ server with its client and
communicators, and ``DistributedEmbedding``. :mod:`.auto_parallel`
cuts annotated tensors to a rank's block (``ProcessMesh``,
``shard_tensor``, ``shard_op``, ``reshard``); ``fleet.elastic`` is the
restartable training loop, ``fleet.dataset`` the file datasets and
``fleet.utils.fs`` the storage transports.
"""

from . import checkpoint, collective, env, spmd  # noqa: F401
from .collective import (  # noqa: F401
    Group,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_reduce_arrays,
    alltoall,
    barrier,
    broadcast,
    destroy_process_group,
    get_group,
    irecv,
    isend,
    new_group,
    ppermute_shift,
    recv,
    reduce,
    scatter,
    send,
    wait,
)
from .parallel import (  # noqa: F401
    DataParallel,
    ParallelEnv,
    get_rank,
    get_world_size,
    init_parallel_env,
)
from .spmd import apply_param_shardings, make_mesh  # noqa: F401


def __getattr__(name):
    import importlib
    if name in ("fleet", "meta_parallel", "launch", "ps", "auto_parallel"):
        return importlib.import_module(f".{name}", __name__)
    if name == "spawn":
        return importlib.import_module(".spawn_mod", __name__).spawn
    if name == "split":
        from .meta_parallel.parallel_layers.mp_layers import split
        return split
    raise AttributeError(
        f"module 'paddle_tpu_torch.distributed' has no attribute {name!r}")
