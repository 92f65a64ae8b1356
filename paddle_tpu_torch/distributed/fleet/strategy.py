"""DistributedStrategy: one config for every parallelism feature.

Counterpart of ``paddle_tpu/distributed/fleet/strategy.py``, with its
fields and defaults: a plain config object over a defaults dict. The
port reads ``hybrid_configs`` (``fleet.init``) and
``gradient_merge`` / ``gradient_merge_configs`` (the snapshot that
``fleet.distributed_optimizer`` attaches, which ``TrainStep`` reads);
``localsgd`` and the pipeline's settings wait for their modules.
"""

from __future__ import annotations

import copy
from typing import Any, Dict


_DEFAULTS: Dict[str, Any] = {
    # hybrid parallelism degrees
    "hybrid_configs": {
        "dp_degree": 1,
        "mp_degree": 1,
        "pp_degree": 1,
        "sharding_degree": 1,
        "sp_degree": 1,
    },
    # AMP (reference: distributed_strategy.proto amp_configs)
    "amp": False,
    "amp_configs": {
        "init_loss_scaling": 32768.0,
        "incr_every_n_steps": 1000,
        "decr_every_n_nan_or_inf": 2,
        "incr_ratio": 2.0,
        "decr_ratio": 0.5,
        "use_pure_fp16": False,
        "use_bf16": True,  # the JAX default
        "custom_white_list": [],
        "custom_black_list": [],
    },
    # recompute (reference: recompute_configs)
    "recompute": False,
    "recompute_configs": {"checkpoints": []},
    # ZeRO-style sharding (reference: sharding_configs)
    "sharding": False,
    "sharding_configs": {"stage": 1, "sharding_degree": 1},
    # pipeline (reference: pipeline_configs)
    "pipeline": False,
    "pipeline_configs": {"accumulate_steps": 1, "micro_batch_size": 1,
                         "schedule_mode": "1F1B"},
    # tensor parallel (reference: tensor_parallel_configs)
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1},
    # gradient merge / accumulation
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    # misc knobs kept for parity
    "find_unused_parameters": False,
    "fuse_all_reduce_ops": True,       # parity no-op
    "fuse_grad_size_in_MB": 32,        # parity no-op
    "nccl_comm_num": 1,                # parity no-op
    "localsgd": False,
    "localsgd_configs": {"k_steps": 1, "begin_step": 1},
    "adaptive_localsgd": False,
    "adaptive_localsgd_configs": {"init_k_steps": 1, "begin_step": 1},
    "dgc": False,
    "lamb": False,
    "lars": False,
    "a_sync": False,
}


class DistributedStrategy:
    """One attribute per field over a copy of the defaults; an unknown
    field raises, a dict field merges."""

    def __init__(self):
        self.__dict__["_config"] = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        cfg = self.__dict__["_config"]
        if name in cfg:
            return cfg[name]
        raise AttributeError(f"DistributedStrategy has no field {name!r}")

    def __setattr__(self, name, value):
        cfg = self.__dict__["_config"]
        if name not in cfg:
            raise AttributeError(f"DistributedStrategy has no field {name!r}")
        if name == "dgc" and value:
            raise NotImplementedError(
                "dgc (deep gradient compression) is not implemented: it "
                "exists to shrink gradient traffic over slow networks; "
                "the JAX package does not implement it either")
        if isinstance(cfg[name], dict) and isinstance(value, dict):
            cfg[name].update(value)
        else:
            cfg[name] = value

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.__dict__["_config"])

    def __repr__(self):
        lines = ["DistributedStrategy("]
        for k, v in self.__dict__["_config"].items():
            lines.append(f"  {k}={v!r},")
        lines.append(")")
        return "\n".join(lines)
