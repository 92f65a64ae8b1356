"""Mixture-of-Experts, PyTorch port of ``paddle_tpu/incubate/moe``.

- ``routing``: the capacity-disciplined top-k router (float32), aux and
  z losses, routing-health stats;
- ``dispatch``: the einsum oracle and the sort path, selected by
  ``FLAGS_moe_dispatch``;
- ``layer``: :class:`ExpertFFN` / :class:`MoELayer`, the explicit
  expert-parallel program over an ``ep`` mesh axis (one process a
  rank, a differentiable all-to-all in capacity chunks,
  ``FLAGS_moe_expert_parallel``, ``FLAGS_moe_a2a_chunks``), the router
  telemetry and the reference-parity ``global_scatter`` /
  ``global_gather``.

Routing, dispatch, combine and the expert products are XLA ops in the
JAX package, not Pallas kernels; here they are torch ops.
"""

from .dispatch import (DISPATCH_MODES, combine_tensor, dispatch_slots,
                       einsum_combine, einsum_dispatch,
                       resolve_dispatch_mode, sort_combine, sort_dispatch)
from .layer import (EP_AXIS, MOE_STATS, ExpertFFN, MoELayer,
                    expert_ffn_apply, global_gather, global_scatter,
                    moe_ep_group, note_moe_fallback, publish_router_stats,
                    reset_moe_stats, resolve_a2a_chunks)
from .routing import (Routing, STATS_FIELDS, moe_capacity, stats_fields,
                      top2_gating, topk_routing)

__all__ = [
    "EP_AXIS", "MOE_STATS", "ExpertFFN", "MoELayer", "Routing",
    "STATS_FIELDS", "DISPATCH_MODES", "combine_tensor", "dispatch_slots",
    "einsum_combine", "einsum_dispatch", "expert_ffn_apply",
    "global_gather", "global_scatter", "moe_capacity", "moe_ep_group",
    "note_moe_fallback", "publish_router_stats", "reset_moe_stats",
    "resolve_a2a_chunks", "resolve_dispatch_mode", "sort_combine",
    "sort_dispatch", "stats_fields", "top2_gating", "topk_routing",
]
