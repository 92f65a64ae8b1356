"""Gradient clipping by the global norm.

Counterpart of ``paddle_tpu/optimizer/clip.py::ClipGradByGlobalNorm``:
it takes and returns a dict of gradients, and the optimizer applies it
before its rule (``grad_clip=``). On an mp mesh the optimizer names the
gradients that mp shards (``mp_sharded``): their squares are summed over
the mp group, and a replicated gradient (the layer norms, ``out_bias``,
``b_out``, the position embeddings) is counted once, so the norm is the
unsharded model's. Under a pipeline the blocks that pp shards
(``pp_sharded``) are summed over the pp group the same way, and the
expert blocks an ep axis shards (``ep_sharded``) over the ep group.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads: Dict, mp_sharded=(),
                    mp_group=None, pp_sharded=(),
                    pp_group=None, ep_sharded=(),
                    ep_group=None) -> torch.Tensor:
        """The float32 L2 norm of every gradient together: four partial
        sums of squares by (mp-sharded, pp-sharded); the mp-sharded pair
        summed over ``mp_group``, then the pp-sharded sum over
        ``pp_group``; the expert blocks an ep axis shards
        (``ep_sharded``, never mp- or pp-sharded: an MoE model refuses
        those axes) in a fifth sum over ``ep_group``. Without a group
        its sums stay the rank's own."""
        from ..distributed.collective import all_reduce
        dev = next(iter(grads.values())).device
        acc = torch.zeros(5, dtype=torch.float32, device=dev)
        for k, g in grads.items():
            i = 4 if k in ep_sharded else \
                2 * (k in mp_sharded) + (k in pp_sharded)
            acc[i] += torch.sum(torch.square(g.float()))
        mp_part = acc[2:4].clone()
        if mp_group is not None:
            all_reduce(mp_part, group=mp_group)
        pp_part = (acc[1] + mp_part[1]).reshape(1)
        if pp_group is not None:
            all_reduce(pp_part, group=pp_group)
        ep_part = acc[4:5].clone()
        if ep_group is not None:
            all_reduce(ep_part, group=ep_group)
        return torch.sqrt(acc[0] + mp_part[0] + pp_part[0] + ep_part[0])

    def __call__(self, grads: Dict, mp_sharded=(), mp_group=None,
                 pp_sharded=(), pp_group=None, ep_sharded=(),
                 ep_group=None) -> Dict:
        gnorm = self.global_norm(grads, mp_sharded, mp_group, pp_sharded,
                                 pp_group, ep_sharded, ep_group)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return {k: (g * scale).to(g.dtype) for k, g in grads.items()}
