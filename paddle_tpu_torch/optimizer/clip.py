"""Gradient clipping by the global norm.

Counterpart of ``paddle_tpu/optimizer/clip.py::ClipGradByGlobalNorm``:
it takes and returns a dict of gradients, and the optimizer applies it
before its rule (``grad_clip=``). On an mp mesh the optimizer names the
gradients that mp shards (``mp_sharded``): their squares are summed over
the mp group, and a replicated gradient (the layer norms, ``out_bias``,
``b_out``, the position embeddings) is counted once, so the norm is the
unsharded model's.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads: Dict, mp_sharded=(),
                    mp_group=None) -> torch.Tensor:
        """The float32 L2 norm of every gradient together; the squares of
        the ``mp_sharded`` keys summed over ``mp_group``."""
        if mp_group is None:
            sq = sum(torch.sum(torch.square(g.float()))
                     for g in grads.values())
            return torch.sqrt(sq)
        from ..distributed.collective import all_reduce
        dev = next(iter(grads.values())).device
        sq_sh = torch.zeros((), dtype=torch.float32, device=dev) + sum(
            torch.sum(torch.square(g.float()))
            for k, g in grads.items() if k in mp_sharded)
        sq_rep = sum(torch.sum(torch.square(g.float()))
                     for k, g in grads.items() if k not in mp_sharded)
        return torch.sqrt(all_reduce(sq_sh, group=mp_group) + sq_rep)

    def __call__(self, grads: Dict, mp_sharded=(), mp_group=None) -> Dict:
        gnorm = self.global_norm(grads, mp_sharded, mp_group)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return {k: (g * scale).to(g.dtype) for k, g in grads.items()}
