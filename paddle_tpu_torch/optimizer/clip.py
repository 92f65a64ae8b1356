"""Gradient clipping by the global norm.

Counterpart of ``paddle_tpu/optimizer/clip.py::ClipGradByGlobalNorm``:
it takes and returns a dict of gradients, and the optimizer applies it
before its rule (``grad_clip=``).
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["ClipGradByGlobalNorm"]


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads: Dict) -> Dict:
        sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return {k: (g * scale).to(g.dtype) for k, g in grads.items()}
