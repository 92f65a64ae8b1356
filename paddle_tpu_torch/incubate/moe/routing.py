"""MoE routing: capacity-disciplined top-k gating over tensors.

Counterpart of ``paddle_tpu/incubate/moe/routing.py``. One router feeds
both dispatch implementations (:mod:`.dispatch`): the einsum oracle and
the sort path consume the same per-(choice, token) decisions (expert
index, capacity position, keep mask, normalised gate), so capacity
clipping and drop decisions are identical by construction and
``FLAGS_moe_dispatch`` changes only the data movement.

The arithmetic is the JAX function's, in float32, op for op:

- probabilities: softmax over experts of the float32 logits (the router
  is always float32, also under a bfloat16 activation stream);
- top-k: an iterated argmax, the chosen expert masked out each round
  (``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does);
- capacity positions: a running per-expert count in token order,
  choice-major (every first choice takes its slot before any second
  choice), from float cumulative sums of the one-hot masks; a pair whose
  position reaches ``capacity`` is dropped;
- gates: renormalised over the surviving choices (floored at 1e-9);
- aux loss (GShard eq. 4): ``E * sum_e mean_t(top1_e) * mean_t(p_e)``;
- z-loss (ST-MoE): ``mean_t(logsumexp_e(logits)^2)``;
- stats: ``[drop_frac, entropy, balance_frac, load_0..E-1]``.

Every output is float32, the integer-valued ones included.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["Routing", "topk_routing", "top2_gating", "moe_capacity",
           "STATS_FIELDS", "stats_fields"]

#: layout of the per-layer router-stats vector ``Routing.stats``
#: (prefix; followed by the E per-expert load shares): drop_frac = dropped
#: (token, choice) assignments / (T*k); entropy = mean token routing
#: entropy in nats; balance_frac = 1 - total-variation distance of the
#: kept-assignment load from uniform (1.0 = perfectly balanced)
STATS_FIELDS = ("drop_frac", "entropy", "balance_frac")


def stats_fields(num_experts: int):
    """Field names of a stats vector for E experts."""
    return list(STATS_FIELDS) + [f"load_{e}" for e in range(num_experts)]


class Routing(NamedTuple):
    """Per-(choice, token) routing decisions, all float32, choice-major.

    ``gates`` / ``idx`` / ``pos`` / ``keep``: ``[k, T]``; ``aux`` /
    ``z``: scalars; ``stats``: ``[len(STATS_FIELDS) + E]``."""
    gates: torch.Tensor
    idx: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    aux: torch.Tensor
    z: torch.Tensor
    stats: torch.Tensor


def moe_capacity(tokens: int, capacity_factor: float,
                 num_experts: int) -> int:
    """Fixed per-expert capacity: ``ceil(T * cf / E)``, floored at 4."""
    return max(4, int(math.ceil(tokens * capacity_factor / num_experts)))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(idx, n).to(torch.float32)


def topk_routing(logits: torch.Tensor, top_k: int,
                 capacity: int) -> Routing:
    """Route ``logits`` ``[T, E]`` to ``top_k`` experts with fixed
    ``capacity``. Differentiable in ``gates``, ``aux`` and ``z``."""
    T, E = logits.shape
    if not 1 <= top_k <= E:
        raise ValueError(f"top_k={top_k} outside [1, {E}]")
    lf = logits.to(torch.float32)
    probs = torch.softmax(lf, dim=-1)

    masks, idxs = [], []
    p = probs
    for _ in range(top_k):
        idx = torch.argmax(p, dim=-1)                    # [T]
        m = _one_hot(idx, E)                             # [T, E]
        idxs.append(idx)
        masks.append(m)
        p = p * (1.0 - m)

    # capacity positions: token order within each expert, choice-major
    # priority (choice i's tokens claim slots after every choice < i)
    pos_scalar, keeps = [], []
    offset = None                                        # [E] running count
    for m in masks:
        # the running count along the tokens, scanned as the inner axis
        # of the transposed mask (a scan over [T, E]'s outer axis runs
        # E lanes at a time on the card); sums of 0/1 are exact in any
        # order
        base = torch.cumsum(m.t(), dim=1).t() - 1.0
        pm = (base if offset is None else base + offset) * m
        keeps.append(m * (pm < capacity))
        pos_scalar.append(pm.sum(-1))                    # [T]
        offset = m.sum(0) if offset is None else offset + m.sum(0)

    gates = [(probs * kp).sum(-1) for kp in keeps]       # [T] each
    denom = gates[0]
    for g in gates[1:]:
        denom = denom + g
    denom = torch.clamp(denom, min=1e-9)
    gates = [g / denom for g in gates]

    # aux loss (GShard eq. 4) over the top-1 assignment
    frac_tokens = masks[0].mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    # router z-loss (ST-MoE): squared logsumexp of the raw logits
    z = torch.mean(torch.logsumexp(lf, dim=-1) ** 2)

    # routing-health stats (no gradient: telemetry)
    with torch.no_grad():
        kept_e = keeps[0].sum(0)
        for kp in keeps[1:]:
            kept_e = kept_e + kp.sum(0)                  # [E]
        total_kept = kept_e.sum()
        load = kept_e / torch.clamp(total_kept, min=1.0)
        drop_frac = 1.0 - total_kept / float(T * top_k)
        entropy = torch.mean(-torch.sum(probs * torch.log(probs + 1e-9),
                                        dim=-1))
        balance = 1.0 - 0.5 * torch.sum(torch.abs(load - 1.0 / E))
        stats = torch.cat([torch.stack([drop_frac, entropy, balance]),
                           load]).to(torch.float32)

    keep_scalar = [torch.clamp(kp.sum(-1), max=1.0) for kp in keeps]
    return Routing(
        gates=torch.stack(gates).to(torch.float32),
        idx=torch.stack(idxs).to(torch.float32),
        pos=torch.stack(pos_scalar).detach().to(torch.float32),
        keep=torch.stack(keep_scalar).detach().to(torch.float32),
        aux=aux, z=z, stats=stats)


def top2_gating(logits: torch.Tensor, capacity: int):
    """GShard top-2 gating -> ``(combine [T, E, C], dispatch bool [T, E,
    C], aux_loss)``, built from :func:`topk_routing`'s decisions with the
    one-hot arithmetic (``dispatch.combine_tensor``)."""
    from .dispatch import combine_tensor
    r = topk_routing(logits, 2, capacity)
    combine = combine_tensor(r, logits.shape[1], capacity)
    return combine, combine > 0.0, r.aux
