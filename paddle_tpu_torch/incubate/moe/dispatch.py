"""MoE dispatch and combine: the einsum oracle and the sort path.

Counterpart of ``paddle_tpu/incubate/moe/dispatch.py``: two
implementations of the same data movement, tokens to per-expert capacity
slices ``[E, C, D]`` and back, selected by ``FLAGS_moe_dispatch``:

``einsum`` (the GShard formulation, the parity oracle):
    ``einsum('tec,td->ecd')`` over the one-hot ``[T, E, C]`` dispatch
    mask and ``einsum('tec,ecd->td')`` over the weighted combine mask;
    both stream O(T*E*C) tensors.

``sort`` (default): the (token, choice) pairs flattened choice-major,
    ``torch.argsort(stable=True)`` by destination slot so the writes
    group by expert (dropped pairs, at the drop bucket ``E*C``, sort
    last), one scatter into an ``[E*C + 1, D]`` buffer whose drop-bucket
    row is sliced off (so the duplicate writes there carry no
    gradient), and one gather back through the flat slot map. O(T*k*D)
    data whatever E and C.

The sort path's gathers are ``torch.index_select``, whose backward
adds rows (``index_add_``) where an indexing gather's sorts its indices
first: a kept slot takes one gradient row, a token at most ``k`` (its
dropped pairs' rows come back zero), so at ``k <= 2`` the sums do not
depend on the order the card adds them in.

Both consume one :class:`~.routing.Routing`, so their drop decisions
are the same. Kept slots are unique, so the dispatches agree exactly;
the combines sum the same k products in the sort path's order and, in
the einsum, inside a matmul (on the card its fused multiply-adds may
round the sum of two products differently in the last bit).
"""

from __future__ import annotations

import torch

from ...core.flags import get_flag

__all__ = ["DISPATCH_MODES", "resolve_dispatch_mode", "combine_tensor",
           "einsum_dispatch", "einsum_combine", "sort_dispatch",
           "sort_combine", "dispatch_slots"]

DISPATCH_MODES = ("sort", "einsum")


def resolve_dispatch_mode(explicit=None) -> str:
    """``FLAGS_moe_dispatch`` unless a layer-level override is given."""
    mode = str(explicit or get_flag("moe_dispatch") or "sort").lower()
    if mode not in DISPATCH_MODES:
        raise ValueError(
            f"unknown MoE dispatch mode {mode!r}; expected one of "
            f"{DISPATCH_MODES} (FLAGS_moe_dispatch)")
    return mode


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside ``[0, n)`` (a dropped pair's
    position) gives a row of zeros."""
    return (idx.long()[:, None] == torch.arange(n, device=idx.device)
            ).to(torch.float32)


# ---------------------------------------------------------------------------
# einsum path (oracle)
# ---------------------------------------------------------------------------

def combine_tensor(r, num_experts: int, capacity: int) -> torch.Tensor:
    """The GShard combine weights ``[T, E, C]`` from routing decisions:
    ``g_i * keep_i * loc_i`` summed over the choices."""
    k = r.gates.shape[0]
    out = None
    for i in range(k):
        m = _one_hot(r.idx[i], num_experts)
        keep_full = m * r.keep[i][:, None]
        loc = _one_hot(r.pos[i], capacity)
        term = (r.gates[i][:, None, None] * keep_full[:, :, None]
                * loc[:, None, :])
        out = term if out is None else out + term
    return out


def einsum_dispatch(x, r, num_experts: int, capacity: int):
    """``x`` ``[T, D]`` -> expert inputs ``[E, C, D]`` by the one-hot
    einsum."""
    with torch.no_grad():
        dispatch = combine_tensor(r, num_experts, capacity) > 0.0
    return torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)


def einsum_combine(expert_out, r, capacity: int):
    """Expert outputs ``[E, C, D]`` -> ``y`` ``[T, D]`` by the weighted
    einsum."""
    combine = combine_tensor(r, expert_out.shape[0], capacity)
    return torch.einsum("tec,ecd->td", combine.to(expert_out.dtype),
                        expert_out)


# ---------------------------------------------------------------------------
# sort path
# ---------------------------------------------------------------------------

def dispatch_slots(r, num_experts: int, capacity: int):
    """Flat per-(choice, token) destination slots, choice-major:
    ``(slot [k*T] int64, gate [k*T] f32, tok [k*T] int64)``, ``slot =
    expert * C + position`` for a kept pair and ``E*C`` (the drop
    bucket) otherwise."""
    k, T = r.idx.shape
    E, C = num_experts, capacity
    idx = r.idx.reshape(k * T).long()
    pos = r.pos.reshape(k * T).long()
    keep = r.keep.reshape(k * T) > 0.0
    gate = r.gates.reshape(k * T) * r.keep.reshape(k * T)
    slot = torch.where(keep, idx * C + pos, torch.full_like(idx, E * C))
    tok = torch.arange(T, device=idx.device).repeat(k)
    return slot, gate.to(torch.float32), tok


def sort_dispatch(x, r, num_experts: int, capacity: int):
    """``x`` ``[T, D]`` -> expert inputs ``[E, C, D]``: argsort by slot
    and one scatter; dropped pairs land in the trailing drop-bucket row,
    which is sliced off."""
    E, C = num_experts, capacity
    slot, _, tok = dispatch_slots(r, E, C)
    # group writes by destination expert (dropped pairs sort last); the
    # stable order keeps the router's choice-major token order
    order = torch.argsort(slot, stable=True)
    buf = x.new_zeros((E * C + 1, x.shape[1]))
    buf = buf.index_copy(0, slot[order],
                         torch.index_select(x, 0, tok[order]))
    return buf[:E * C].reshape(E, C, x.shape[1])


def sort_combine(expert_out, r, capacity: int):
    """Expert outputs ``[E, C, D]`` -> ``y`` ``[T, D]``: one gather a
    (choice, token) pair through the flat slot map, gate-weighted,
    summed over the choices. Dropped pairs gather the zero drop-bucket
    row."""
    E, C, D = expert_out.shape
    k, T = r.idx.shape
    slot, gate, _ = dispatch_slots(r, E, C)
    flat = torch.cat([expert_out.reshape(E * C, D),
                      expert_out.new_zeros((1, D))])
    picked = torch.index_select(flat, 0, slot) * \
        gate[:, None].to(expert_out.dtype)
    return picked.reshape(k, T, D).sum(0)
