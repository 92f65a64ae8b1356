"""Activation recompute on ``torch.utils.checkpoint``.

Counterpart of ``paddle_tpu/distributed/fleet/utils/recompute.py``.
:func:`recompute` runs ``function(*args)`` under the non-reentrant
``torch.utils.checkpoint``: the backward keeps the segment's inputs and
runs its forward again. Every parameter the segment reaches gets its
gradient, whether or not an input needs one (the JAX ``jax.checkpoint``
semantics; the reentrant mode would drop them), so ``use_reentrant`` is
accepted and ignored, as in the JAX function.

Seed words: the port's dropouts draw two words per call from the active
``core.random.dropout_generator`` (an explicit CPU generator), which
``preserve_rng_state`` does not cover. :func:`recompute` saves that
generator's state and batch base at entry, and the recomputed forward
draws from a copy of the saved state, so it replays the words, and the
masks, of the first forward; the original generator moves on once.
``jax.checkpoint`` replays the same keys by construction. The port's
``amp.auto_cast`` state is not torch's autocast either: the recomputed
forward runs under the state the first forward saw (the backward runs
outside the loss function's ``auto_cast`` block, and on CUDA on
autograd's own thread).

``policy`` names the JAX selective-remat policies (:data:`_POLICY_NAMES`
and :data:`_POLICY_ALIASES`, ``:29-65``), mapped onto
``torch.utils.checkpoint``'s selective checkpointing:

- ``dots_saveable`` / ``checkpoint_dots`` save the outputs of
  ``aten.mm``, ``aten.addmm`` and ``aten.bmm``;
  ``dots_with_no_batch_dims_saveable`` /
  ``checkpoint_dots_with_no_batch_dims`` those of ``mm`` and ``addmm``;
- ``everything_saveable`` saves every op's output;
- ``nothing_saveable``, ``full`` and None recompute everything.

The hand-written kernels (flash attention, fused dropout, chunked CE)
are not aten ops: a selective policy always recomputes them.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from .... import amp as _amp
from ....core import random as _random

__all__ = ["recompute", "recompute_sequential", "resolve_checkpoint_policy"]

_POLICY_NAMES = (
    "dots_saveable",
    "dots_with_no_batch_dims_saveable",
    "checkpoint_dots",
    "checkpoint_dots_with_no_batch_dims",
    "everything_saveable",
    "nothing_saveable",
)
_POLICY_ALIASES = {
    "save_dots": "dots_saveable",
    "save_dots_no_batch": "dots_with_no_batch_dims_saveable",
    "full": "nothing_saveable",
    "none": "everything_saveable",
}


def _saved_ops(name: str):
    aten = torch.ops.aten
    if name in ("dots_saveable", "checkpoint_dots"):
        return {aten.mm.default, aten.addmm.default, aten.bmm.default}
    if name in ("dots_with_no_batch_dims_saveable",
                "checkpoint_dots_with_no_batch_dims"):
        return {aten.mm.default, aten.addmm.default}
    return None                                  # everything_saveable


def resolve_checkpoint_policy(policy):
    """A policy name, alias, callable or None -> a selective-checkpoint
    policy function ``(ctx, op, *args, **kwargs) -> CheckpointPolicy``,
    or None for full recompute. A callable is returned as it is (a
    ``torch.utils.checkpoint`` policy function). An unknown name raises
    the JAX message."""
    if policy is None or callable(policy):
        return policy
    name = _POLICY_ALIASES.get(str(policy), str(policy))
    if name not in _POLICY_NAMES:
        raise ValueError(
            f"unknown recompute policy {policy!r}; expected one of "
            f"{sorted(_POLICY_NAMES + tuple(_POLICY_ALIASES))} or a "
            "jax.checkpoint_policies callable")
    if name == "nothing_saveable":
        return None
    from torch.utils.checkpoint import CheckpointPolicy
    saved = _saved_ops(name)

    def policy_fn(ctx, op, *args, **kwargs):
        if saved is None or op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    policy_fn.__name__ = name
    return policy_fn


def recompute(function, *args, use_reentrant: bool = True,
              preserve_rng_state: bool = True, policy=None, **kwargs):
    """``function(*args, **kwargs)`` with its activations recomputed in
    the backward (see the module's docstring); ``policy`` selects what
    is saved instead."""
    del use_reentrant                    # parity knob; single behavior
    policy_fn = resolve_checkpoint_policy(policy)
    state = _random.dropout_state()
    amp_on = _amp.is_active()
    calls = [0]

    def run(*a, **kw):
        calls[0] += 1
        if calls[0] == 1:
            return function(*a, **kw)
        with _random.replay_dropout_state(state), \
                _amp.auto_cast(enable=amp_on):
            return function(*a, **kw)

    from torch.utils.checkpoint import checkpoint
    ck = {}
    if policy_fn is not None:
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        ck["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy_fn)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **ck, **kwargs)


class _Segment(torch.nn.Module):
    """A run of layers or callables as one callable."""

    def __init__(self, fns):
        super().__init__()
        self._fns = list(fns)
        for i, f in enumerate(self._fns):
            if isinstance(f, torch.nn.Module):
                self.add_module(str(i), f)

    def forward(self, *xs):
        cur = xs
        for f in self._fns:
            cur = f(*cur) if isinstance(cur, tuple) else f(cur)
        return cur


def recompute_sequential(ctx: Any, functions, *args, **kwargs):
    """Recompute a sequence of layers segment by segment
    (``ctx["segments"]`` of them)."""
    segments = int((ctx or {}).get("segments", 1)) if isinstance(ctx, dict) \
        else int(getattr(ctx, "segments", 1) or 1)
    funcs = list(functions)
    if not funcs:
        return args[0] if len(args) == 1 else args
    seg_size = max(1, (len(funcs) + segments - 1) // segments)
    out = args
    for s in range(0, len(funcs), seg_size):
        seg = _Segment(funcs[s:s + seg_size])
        out = recompute(seg, *(out if isinstance(out, tuple) else (out,)),
                        **kwargs)
    return out
