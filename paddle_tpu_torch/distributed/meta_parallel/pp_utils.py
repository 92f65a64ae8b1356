"""The pipeline's stage handoff: activations downstream, their gradients
upstream, point to point.

In the JAX package one controller owns every stage and ``lax.ppermute``
rotates a microbatch's activation over the ``pp`` mesh axis. In the
port a stage is a process: :class:`StageHandoff` carries each
microbatch's boundary tensor from this stage to the next (``send_fwd``
/ ``recv_fwd``) and its gradient back (``send_bwd`` / ``recv_bwd``)
through ``collective.isend`` / ``collective.recv`` on the pp group, so
the ``comm_*`` series count them under that group. Each transfer is
tagged by its microbatch and direction, so two transfers between a pair
can never be matched out of order.

Sends are posted and not waited for (a gloo send completes only once
its receiver has posted the matching receive); receives block. Every
receive of a schedule that follows one timetable on every stage then
matches a send its peer posted earlier, so no stage waits on another
that waits on it. :meth:`StageHandoff.flush` waits for the posted sends
at the end of a schedule. On the gloo backend a CUDA tensor goes through
a pinned host buffer (``collective.p2p_route``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import collective

__all__ = ["StageHandoff"]

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_META_LEN = 8


class StageHandoff:
    """The point-to-point channel of one stage: ``group`` is its pp
    group, ``prev`` / ``next`` the global ranks of its neighbours (None
    at an end)."""

    def __init__(self, group, prev: Optional[int], next: Optional[int]):
        self.group = group
        self.prev = prev
        self.next = next
        self.pending: List[collective.P2PWork] = []
        self.sent = 0
        self.received = 0

    @staticmethod
    def _tag(m: int, backward: bool) -> int:
        return 2 * int(m) + int(backward)

    def _post(self, t: torch.Tensor, dst: int, tag: int) -> None:
        self.pending.append(collective.isend(t.detach(), dst, self.group,
                                             tag=tag))
        self.sent += 1

    def _recv(self, shape, dtype, device, src: int, tag: int):
        out = torch.empty(tuple(shape), dtype=dtype, device=device)
        collective.recv(out, src, self.group, tag=tag)
        self.received += 1
        return out

    def send_fwd(self, t: torch.Tensor, m: int, meta: bool = False) -> None:
        """Microbatch ``m``'s activation to the next stage; ``meta``
        sends its shape and dtype first (the receiver then needs none)."""
        tag = self._tag(m, False)
        if meta:
            if t.dim() > _META_LEN - 2 or t.dtype not in _DTYPES:
                raise ValueError(f"a stage boundary of shape {tuple(t.shape)}"
                                 f" and dtype {t.dtype} cannot be described")
            head = [t.dim(), _DTYPES.index(t.dtype)] + list(t.shape)
            head += [0] * (_META_LEN - len(head))
            self._post(torch.tensor(head, dtype=torch.int64,
                                    device=t.device), self.next,
                       tag + (1 << 20))
        self._post(t.contiguous(), self.next, tag)

    def recv_fwd(self, m: int, shape=None, dtype=None, device=None):
        """Microbatch ``m``'s activation from the previous stage, of
        ``shape`` and ``dtype`` (or as the sender's meta says)."""
        tag = self._tag(m, False)
        if shape is None:
            head = self._recv((_META_LEN,), torch.int64, device,
                              self.prev, tag + (1 << 20)).tolist()
            shape = tuple(head[2:2 + head[0]])
            dtype = _DTYPES[head[1]]
        return self._recv(shape, dtype, device, self.prev, tag)

    def send_bwd(self, g: torch.Tensor, m: int) -> None:
        """The gradient of microbatch ``m``'s input to the previous
        stage."""
        self._post(g.contiguous(), self.prev, self._tag(m, True))

    def recv_bwd(self, m: int, like: torch.Tensor):
        """The gradient of microbatch ``m``'s output (shaped as
        ``like``) from the next stage."""
        return self._recv(like.shape, like.dtype, like.device, self.next,
                          self._tag(m, True))

    def flush(self) -> None:
        """Wait for every posted send."""
        pending, self.pending = self.pending, []
        for w in pending:
            w.wait()

