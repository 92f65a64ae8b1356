"""The ranks of a tensor-parallel serving engine in lockstep.

The JAX engine on a mesh is one controller: it makes each host decision
once and GSPMD runs the programs on every chip. The port runs one
:class:`~.engine.ServingEngine` a rank of the mp group, and every
forward runs collectives over that group, so the ranks must admit,
preempt, end and sample alike, in the same order, or the next
collective hangs or mixes two steps. The decisions that read a clock
(deadline expiry, the overload EWMA, the drain budget) or a random
stream (sampling) could split them, so mp rank 0, the leader, makes
them and the other ranks, the followers, take them from it over the mp
group, a few integers a step:

- at each iteration boundary, one message (:meth:`Lockstep.boundary`):
  whether the leader drains now, every request the leader ended since
  the last boundary and how (expired, cancelled, shed, failed,
  completed), the leader's overload detector, the ids it admitted
  with their slots and admission stamps, in order, and its queue
  afterwards, which a follower's queue must equal;
- before a decode or verify dispatch, the ids the leader preempted
  (:meth:`Lockstep.preemptions`);
- after each dispatch, the sampled tokens and their finiteness (a
  verify window's acceptance draws too);
- in a drain, whether the leader's budget runs on, and the snapshot's
  path (the leader alone writes it).

A follower applies what it is given and raises :class:`LockstepError`
where its own state cannot take it (a request it does not hold, a slot
or a page it lacks, a queue that differs): a divergence is an error,
never a silent split. A follower's scheduler decides nothing by itself
(``Scheduler(follower=True)``): its expiry and cancel sweeps wait for
the leader, and a cancel it is given only latches. The messages are
pickled and broadcast as CPU tensors through ``distributed.collective``
(one broadcast a message unless it outgrows ``HEAD`` bytes),
so each runs under ``FLAGS_collective_timeout_s`` and a rank that stops
answering raises ``CollectiveTimeoutError`` instead of hanging.
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Lockstep", "LockstepError"]

#: bytes of a message's first broadcast: a step's boundary, preemption
#: and token messages fit in it, so each costs one collective
HEAD = 4096


class LockstepError(RuntimeError):
    """A follower's state cannot take the leader's decision."""


class Lockstep:
    """The leader's decisions, held by every rank of ``group`` (an mp
    :class:`~paddle_tpu_torch.distributed.collective.Group`)."""

    def __init__(self, group):
        self.group = group
        self.leader = group.rank == 0
        self._src = group.ranks[0]
        #: ``(request id, outcome)`` of every request the leader ended
        #: since its last boundary message
        self.ended: List[Tuple[int, str]] = []
        #: messages shared so far
        self.messages = 0

    # -- transport -----------------------------------------------------------
    def share(self, obj: Any = None) -> Any:
        """The leader's ``obj`` on every rank: one broadcast of a
        ``HEAD``-byte buffer (the pickle's length, then its first bytes),
        and a second of the rest when the pickle does not fit."""
        from ..distributed.collective import broadcast
        self.messages += 1
        head = torch.zeros(HEAD, dtype=torch.uint8)
        if self.leader:
            data = np.frombuffer(pickle.dumps(obj, protocol=4), np.uint8)
            head[:8] = torch.from_numpy(
                np.array([data.size], np.int64).view(np.uint8))
            first = min(data.size, HEAD - 8)
            head[8:8 + first] = torch.from_numpy(data[:first].copy())
        broadcast(head, src=self._src, group=self.group)
        if self.leader:
            if data.size > HEAD - 8:
                broadcast(torch.from_numpy(data[HEAD - 8:].copy()),
                          src=self._src, group=self.group)
            return obj
        n = int(head[:8].numpy().view(np.int64)[0])
        data = head[8:8 + min(n, HEAD - 8)].numpy().tobytes()
        if n > HEAD - 8:
            rest = torch.empty(n - (HEAD - 8), dtype=torch.uint8)
            broadcast(rest, src=self._src, group=self.group)
            data += rest.numpy().tobytes()
        return pickle.loads(data)

    def record(self, request_id: int, outcome: str) -> None:
        if self.leader:
            self.ended.append((int(request_id), outcome))

    def take_ended(self) -> List[Tuple[int, str]]:
        out, self.ended = self.ended, []
        return out

    # -- the boundary ----------------------------------------------------------
    def boundary(self, engine, drain: bool,
                 admitted: Optional[list] = None) -> bool:
        """The leader's boundary message, sent (leader) or applied
        (follower); returns whether the engine drains now."""
        sched = engine.scheduler
        if self.leader:
            det = engine._overload
            self.share({
                "drain": bool(drain), "ended": self.take_ended(),
                "overload": None if det is None
                else (det.overloaded, det.ewma_s),
                "admitted": [(st.request.request_id, st.slot,
                              st.admitted_t) for st in admitted or ()],
                "waiting": [st.request.request_id for st in sched.waiting]})
            return bool(drain)
        msg = self.share()
        self.apply_ended(sched, msg["ended"])
        det = engine._overload
        if det is not None and msg["overload"] is not None:
            was = det.overloaded
            det.overloaded, det.ewma_s = msg["overload"]
            if det.overloaded != was:
                engine._overload_transition(
                    "enter" if det.overloaded else "exit")
        for rid, slot, t in msg["admitted"]:
            sched.admit_as(rid, slot, t)
        mine = [st.request.request_id for st in sched.waiting]
        if mine != msg["waiting"]:
            raise LockstepError(
                f"mp rank {self.group.rank}'s queue {mine} differs from "
                f"the leader's {msg['waiting']}: the ranks were not given "
                "the same submits in the same order")
        return bool(msg["drain"])

    def sync_ended(self, sched) -> None:
        """Every rank ends what the leader ended since its last message."""
        ended = self.share(self.take_ended() if self.leader else None)
        if not self.leader:
            self.apply_ended(sched, ended)

    def apply_ended(self, sched, ended) -> None:
        for rid, outcome in ended:
            st = sched.find(rid)
            if st is None or st.outcome == outcome:
                continue          # never queued here, or ended alike
            if st.outcome is not None:
                raise LockstepError(
                    f"request {rid} ended {st.outcome!r} on mp rank "
                    f"{self.group.rank} but {outcome!r} on the leader")
            sched.end_as(st, outcome)

    def preemptions(self, sched, preempted) -> List:
        """The leader's preempted states (leader), or the follower's
        after it preempted the leader's ids and grew every slot."""
        if self.leader:
            self.share([st.request.request_id for st in preempted])
            return list(preempted)
        return sched.apply_preemptions(self.share())
