"""Optimizer base.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``. Each optimizer
defines the JAX package's per-parameter rule, ``_init_slot(param) ->
slots`` and ``_update(param, grad, slots, lr, t)``, and the base class
applies it in place over every parameter that has a ``.grad``: PyTorch
keeps parameters as mutable tensors, so the update writes into them and
into the slots instead of returning new arrays (the JAX package's buffer
donation, by other means). ``lr`` reaches the rule as a Python float
that holds a float32 value exactly, and ``t`` (the 1-based step) as a
Python int: scalar arithmetic stays on the host, so a step makes no
host-to-device copies and no syncs. ``learning_rate`` may be an
``optimizer.lr.LRScheduler``, as in the JAX package (:55, :74-86): the
rate is then the scheduler's at each update, ``set_lr`` raises, and
``state_dict`` carries the scheduler's state as ``LR_Scheduler``.

Distributed (``TrainStep`` on a mesh sets it, :meth:`set_distributed`):
the gradient clip sums the squares of mp-sharded gradients over the mp
group (of pp-sharded ones over the pp group, of the expert blocks an ep
axis shards over the ep group) and counts a replicated gradient once;
under ZeRO-1 a parameter's
slots hold only the rank's block of its first free dimension that the
ZeRO axis divides (``TrainStep._slot_spec``'s rule), the rule updates
that block of the parameter, and one ``all_gather`` a step (every
parameter's block in one flat buffer) puts the updated blocks back
together on every rank of the ZeRO axis.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..core.tensor import unwrap
from .lr import LRScheduler

__all__ = ["Optimizer"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("pass parameters=model.parameters()")
        self._lr = learning_rate if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        # a facade leaf (``to_tensor(..., stop_gradient=False)``) is
        # updated through its torch tensor
        self._parameter_list: List[torch.nn.Parameter] = unwrap(
            list(parameters))
        self._grad_clip = grad_clip
        # a float weight_decay is the coupled L2 decay g + coeff * p
        self._l2 = float(weight_decay or 0.0)
        self._accumulators: Dict[int, tuple] = {}   # id(param) -> slots
        self._step_count = 0
        # id(param) -> (dim, ZeRO group), ids of mp-sharded parameters,
        # the mp group (set_distributed)
        self._zero: Dict[int, tuple] = {}
        self._mp_sharded: set = set()
        self._mp_group = None
        self._pp_sharded: set = set()
        self._pp_group = None
        self._ep_sharded: set = set()
        self._ep_group = None

    # -- learning rate -------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return float(self._lr())
        return self._lr

    def set_lr(self, value: float) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = float(value)

    # -- the rule (overridden) ----------------------------------------------
    def _init_slot(self, param: torch.Tensor) -> tuple:
        return ()

    def _update(self, param, grad, slots, lr, t) -> None:
        """Update ``param`` and ``slots`` in place."""
        raise NotImplementedError

    # -- distributed ---------------------------------------------------------
    def set_distributed(self, mp_group=None, mp_sharded=(), zero=None,
                        pp_group=None, pp_sharded=(), ep_group=None,
                        ep_sharded=()):
        """Lay the optimizer on a mesh: ``mp_sharded`` the parameters
        mp shards (by object), ``pp_sharded`` those pp shards,
        ``ep_sharded`` the expert blocks ep shards, ``zero`` ``{param:
        (dim, group)}`` the ZeRO-1 layout. Before :meth:`init_state`."""
        self._mp_group = mp_group
        self._mp_sharded = {id(p) for p in mp_sharded}
        self._pp_group = pp_group
        self._pp_sharded = {id(p) for p in pp_sharded}
        self._ep_group = ep_group
        self._ep_sharded = {id(p) for p in ep_sharded}
        self._zero = {id(p): dz for p, dz in (zero or {}).items()}

    def zero_block(self, p: torch.Tensor, t: torch.Tensor = None):
        """The rank's ZeRO block of ``t`` (default: ``p``) as a view, or
        ``t`` when ``p`` has none."""
        t = p if t is None else t
        dz = self._zero.get(id(p))
        if dz is None:
            return t
        dim, group = dz
        n = t.shape[dim] // group.nranks
        return t.narrow(dim, group.rank * n, n)

    @torch.no_grad()
    def _gather_zero(self, params) -> None:
        """Every rank's updated block back into each parameter: one
        all_gather a (group, dtype) of the blocks flattened together."""
        from ..distributed.collective import all_gather
        buckets: Dict[tuple, list] = {}
        for p in params:
            dz = self._zero.get(id(p))
            if dz is not None:
                buckets.setdefault((id(dz[1]), p.dtype), []).append(p)
        for ps in buckets.values():
            group = self._zero[id(ps[0])][1]
            views = [self.zero_block(p) for p in ps]
            flat = torch.cat([v.reshape(-1) for v in views])
            blocks = all_gather(flat, group=group)        # [z, total]
            off = 0
            for p, v in zip(ps, views):
                n = v.numel()
                parts = blocks[:, off:off + n].reshape(
                    (group.nranks,) + tuple(v.shape))
                p.copy_(torch.cat(list(parts.unbind(0)),
                                  self._zero[id(p)][0]))
                off += n

    # -- state -------------------------------------------------------------
    def init_state(self) -> None:
        """Create every parameter's slots now rather than at its first
        update."""
        for p in self._parameter_list:
            self._slots(p)

    def _slots(self, p) -> tuple:
        slots = self._accumulators.get(id(p))
        if slots is None:
            slots = self._accumulators[id(p)] = self._init_slot(
                self.zero_block(p))
        return slots

    @torch.no_grad()
    def step(self, step: Optional[int] = None) -> None:
        """Apply the rule to every parameter with a gradient. ``step`` is
        the 1-based step the bias corrections use; by default the
        optimizer counts its own."""
        live = [p for p in self._parameter_list if p.grad is not None]
        if not live:
            return
        self._step_count = self._step_count + 1 if step is None \
            else int(step)
        grads = {i: p.grad for i, p in enumerate(live)}
        if self._grad_clip is not None:
            grads = self._grad_clip(
                grads, mp_sharded={i for i, p in enumerate(live)
                                   if id(p) in self._mp_sharded},
                mp_group=self._mp_group,
                pp_sharded={i for i, p in enumerate(live)
                            if id(p) in self._pp_sharded},
                pp_group=self._pp_group,
                ep_sharded={i for i, p in enumerate(live)
                            if id(p) in self._ep_sharded},
                ep_group=self._ep_group)
        lr = float(torch.tensor(self.get_lr(), dtype=torch.float32))
        for i, p in enumerate(live):
            g = grads[i] + self._l2 * p if self._l2 else grads[i]
            if id(p) in self._zero:
                # the rank's block of the parameter (a view: the rule's
                # in-place write lands in p) and of its gradient
                self._update(self.zero_block(p), self.zero_block(p, g),
                             self._slots(p), lr, self._step_count)
            else:
                self._update(p, g, self._slots(p), lr, self._step_count)
        if self._zero:
            self._gather_zero(live)

    def clear_grad(self) -> None:
        for p in self._parameter_list:
            p.grad = None

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """Step count and every slot, as CPU tensors keyed
        ``param{i}_slot{j}`` (the JAX package's names), and a scheduler's
        state as ``LR_Scheduler``."""
        out: Dict[str, Any] = {"_step_count": self._step_count}
        for i, p in enumerate(self._parameter_list):
            slots = self._accumulators.get(id(p))
            for j, s in enumerate(slots or ()):
                out[f"param{i}_slot{j}"] = s.detach().cpu().clone()
        if isinstance(self._lr, LRScheduler):
            out["LR_Scheduler"] = self._lr.state_dict()
        return out

    @torch.no_grad()
    def set_state_dict(self, state: Dict[str, Any]) -> None:
        self._step_count = int(state.get("_step_count", 0))
        for i, p in enumerate(self._parameter_list):
            slots = self._slots(p)
            for j, s in enumerate(slots):
                key = f"param{i}_slot{j}"
                if key in state:
                    s.copy_(state[key])
        if "LR_Scheduler" in state and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(state["LR_Scheduler"])
