"""The pipeline over stage processes: schedules and the stacked stage.

Counterpart of ``paddle_tpu/distributed/meta_parallel/spmd_pipeline.py``.
The JAX package runs every stage in one SPMD program: the stack's
parameters are stacked ``[L, ...]`` and sharded over the ``pp`` mesh
axis, a ``lax.scan`` over slots advances the stages in lockstep and
``lax.ppermute`` moves activations (down) and cotangents (up) between
them. In the port a stage is a process. :class:`PipelineStageStack`
keeps the JAX parameters, names and layouts (``stacked__<template name
with . as __>`` of shape ``[L, ...]``, spec ``P("pp", *template_spec)``,
so ``apply_param_shardings`` leaves each rank the layers ``[s*L/S,
(s+1)*L/S)`` as a block on dim 0), and each rank runs a host-side
schedule over its own layers, handing each microbatch's activation to
the next stage and its gradient to the previous one point to point
(``pp_utils.StageHandoff``).

Two schedules share that layout (:func:`resolve_schedule`: the
``FLAGS_pipeline_schedule`` override, then the stack's own, then the
fleet strategy's ``pipeline_configs['schedule_mode']``, then ``1f1b``):

- ``fill_drain``: every microbatch's forward, then every backward;
- ``1f1b``: each stage runs its forwards and backwards in the order of
  the JAX timetable (:func:`schedule_timetable`: forward of microbatch
  ``(t - s)/2`` and backward of ``(t - (2S-1-s))/2`` at slot ``t``), so
  at most ``S - s`` microbatches are in flight on stage ``s``.

:meth:`PipelineStageStack.train_loss` runs either as one autograd
function, as the JAX 1F1B program is one ``custom_vjp``: its forward
runs the whole schedule (the loss head on the last stage inside each
microbatch's forward) and computes this stage's parameter gradients;
the loss it returns carries a node whose backward hands those
gradients on, scaled by the incoming cotangent. The two schedules do
the same arithmetic in another order of microbatches, and every
gradient is summed over the microbatches in microbatch order, so they
give the same bits. :meth:`PipelineStageStack.forward` (logits, eval)
is fill-drain, its backward run when the loss's backward reaches it:
the last stage returns the stack's output and the others a handle the
model's broadcast of the logits hangs on.

Dropout masks do not depend on the schedule, nor on the stages: at
entry every rank holds the step's generator where the single-process
step would, after the embedding's draws; the stage of layers ``[lo,
hi)`` starts its draws ``lo`` layers later (``core.random.
count_seed_draws`` of the template), each microbatch ``m`` enters the
batch base ``m * mb`` past the rank's own, and every rank moves the
step's generator past all ``L`` layers. The masks hash absolute rows,
heads and elements, so a pipelined step draws the single-process
step's masks (where the JAX pipeline keys its RNG per (microbatch,
stage) and so differs from one device, ``:57-65``).

Without a pp axis of more than one rank the stack runs its layers one
after another over the whole batch, as the JAX stack does without a
mesh.

Not ported, by decision: ``manual_collectives_ok`` and the counted
fallback (the port can always pipeline), the program and compile
counters, and ``FLAGS_scan_layers`` (the port has no scan).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...core.flags import get_flag
from ...core import random as _random
from .. import env as dist_env
from ..spmd import P
from ...nn.layer import Layer

__all__ = ["PP_AXIS", "PipelineStageStack", "resolve_schedule",
           "bubble_fraction", "schedule_slots", "schedule_timetable",
           "pipeline_comm_model", "stage_ops", "max_in_flight",
           "PIPELINE_STATS", "reset_pipeline_stats"]

PP_AXIS = "pp"

SCHEDULES = ("fill_drain", "1f1b")

#: pipelined calls this process ran (``dispatches``), the most
#: microbatches it held in flight at once (``max_in_flight``: forwards
#: run and not yet run backward on this rank's stage) and the stage
#: handoffs it sent and received
PIPELINE_STATS = {"dispatches": 0, "max_in_flight": 0, "sent": 0,
                  "received": 0}


def reset_pipeline_stats():
    for k in PIPELINE_STATS:
        PIPELINE_STATS[k] = 0


def resolve_schedule(explicit: Optional[str] = None) -> str:
    """Pipeline schedule resolution: ``FLAGS_pipeline_schedule`` (global
    override) > explicit constructor/config arg > the fleet strategy's
    ``pipeline_configs['schedule_mode']`` (reference spelling ``1F1B`` /
    ``F-then-B`` normalized) > ``1f1b`` default."""
    flag = str(get_flag("pipeline_schedule") or "").strip()
    for cand in (flag, explicit or ""):
        norm = _normalize_schedule(cand)
        if norm:
            return norm
    try:
        from ..fleet import _strategy
        mode = _strategy().pipeline_configs.get("schedule_mode", "1F1B")
    except Exception:
        mode = "1F1B"
    return _normalize_schedule(str(mode)) or "1f1b"


def _normalize_schedule(name: str) -> Optional[str]:
    s = name.strip().lower().replace("-", "_")
    if not s:
        return None
    if s in ("1f1b", "one_f_one_b"):
        return "1f1b"
    if s in ("fill_drain", "f_then_b", "fthenb", "gpipe"):
        return "fill_drain"
    raise ValueError(
        f"unknown pipeline schedule {name!r}; expected one of "
        f"{SCHEDULES} (FLAGS_pipeline_schedule / "
        "strategy.pipeline_configs['schedule_mode'])")


def schedule_slots(schedule: str, S: int, M: int) -> int:
    """Lockstep slots the schedule occupies. fill_drain counts forward
    ticks only (backward is the autodiff mirror, same count); 1f1b counts
    combined fwd+bwd slots."""
    if S <= 1:
        return M
    return (M + S - 1) if schedule == "fill_drain" else 2 * (M + S - 1)


def bubble_fraction(schedule: str, S: int, M: int) -> float:
    """Idle-slot fraction of the schedule. Both fill_drain (fwd scan +
    its autodiff mirror) and 1f1b sit at the canonical
    (S-1)/(M+S-1) — 1f1b's win over fill_drain is the O(S) activation
    memory, not the bubble."""
    if S <= 1:
        return 0.0
    return (S - 1) / (M + S - 1)


def schedule_timetable(schedule: str, S: int, M: int) -> Dict[str, np.ndarray]:
    """Host-side occupancy grid of the schedule.

    Returns ``{"fwd": [S, T], "bwd": [S, T], "busy": [S, T],
    "bubble_fraction": float}`` where ``fwd[s, t]`` is True iff stage s
    does useful forward work in slot t. For ``1f1b`` these are the
    predicates each stage's op order follows (:func:`stage_ops`);
    ``fill_drain`` models the forward pass plus its backward mirror
    (same occupancy, time-reversed)."""
    T = schedule_slots(schedule, S, M)
    s = np.arange(S)[:, None]
    t = np.arange(T)[None, :]
    if S <= 1:
        fwd = np.ones((S, T), bool)
        bwd = np.zeros((S, T), bool)
    elif schedule == "fill_drain":
        # forward tick t runs microbatch t - s on stage s when valid; the
        # backward mirror has identical occupancy reversed in time
        fwd = (t - s >= 0) & (t - s < M)
        bwd = fwd[:, ::-1]
    else:
        m_f = (t - s) // 2
        f_par = (t - s) % 2 == 0
        fwd = f_par & (m_f >= 0) & (m_f < M)
        m_b = (t - (2 * S - 1 - s)) // 2
        bwd = (~f_par) & (m_b >= 0) & (m_b < M)
    if schedule == "fill_drain" and S > 1:
        # fwd scan and bwd mirror are two sequential passes of T ticks
        busy = np.concatenate([fwd, bwd], axis=1)
    else:
        busy = fwd | bwd
    frac = 1.0 - float(busy.sum()) / busy.size if busy.size else 0.0
    return {"fwd": fwd, "bwd": bwd, "busy": busy,
            "bubble_fraction": frac}


def pipeline_comm_model(schedule: str, S: int, M: int,
                        boundary_bytes: int) -> Dict[str, float]:
    """Static per-step comm model of the schedule's stage handoffs:
    ppermute ops and bytes moved per optimizer step (per device).
    fill_drain: one activation permute per forward tick + its transpose
    per backward tick; 1f1b: one activation + one cotangent permute per
    slot. ``boundary_bytes`` = bytes of ONE microbatch's stage-boundary
    activation."""
    if S <= 1:
        return {"ops": 0, "bytes": 0, "slots": schedule_slots(
            schedule, S, M), "bubble_fraction": 0.0}
    slots = schedule_slots(schedule, S, M)
    # one permute pair per slot either way: 1f1b sends activation +
    # cotangent every slot; fill_drain sends one activation per forward
    # tick plus its transpose in the backward mirror
    ops = 2 * slots
    return {"ops": float(ops), "bytes": float(ops) * boundary_bytes,
            "slots": float(slots),
            "bubble_fraction": bubble_fraction(schedule, S, M)}


def stage_ops(schedule: str, S: int, M: int, s: int) -> List[tuple]:
    """Stage ``s``'s ``("F"|"B", microbatch)`` in the order it runs
    them: the 1f1b timetable's slots in order (one stage: each forward
    followed by its backward); fill_drain every forward, then every
    backward, both in microbatch order."""
    if schedule == "1f1b" and S == 1:
        return [(k, m) for m in range(M) for k in ("F", "B")]
    if schedule == "1f1b":
        tt = schedule_timetable("1f1b", S, M)
        ops = []
        for t in range(tt["fwd"].shape[1]):
            if tt["fwd"][s, t]:
                ops.append(("F", (t - s) // 2))
            if tt["bwd"][s, t]:
                ops.append(("B", (t - (2 * S - 1 - s)) // 2))
        return ops
    return [("F", m) for m in range(M)] + [("B", m) for m in range(M)]


def max_in_flight(schedule: str, S: int, M: int, s: int) -> int:
    """The most microbatches stage ``s`` holds between their forward
    and their backward under the schedule: ``min(S - s, M)`` for 1f1b,
    ``M`` for fill_drain."""
    live = peak = 0
    for kind, _ in stage_ops(schedule, S, M, s):
        live += 1 if kind == "F" else -1
        peak = max(peak, live)
    return peak


def _reg_name(template_name: str) -> str:
    """Dotted template param path -> attribute-safe registration name."""
    return "stacked__" + template_name.replace(".", "__")


def pp_group_of(mesh=None, axis: str = PP_AXIS):
    """The pp group of ``mesh`` (default: the active one) when its pp
    axis has more than one rank, else None."""
    mesh = mesh if mesh is not None else dist_env.get_mesh()
    if mesh is None or mesh.axis_size(axis) <= 1:
        return None
    return mesh.group(axis)


class _Run:
    """One pipelined call of a stack on this stage: the schedule, the
    handoff, the layers' leaves and what the backward needs."""

    def __init__(self, stack, S: int, M: int, schedule: str, x, shape,
                 dtype, device):
        from .pp_utils import StageHandoff
        self.stack, self.S, self.M, self.schedule = stack, S, M, schedule
        group = stack._pp_group
        self.s = group.rank
        ranks = group.ranks
        self.first, self.last = self.s == 0, self.s == S - 1
        self.src = ranks[-1]
        self.group = group
        self.handoff = StageHandoff(
            group, None if self.first else ranks[self.s - 1],
            None if self.last else ranks[self.s + 1])
        self.x = x
        self.mb = shape[0] // M
        self.shape = (self.mb,) + tuple(shape[1:])
        self.dtype, self.device = dtype, device
        n_local = stack.num_layers // S
        self.lo = self.s * n_local
        # the step's generator where the single-process step has it
        # before layer lo, and each microbatch's batch base
        state = _random.dropout_state()
        self.draws = _random.count_seed_draws(stack.__dict__["_template"])
        self.state = _random.advance_dropout_state(state,
                                                   self.draws * self.lo)
        self.saved: Dict[int, tuple] = {}
        self.live = 0

    def dropout_scope(self, m: int):
        st = self.state
        if st is not None:
            st = (st[0], st[1] + m * self.mb) + tuple(st[2:])
        return _random.replay_dropout_state(st)

    def stage_input(self, m: int):
        if self.first:
            return self.x[m * self.mb:(m + 1) * self.mb]
        return self.handoff.recv_fwd(m, self.shape, self.dtype, self.device)

    def note_forward(self) -> None:
        self.live += 1
        PIPELINE_STATS["max_in_flight"] = max(
            PIPELINE_STATS["max_in_flight"], self.live)

    def end_forward(self) -> None:
        """Every rank moves the step's generator past all L layers (the
        single-process forward's draws)."""
        self.handoff.flush()
        _random.skip_seed_words(self.draws * self.stack.num_layers)

    def finish(self) -> None:
        self.handoff.flush()
        PIPELINE_STATS["sent"] += self.handoff.sent
        PIPELINE_STATS["received"] += self.handoff.received


def _accumulate(acc: List[Optional[torch.Tensor]], grads) -> None:
    for i, g in enumerate(grads):
        if g is None:
            continue
        if acc[i] is None:
            acc[i] = g.clone()
        else:
            acc[i].add_(g)


class _PipeForward(torch.autograd.Function):
    """Fill-drain forward of this stage over every microbatch; the
    backward (when the loss's backward reaches it) runs every
    microbatch's backward in microbatch order. Returns the stack's
    output on the last stage, a scalar handle elsewhere."""

    @staticmethod
    def forward(ctx, run: _Run, x, *stacked):
        grad = any(ctx.needs_input_grad[1:])
        stack = run.stack
        leaves = stack._leaves(stacked, grad)
        outs = []
        for m in range(run.M):
            h = run.stage_input(m)
            y = stack._stage_forward(run, m, leaves, h, grad)
            run.note_forward()
            if run.last:
                outs.append(y.detach())
            else:
                run.handoff.send_fwd(y, m)
        run.end_forward()
        if not grad:
            run.finish()
        ctx.run, ctx.leaves, ctx.stacked = run, leaves, stacked
        if run.last:
            return torch.cat(outs) if len(outs) > 1 else outs[0]
        return torch.zeros((), device=run.device)

    @staticmethod
    def backward(ctx, g):
        run, stack = ctx.run, ctx.run.stack
        acc: List[Optional[torch.Tensor]] = [None] * stack._n_leaf_grads(
            ctx.leaves)
        dxs = []
        for m in range(run.M):
            dy = (g[m * run.mb:(m + 1) * run.mb] if run.last
                  else run.handoff.recv_bwd(m, run.saved[m][1]))
            dh = stack._stage_backward(run, m, ctx.leaves, dy, acc)
            run.live -= 1
            if dh is not None:
                dxs.append(dh)
        run.finish()
        dx = None
        if run.first and ctx.needs_input_grad[1]:
            dx = torch.cat(dxs) if len(dxs) > 1 else dxs[0]
        return (None, dx) + stack._stacked_grads(ctx.stacked, ctx.leaves,
                                                 acc)


class _PipeTrain(torch.autograd.Function):
    """The whole schedule with the loss head on the last stage, run in
    the forward (the JAX 1F1B ``custom_vjp``): returns ``(loss_sum,
    denom)`` on every stage; the backward hands this stage's gradients
    on, scaled by the loss sum's cotangent."""

    @staticmethod
    def forward(ctx, run: _Run, head_apply, mb_args, x, n_stack, *leaves_in):
        stacked, head = leaves_in[:n_stack], leaves_in[n_stack:]
        grad = any(ctx.needs_input_grad[3:])
        stack = run.stack
        leaves = stack._leaves(stacked, grad)
        head_leaves = [h.detach().requires_grad_(grad) for h in head]
        n_layer = stack._n_leaf_grads(leaves)
        acc: List[Optional[torch.Tensor]] = [None] * (n_layer + len(head))
        dxs = {}
        totals = torch.zeros(2, dtype=torch.float32, device=run.device)
        ls_sum = dn_sum = None
        for kind, m in stage_ops(run.schedule, run.S, run.M, run.s):
            if kind == "F":
                h = run.stage_input(m)
                y = stack._stage_forward(run, m, leaves, h, grad)
                run.note_forward()
                if not run.last:
                    run.handoff.send_fwd(y, m)
                    continue
                args = [a[m * run.mb:(m + 1) * run.mb] for a in mb_args]
                with torch.enable_grad():
                    y_leaf = y.detach().requires_grad_(grad)
                    ls, dn = head_apply(head_leaves, y_leaf, *args)
                    if grad:
                        gs = torch.autograd.grad(ls, [y_leaf] + head_leaves,
                                                 allow_unused=True)
                        run.saved[m] = run.saved[m] + (gs[0],)
                        _accumulate(acc, [None] * n_layer + list(gs[1:]))
                ls_sum = ls.detach() if ls_sum is None else ls_sum + ls.detach()
                dn_sum = dn.detach() if dn_sum is None else dn_sum + dn.detach()
            elif grad:
                dy = (run.saved[m][2] if run.last
                      else run.handoff.recv_bwd(m, run.saved[m][1]))
                dh = stack._stage_backward(run, m, leaves, dy, acc)
                if dh is not None:
                    dxs[m] = dh
                run.live -= 1
        if run.last:
            totals[0] = ls_sum
            totals[1] = dn_sum
        run.end_forward()
        run.finish()
        from ..collective import broadcast
        broadcast(totals, run.src, run.group)
        ctx.n_stack, ctx.n_head = n_stack, len(head)
        ctx.grads = None
        if grad:
            dx = None
            if run.first and ctx.needs_input_grad[3]:
                dx = torch.cat([dxs[m] for m in range(run.M)])
            ctx.grads = (dx, stack._stacked_grads(stacked, leaves,
                                                  acc[:n_layer]),
                         acc[n_layer:])
        return totals[0].clone(), totals[1].clone()

    @staticmethod
    def backward(ctx, g_ls, g_dn):
        dx, gstack, ghead = ctx.grads
        ctx.grads = None

        def scale(t):
            return None if t is None else t * g_ls
        return ((None, None, None, scale(dx), None)
                + tuple(scale(t) for t in gstack)
                + tuple(scale(t) for t in ghead))


class _LastStageLogits(torch.autograd.Function):
    """The last stage's tensor on every stage of the pp group (a
    broadcast from it). The backward passes on only the source's own
    gradient; elsewhere it triggers the stage's pipeline backward
    through ``handle`` and drops the tensor's gradient."""

    @staticmethod
    def forward(ctx, t, handle, shape, dtype, group, src: int):
        from ..collective import broadcast
        ctx.is_src = dist_env.get_rank() == src
        ctx.dev = handle.device
        if ctx.is_src:
            out = t.contiguous().clone()
        else:
            out = torch.empty(shape, dtype=dtype, device=handle.device)
        broadcast(out, src, group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.is_src:
            return g, None, None, None, None, None
        return (None, torch.zeros((), device=ctx.dev), None, None, None,
                None)


def last_stage_output(t: Optional[torch.Tensor], handle: torch.Tensor,
                      shape, dtype, group, src: int) -> torch.Tensor:
    """``t`` (the last stage's, e.g. the logits) on every stage of
    ``group``; ``handle`` is a non-last stage's :class:`_PipeForward`
    output, so the loss's backward reaches that stage's pipeline."""
    return _LastStageLogits.apply(t if t is not None else handle, handle,
                                  tuple(shape), dtype, group, src)


class PipelineStageStack(Layer):
    """N structurally identical blocks stacked into ``[L, ...]``
    parameters and run as a pipeline over the ``pp`` axis.

    ``layer_factory() -> nn.Module`` is called once per layer (each
    draws its own init) and once more for the template, which runs each
    layer through ``torch.func.functional_call`` on that layer's slices
    (so gradients land in the stacked parameters). Blocks map an input
    of shape X to an output of the same shape (residual blocks) and must
    not own buffers. ``schedule`` picks :meth:`train_loss`'s schedule
    (None: resolved at call time); :meth:`forward` is always
    fill-drain. ``remat`` runs each stage's layers under
    ``fleet.utils.recompute`` on the pipelined path.
    """

    def __init__(self, layer_factory: Callable[[], nn.Module],
                 num_layers: int, axis: str = PP_AXIS,
                 num_microbatches: Optional[int] = None, remat: bool = True,
                 schedule: Optional[str] = None):
        super().__init__()
        self.axis = axis
        self.num_layers = int(num_layers)
        self.num_microbatches = num_microbatches
        self.remat = remat
        if schedule is not None:
            _normalize_schedule(schedule)       # validate eagerly
        self.schedule = schedule
        self._pp_group = None
        template = layer_factory()
        if dict(template.named_buffers()):
            raise ValueError(
                "PipelineStageStack blocks must not own buffers (got "
                f"{list(dict(template.named_buffers()))}); fold running "
                "stats out of the pipelined body")
        per_layer = [dict(template.named_parameters())]
        for _ in range(self.num_layers - 1):
            per_layer.append(dict(layer_factory().named_parameters()))
        self._name_map: Dict[str, str] = {}
        for tname, tparam in per_layer[0].items():
            with torch.no_grad():
                stacked = torch.stack([d[tname].detach() for d in per_layer])
            rname = _reg_name(tname)
            self._name_map[rname] = tname
            p = nn.Parameter(stacked)
            p.spec = P(self.axis, *tuple(getattr(tparam, "spec", None) or ()))
            setattr(self, rname, p)
        del per_layer
        # the template runs the layers; its own parameters are only
        # placeholders (shapes and specs), kept on the meta device (the
        # move makes new Parameters: the specs are stamped again)
        specs = {k: getattr(p, "spec", None)
                 for k, p in template.named_parameters()}
        template.to("meta")
        for k, p in template.named_parameters():
            if specs[k] is not None:
                p.spec = specs[k]
        self.__dict__["_template"] = template

    # -- the mesh ------------------------------------------------------------
    def _on_mesh(self, mesh) -> None:
        from ..spmd import apply_param_shardings
        apply_param_shardings(self.__dict__["_template"], mesh)
        self._pp_group = pp_group_of(mesh, self.axis)
        if self._pp_group is not None and \
                self.num_layers % self._pp_group.nranks:
            raise ValueError(f"pp degree {self._pp_group.nranks} must "
                             f"divide num_layers {self.num_layers}")

    def pp_degree(self) -> int:
        return 1 if self._pp_group is None else self._pp_group.nranks

    def stage_id(self) -> int:
        return 0 if self._pp_group is None else self._pp_group.rank

    def resolved_schedule(self) -> str:
        return resolve_schedule(self.schedule)

    def _resolve_M(self, num_microbatches: Optional[int], S: int,
                   B: int) -> int:
        M = int(num_microbatches or self.num_microbatches or S)
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} "
                             "microbatches")
        return M

    def _tmpl(self):
        tmpl = self.__dict__["_template"]
        tmpl.train(self.training)
        return tmpl

    # -- the layers ----------------------------------------------------------
    def _stacked(self) -> List[torch.Tensor]:
        return [getattr(self, r) for r in self._name_map]

    def _leaves(self, stacked, grad: bool) -> List[Dict[str, torch.Tensor]]:
        """Each local layer's parameters ``{template name: [...]}``: views
        of the stacked blocks, leaves of their own when gradients are
        wanted (one gradient a layer, no ``[L, ...]`` zero fill)."""
        names = list(self._name_map.values())
        n_local = stacked[0].shape[0]
        out = []
        for j in range(n_local):
            out.append({n: t.detach()[j].requires_grad_(grad)
                        for n, t in zip(names, stacked)})
        return out

    @staticmethod
    def _n_leaf_grads(leaves) -> int:
        return len(leaves) * len(leaves[0])

    @staticmethod
    def _flat(leaves) -> List[torch.Tensor]:
        return [t for lv in leaves for t in lv.values()]

    def _stacked_grads(self, stacked, leaves, acc) -> tuple:
        """The accumulated per-layer gradients restacked ``[L_local,
        ...]`` in the order of ``stacked`` (zeros where a layer got
        none)."""
        per = len(leaves[0])
        out = []
        for i, t in enumerate(stacked):
            gs = [acc[j * per + i] for j in range(len(leaves))]
            gs = [torch.zeros_like(t[j]) if g is None else g
                  for j, g in enumerate(gs)]
            out.append(torch.stack(gs))
        return tuple(out)

    def _run_layers(self, leaves, h):
        from torch.func import functional_call
        tmpl = self._tmpl()
        for lv in leaves:
            # the stream keeps its dtype across layers, as the
            # single-process model's layer loop does
            h = functional_call(tmpl, lv, (h,)).to(h.dtype)
        return h

    def _stage_forward(self, run: _Run, m: int, leaves, h, grad: bool):
        """Microbatch ``m`` through this stage's layers (under recompute
        with ``remat``), its dropout at the single-process masks. Saves
        ``(input leaf, output)`` for the backward."""
        from ..fleet.utils.recompute import recompute
        with run.dropout_scope(m), torch.set_grad_enabled(grad):
            h_in = h.detach().requires_grad_(grad and (not run.first or
                                                        run.x.requires_grad))
            if self.remat and grad:
                y = recompute(self._run_layers, leaves, h_in)
            else:
                y = self._run_layers(leaves, h_in)
        if grad:
            run.saved[m] = (h_in, y)
        return y

    def _stage_backward(self, run: _Run, m: int, leaves, dy, acc):
        """Microbatch ``m``'s backward through this stage: the layers'
        gradients added into ``acc``, the input's gradient sent to the
        previous stage (returned on the first)."""
        h_in, y = run.saved.pop(m)[:2]
        flat = self._flat(leaves)
        want = ([h_in] if h_in.requires_grad else []) + flat
        gs = torch.autograd.grad(y, want, dy.to(y.dtype), allow_unused=True)
        dh = gs[0] if h_in.requires_grad else None
        _accumulate(acc, gs[1:] if h_in.requires_grad else gs)
        if not run.first and dh is not None:
            run.handoff.send_bwd(dh, m)
            return None
        return dh

    def _sequential(self, x):
        """Every layer, one after another, over the whole batch (no pp
        axis): the stacked parameters unbound once, so the backward
        stacks each one's gradient once."""
        names = list(self._name_map.values())
        cols = [t.unbind(0) for t in self._stacked()]
        leaves = [{n: c[j] for n, c in zip(names, cols)}
                  for j in range(self.num_layers)]
        return self._run_layers(leaves, x)

    def _run(self, x, num_microbatches):
        S = self.pp_degree()
        shape, dtype = tuple(x.shape), x.dtype
        M = self._resolve_M(num_microbatches, S, shape[0])
        dev = self._stacked()[0].device
        PIPELINE_STATS["dispatches"] += 1
        return S, M, dev, shape, dtype

    # -- execution -------------------------------------------------------------
    def forward(self, x, num_microbatches: Optional[int] = None):
        """The stack over ``x``. On a pp axis the fill-drain pipeline:
        the first stage gives ``x``, every other stage a ``meta`` tensor
        of its shape and dtype; the last stage returns the output, the
        others a handle for :func:`last_stage_output`."""
        if self.pp_degree() <= 1:
            return self._sequential(x)
        S, M, dev, shape, dtype = self._run(x, num_microbatches)
        run = _Run(self, S, M, "fill_drain", x if not x.is_meta else None,
                   shape, dtype, dev)
        return _PipeForward.apply(run, run.x, *self._stacked())

    def train_loss(self, x, head_apply: Callable, head_leaves: Sequence,
                   mb_args: Sequence = (),
                   num_microbatches: Optional[int] = None,
                   head_token=None):
        """The pipelined training loss ``(loss_sum, denom)`` under the
        resolved schedule (fill_drain outside training mode).

        ``head_apply(head_leaves, y, *mb_args) -> (loss_sum, denom)``:
        the loss head after the stack, float32 scalars; it runs on the
        last stage, a microbatch at a time (on the whole batch without a
        pp axis). ``head_leaves`` are its parameters (they get
        gradients), ``mb_args`` per-sample data split with the batch.
        Returns the two scalars, the same on every stage; the caller
        divides (``head_token`` is accepted for the JAX signature)."""
        if self.pp_degree() <= 1:
            return head_apply(list(head_leaves), self._sequential(x),
                              *mb_args)
        S, M, dev, shape, dtype = self._run(x, num_microbatches)
        sched = self.resolved_schedule() if self.training else "fill_drain"
        run = _Run(self, S, M, sched, x if not x.is_meta else None, shape,
                   dtype, dev)
        stacked = self._stacked()
        return _PipeTrain.apply(run, head_apply, list(mb_args), run.x,
                                len(stacked), *stacked, *head_leaves)

    # -- interop ---------------------------------------------------------------
    def layer_state_dict(self, i: int) -> Dict[str, torch.Tensor]:
        """Per-layer view of the stacked parameters (template names)."""
        return {t: getattr(self, r)[i] for r, t in self._name_map.items()}

    @torch.no_grad()
    def load_from_layers(self, layers):
        """Restack parameters from a list of per-layer modules (e.g. a
        non-pipelined model's blocks)."""
        if len(layers) != self.num_layers:
            raise ValueError("layer count mismatch")
        dicts = [dict(lyr.named_parameters()) for lyr in layers]
        for rname, tname in self._name_map.items():
            getattr(self, rname).copy_(torch.stack([d[tname] for d in dicts]))
