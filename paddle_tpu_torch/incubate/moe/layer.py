"""Mixture-of-Experts layers with expert parallelism, PyTorch port.

Counterpart of ``paddle_tpu/incubate/moe/layer.py``: :class:`ExpertFFN`
(E homogeneous FFN experts as stacked ``[E, ...]`` parameters, each with
the spec ``P('ep', None, None)``), :class:`MoELayer` (the always-float32
router, the einsum or sort dispatch, the experts, the combine; the
``aux_loss`` / ``z_loss`` / ``router_stats`` / ``moe_vec`` side
outputs), the router telemetry and the reference-parity
``global_scatter`` / ``global_gather``.

One process per rank. Without a mesh, or on a mesh whose ``ep`` axis
holds one rank, the layer routes the tokens it is given (the JAX auto
path, computed on this rank). On a mesh with an ``ep`` axis of ``n``
ranks it runs the JAX explicit expert-parallel program
(``_ep_program``, ``layer.py:455-568``) as this rank's part of it: the
layer takes this rank's tokens ``[B/n, S, D]`` (``TrainStep`` with
``data_spec=P("ep")`` hands it them), routes them at the LOCAL capacity
``moe_capacity(T/n, cf, E)``, exchanges ``resolve_a2a_chunks`` capacity
chunks with its ep peers by a differentiable all-to-all
(``distributed.collective.alltoall``: its backward is the inverse
exchange) around the FFN of its ``E/n`` experts (the rank's block of the
stacked leaves: ``apply_param_shardings`` cuts them, or the layer takes
its block of whole ones), combines locally and returns this rank's
output. ``aux_loss``, ``z_loss`` and the stats are the ep mean (JAX's
``pmean``), the balance recomputed from the mean loads; their gradient
stays local, which the step's mean of the non-expert gradients over ep
makes the JAX gradient. An eager dispatch runs under
``_run_collective("moe.all_to_all", ...)``, so the chaos site
``collective.hang`` raises ``CollectiveTimeoutError`` on the ep group.

Where the JAX layer falls back to its GSPMD auto path on an ep mesh
(``flag_off``, ``heterogeneous_experts``, ``custom_gate``,
``indivisible``), the port has no such path (its ranks hold only their
own experts): :func:`note_moe_fallback` raises ``NotImplementedError``
with the JAX reason, and ``MOE_STATS["fallbacks"]`` stays 0. The JAX
``manual_collectives_unsupported`` cause does not exist here (a rank is
a process).

Tensor parallelism: on a mesh with an ``mp`` axis the layer's tokens are
replicated over mp (the block's row-parallel sum made them whole) and so
are its experts and gate (their specs name ``ep`` only, as the JAX
``P('ep', ...)`` leaves them), so every mp rank computes the same
routing and output; the gradient that reaches them is the same on every
mp rank too (``copy_to_model_parallel`` all-reduced it), so they need no
mp reduction. On ep x mp the explicit program runs inside each mp
slice's ep group (``mesh.group("ep")``: the ranks that share the mp
coordinate). A mesh with ``sp`` above 1 raises (a sequence shard's
tokens would route at a capacity of their own, where the JAX layer
routes the global batch: the next part of ``distributed/``), and so
does ``pp`` above 1 (the JAX pipeline model refuses MoE configs).

The expert products are ``torch.bmm`` (the JAX einsums), in the
promoted dtype of the tokens and the weights: under AMP O1 a bfloat16
stream meets float32 experts, so the FFN runs and returns float32, as
the JAX einsum promotes (the expert FFN, dispatch and combine are on no
AMP list). The gelu is the tanh approximation (``jax.nn.gelu``'s
default).

The routing, dispatch, expert FFN and combine of a forward run inside
``torch.profiler.record_function`` ranges named as the JAX ops
(``moe_routing``, ``moe_dispatch``, ``expert_ffn``, ``moe_combine``), so
a profile attributes their kernels.

Telemetry: under ``FLAGS_monitor`` every forward publishes the layer's
``moe_router_*`` gauges and the ``moe_dropped_tokens_total`` counter
(one host read a layer; the JAX layer publishes only from eager
forwards, its jitted programs carrying tracers, and the port has no
traced forward); :func:`publish_router_stats` harvests explicitly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from ...amp import auto_cast
from ...core.device import DeviceLike, resolve_device
from ...core.flags import get_flag
from ...distributed import env as dist_env
from ...distributed.spmd import P
from ...nn import functional as F
from ...nn.layers.common import Linear
from .dispatch import (einsum_combine, einsum_dispatch,
                       resolve_dispatch_mode, sort_combine, sort_dispatch)
from .routing import STATS_FIELDS, moe_capacity, topk_routing
from ...nn.layer import Layer

__all__ = ["EP_AXIS", "MOE_STATS", "reset_moe_stats", "note_moe_fallback",
           "global_scatter", "global_gather", "ExpertFFN", "MoELayer",
           "expert_ffn_apply", "publish_router_stats",
           "resolve_a2a_chunks", "moe_ep_group", "xavier_uniform_"]

EP_AXIS = "ep"

#: explicit expert-parallel dispatches, auto-path dispatches by mode, and
#: fallbacks (always 0: the port refuses where JAX falls back)
MOE_STATS = {"ep_dispatches": 0, "sort_dispatches": 0,
             "einsum_dispatches": 0, "fallbacks": 0}

#: mesh axes an MoE layer does not compose with, and why
_REFUSED_AXES = {
    "sp": "MoE over sp is not ported yet: a sequence shard's tokens would "
          "route at a capacity of their own, where the JAX layer routes "
          "the global batch; it comes with the next part of "
          "distributed/ (part 3b)",
    "pp": "MoE over pp is not ported: the JAX GPTForPretrainingPipe "
          "refuses MoE configs, and the port mirrors it"}


def reset_moe_stats() -> None:
    for k in MOE_STATS:
        MOE_STATS[k] = 0


def note_moe_fallback(reason: str, detail: str = "") -> None:
    """Where the JAX layer degrades to its GSPMD auto path on an ep mesh
    (reason ``flag_off``, ``heterogeneous_experts``, ``custom_gate`` or
    ``indivisible``): the port has no auto path there, so it raises."""
    raise NotImplementedError(
        f"MoE expert parallelism cannot run this layer (reason: {reason}"
        f"{'; ' + detail if detail else ''}): the JAX package falls back "
        "to its GSPMD auto path here; the port has none on an ep mesh "
        "(its ranks hold only their own experts). Use stacked experts "
        "with the default gate, an expert count the ep degree divides "
        "and FLAGS_moe_expert_parallel on, or leave the ep axis at 1")


def resolve_a2a_chunks(local_capacity: int, flag_value=None) -> int:
    """The expert-parallel chunk count: ``FLAGS_moe_a2a_chunks`` reduced
    until the chunk width tiles the local capacity."""
    chunks = max(1, int(get_flag("moe_a2a_chunks")
                        if flag_value is None else flag_value))
    while local_capacity % chunks:
        chunks -= 1
    return chunks


def moe_ep_group(n: int):
    """The group naming the ep axis: the active mesh's ep group when it
    has ``n`` ranks, else a named group of ``n`` ranks without a process
    group (the JAX ``Group(..., gid=-102, axis_name="ep")``), which a
    watchdog and the telemetry name."""
    from ...distributed.collective import Group
    mesh = dist_env.get_mesh()
    if mesh is not None and mesh.axis_size(EP_AXIS) == n:
        g = mesh.group(EP_AXIS)
        if g is not None:
            return g
    return Group(list(range(n)), gid=-102, axis_name=EP_AXIS)


def _ep_group(group=None):
    if group is not None:
        return group
    mesh = dist_env.get_mesh()
    if mesh is not None and EP_AXIS in mesh.axis_names:
        return mesh.group(EP_AXIS)
    from ...distributed.collective import get_group
    return get_group()


def _check_uniform_counts(counts, what: str, total: Optional[int] = None):
    """The exchange moves ``rows / n`` rows to every rank, so only
    uniform counts (GShard's fixed capacity) are taken; variable counts
    would mis-route rows, so they raise."""
    if counts is None:
        return
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    arr = np.asarray(counts)
    if arr.size and not (arr == arr.flat[0]).all():
        raise NotImplementedError(
            f"global_scatter/global_gather: non-uniform {what} "
            f"{arr.tolist()} is unsupported: the exchange is a tiled "
            "all-to-all, which requires equal rows per expert (GShard "
            "capacity discipline); pad every expert to the same count")
    if total is not None and arr.size and int(arr.sum()) != int(total):
        raise ValueError(
            f"global_scatter/global_gather: {what} sums to {int(arr.sum())} "
            f"but x has {int(total)} rows: the tiled all-to-all moves "
            "rows/ep_size rows per rank, so the counts must describe "
            "exactly the rows present")


def _tiled_exchange(x, group):
    g = _ep_group(group)
    rows, n = x.shape[0], g.nranks
    if rows % n:
        raise ValueError(f"rows {rows} must divide ep size {n}")
    from ...distributed.collective import alltoall
    blocks = x.reshape((n, rows // n) + tuple(x.shape[1:]))
    return alltoall(blocks, group=g).reshape(x.shape)


def global_scatter(x, local_count, global_count, group=None):
    """Send this rank's rows of ``x`` to the experts' ranks: block ``d``
    of ``n`` equal row blocks to rank ``d`` of the ep group (``group``,
    default the active mesh's ep group, else the world), the received
    blocks concatenated in rank order (reference
    ``distributed/utils.py:57``). ``local_count[i]`` / ``global_count[i]``
    (rows sent to / received for expert i) must be uniform and sum to
    the rows. Differentiable."""
    rows = x.shape[0]
    _check_uniform_counts(local_count, "local_count", total=rows)
    _check_uniform_counts(global_count, "global_count", total=rows)
    return _tiled_exchange(x, group)


def global_gather(x, local_count, global_count, group=None):
    """Inverse of :func:`global_scatter` (reference
    ``distributed/utils.py:151``)."""
    rows = x.shape[0]
    _check_uniform_counts(local_count, "local_count", total=rows)
    _check_uniform_counts(global_count, "global_count", total=rows)
    return _tiled_exchange(x, group)


def _promoted(a, b):
    ct = torch.promote_types(a.dtype, b.dtype)
    return a.to(ct), b.to(ct)


def expert_ffn_apply(x, w1, b1, w2, b2, act=None):
    """The stacked-expert FFN: ``[E, C, D] -> [E, C, D]``, ``bmm`` in the
    promoted dtype, bias, gelu (tanh) or ``act``, ``bmm``, bias."""
    h = torch.bmm(*_promoted(x, w1)) + b1
    h = F.gelu(h, approximate=True) if act is None else act(h)
    return torch.bmm(*_promoted(h, w2)) + b2


def _fans(shape):
    """The JAX initializers' fans (``nn/initializer.py::_fans``)."""
    shape = tuple(shape)
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def xavier_uniform_(p: torch.Tensor, generator: torch.Generator):
    """The JAX ``XavierUniform`` (its ``_fans`` of the whole shape) in
    place."""
    fi, fo = _fans(p.shape)
    limit = math.sqrt(6.0 / (fi + fo))
    return p.uniform_(-limit, limit, generator=generator)


def _stacked(shape, device):
    p = nn.Parameter(torch.zeros(shape, dtype=torch.float32, device=device))
    p.spec = P(EP_AXIS, None, None)
    return p


class ExpertFFN(Layer):
    """E homogeneous FFN experts as stacked parameters ``w1 [E, D, H]``,
    ``b1 [E, 1, H]``, ``w2 [E, H, D]``, ``b2 [E, 1, D]``, each with the
    spec ``P('ep', None, None)``: on an ep mesh
    ``apply_param_shardings`` leaves a rank its ``E/n`` experts. Built
    as zeros; :meth:`reset_parameters` draws the JAX defaults."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation=None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_experts = num_experts
        self.w1 = _stacked((num_experts, d_model, d_hidden), dev)
        self.b1 = _stacked((num_experts, 1, d_hidden), dev)
        self.w2 = _stacked((num_experts, d_hidden, d_model), dev)
        self.b2 = _stacked((num_experts, 1, d_model), dev)
        self.activation = activation

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """XavierUniform weights over their whole stacked shape (the
        JAX ``create_parameter`` default), zero biases."""
        xavier_uniform_(self.w1, generator)
        xavier_uniform_(self.w2, generator)
        self.b1.zero_()
        self.b2.zero_()

    def local_leaves(self, n: int, rank: int):
        """``(w1, b1, w2, b2)`` of this rank's ``E/n`` experts: the
        leaves themselves when they were cut to the rank's block, else
        the block of the whole stacks."""
        e_loc = self.num_experts // n
        leaves = (self.w1, self.b1, self.w2, self.b2)
        if self.w1.shape[0] == e_loc:
            return leaves
        return tuple(t.narrow(0, rank * e_loc, e_loc) for t in leaves)

    def forward(self, x):
        """``x``: ``[E, C, D]`` capacity slices -> ``[E, C, D]``."""
        return expert_ffn_apply(x, self.w1, self.b1, self.w2, self.b2,
                                self.activation)


class _MeanForward(torch.autograd.Function):
    """Forward: ``mean`` (the ep mean of ``local``); backward: the
    gradient goes to ``local`` on this rank only."""

    @staticmethod
    def forward(ctx, local, mean):
        return mean.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class MoELayer(Layer):
    """Gated mixture of experts.

    Routing: capacity-disciplined top-``top_k`` gating with an
    always-float32 router (the gate runs on a float32 view of the tokens
    under ``auto_cast(enable=False)``); ``aux_loss`` (GShard load
    balance) and ``z_loss`` (router logit magnitude) hold the last
    call's loss terms, ``router_stats`` its ``[drop, entropy, balance,
    load_0..E-1]`` and ``moe_vec`` ``[aux, z, drop, entropy, balance,
    load_0..E-1]``, float32. Dispatch: ``FLAGS_moe_dispatch`` or the
    ``dispatch_mode`` argument (sort or the einsum oracle).

    Experts: ``experts=ExpertFFN(...)`` (or ``num_experts`` +
    ``d_hidden``) stacks them, the expert-parallel form; ``experts=[
    module, ...]`` applies heterogeneous experts in a Python loop (one
    process only). Built as zeros on ``device`` (the card unless
    ``"cpu"``); :meth:`reset_parameters` draws the JAX defaults."""

    def __init__(self, d_model: int, experts=None, gate=None,
                 capacity_factor: float = 2.0, num_experts: int = None,
                 d_hidden: int = None, top_k: int = 2,
                 dispatch_mode: Optional[str] = None, name=None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        if experts is None:
            if not (num_experts and d_hidden):
                raise ValueError("pass experts= or num_experts+d_hidden")
            experts = ExpertFFN(num_experts, d_model, d_hidden, device=dev)
        if isinstance(experts, ExpertFFN):
            self.experts = experts
            self.num_experts = experts.num_experts
            self._stacked = True
        else:
            self.experts = experts if isinstance(experts, nn.ModuleList) \
                else nn.ModuleList(list(experts))
            self.num_experts = len(self.experts)
            self._stacked = False
        self._default_gate = gate is None
        self.gate = gate if gate is not None else Linear(
            d_model, self.num_experts, dev, bias_attr=False)
        self.capacity_factor = capacity_factor
        self.top_k = int(top_k)
        if dispatch_mode is not None:
            resolve_dispatch_mode(dispatch_mode)     # validate eagerly
        self.dispatch_mode = dispatch_mode
        self._label = name or "moe"
        self._aux_loss = None
        self._z_loss = None
        self._router_stats = None
        self._moe_vec = None
        self._last_tokens = 0

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The default gate's and stacked experts' JAX initializers
        (XavierUniform weights, zero biases)."""
        if self._default_gate:
            xavier_uniform_(self.gate.weight, generator)
        if self._stacked:
            self.experts.reset_parameters(generator)

    # last-call outputs
    @property
    def aux_loss(self):
        """GShard load-balance loss of the last forward."""
        return self._aux_loss

    @aux_loss.setter
    def aux_loss(self, v):
        self._aux_loss = v

    @property
    def z_loss(self):
        """Router z-loss (squared logsumexp) of the last forward."""
        return self._z_loss

    @property
    def router_stats(self):
        """``[drop_frac, entropy, balance_frac, load_0..E-1]`` float32."""
        return self._router_stats

    @property
    def moe_vec(self):
        """``[aux, z, drop, entropy, balance, load_0..E-1]`` float32."""
        return self._moe_vec

    def _capacity(self, tokens: int) -> int:
        return moe_capacity(tokens, self.capacity_factor, self.num_experts)

    # -- the mesh ------------------------------------------------------------
    def _ep_degree(self) -> int:
        mesh = dist_env.get_mesh()
        if mesh is not None and EP_AXIS in mesh.axis_names:
            return int(mesh.axis_size(EP_AXIS))
        return 1

    def _check_mesh(self, tokens: int) -> int:
        """The ep degree the layer runs at; raises on a mesh it does not
        compose with, and where the JAX layer would fall back."""
        mesh = dist_env.get_mesh()
        if mesh is None:
            return 1
        for axis, why in _REFUSED_AXES.items():
            if mesh.axis_size(axis) > 1:
                raise NotImplementedError(
                    f"an MoE layer on a mesh with {axis}="
                    f"{mesh.axis_size(axis)}: {why}; use dp, mp and ep")
        n = self._ep_degree()
        if n <= 1:
            return 1
        if not get_flag("moe_expert_parallel"):
            note_moe_fallback("flag_off")
        if not self._stacked:
            note_moe_fallback("heterogeneous_experts")
        if not self._default_gate:
            note_moe_fallback("custom_gate")
        if self.num_experts % n:
            note_moe_fallback("indivisible", f"E={self.num_experts} "
                              f"T={tokens * n} ep={n}")
        return n

    # -- forward -------------------------------------------------------------
    def forward(self, x):
        """``x`` ``[B, S, D]`` (on an ep mesh this rank's rows) ->
        ``[B, S, D]`` in the experts' promoted dtype."""
        B, S, D = x.shape
        tokens = B * S
        flat = x.reshape(tokens, D)
        n = self._check_mesh(tokens)
        if n > 1:
            out, aux, z, stats = self._expert_parallel_forward(flat, n)
        else:
            out, aux, z, stats = self._auto_forward(flat, tokens)
        self._aux_loss = aux
        self._z_loss = z
        self._router_stats = stats
        self._last_tokens = tokens
        self._moe_vec = torch.cat([torch.stack([aux, z]).to(torch.float32),
                                   stats])
        self._publish_stats()
        return out.reshape(B, S, out.shape[-1])

    def _router_logits(self, flat):
        """Float32 router: the gate takes a float32 view of the tokens
        with autocast off."""
        with auto_cast(enable=False):
            return self.gate(flat.to(torch.float32))

    def _dispatch(self, mode, flat, r, C):
        if mode == "einsum":
            return einsum_dispatch(flat, r, self.num_experts, C)
        return sort_dispatch(flat, r, self.num_experts, C)

    @staticmethod
    def _combine(mode, expert_out, r, C):
        if mode == "einsum":
            return einsum_combine(expert_out, r, C)
        return sort_combine(expert_out, r, C)

    def _auto_forward(self, flat, tokens: int):
        C = self._capacity(tokens)
        with record_function("moe_routing"):
            r = topk_routing(self._router_logits(flat), self.top_k, C)
        mode = resolve_dispatch_mode(self.dispatch_mode)
        MOE_STATS[f"{mode}_dispatches"] += 1
        with record_function("moe_dispatch"):
            expert_in = self._dispatch(mode, flat, r, C)
        with record_function("expert_ffn"):
            if self._stacked:
                expert_out = self.experts(expert_in)         # [E, C, D]
            else:
                expert_out = torch.stack(
                    [expert(expert_in[e]) for e, expert in
                     enumerate(self.experts)], 0)
        with record_function("moe_combine"):
            out = self._combine(mode, expert_out, r, C)
        return out, r.aux, r.z, r.stats

    # -- the explicit expert-parallel program ----------------------------
    def _expert_parallel_forward(self, flat, n: int):
        """This rank's part of the JAX ``_ep_program``: route the local
        tokens at the local capacity, send every capacity chunk's
        ``[n, E/n, C/chunks, D]`` blocks to the experts' ranks, run this
        rank's experts over what arrives, send the outputs home, combine
        locally; aux, z and stats the ep mean. Under the collective
        watchdog as ``moe.all_to_all`` on the ep group."""
        from ...distributed.collective import _run_collective
        mesh = dist_env.get_mesh()
        group = mesh.group(EP_AXIS)
        MOE_STATS["ep_dispatches"] += 1
        grad = torch.is_grad_enabled()

        def program():
            with torch.set_grad_enabled(grad):
                return self._ep_program(flat, n, group)
        return _run_collective("moe.all_to_all", group, program)

    def _ep_program(self, flat, n: int, group):
        from ...distributed.collective import alltoall
        T, D = flat.shape
        E, k = self.num_experts, self.top_k
        E_loc = E // n
        C = self._capacity(T)
        chunks = resolve_a2a_chunks(C)
        cs = C // chunks
        mode = resolve_dispatch_mode(self.dispatch_mode)
        w1, b1, w2, b2 = self.experts.local_leaves(n, group.rank)
        with record_function("moe_routing"):
            r = topk_routing(self._router_logits(flat), k, C)
        with record_function("moe_dispatch"):
            expert_in = self._dispatch(mode, flat, r, C)    # [E, C, D]
        # every chunk's tokens-out exchange before any expert computes,
        # each chunk's tokens-back exchange right after its FFN
        sent = [alltoall(expert_in[:, c * cs:(c + 1) * cs]
                         .reshape(n, E_loc, cs, D), group=group)
                for c in range(chunks)]               # [n(src), E_loc, cs, D]
        back = []
        for c in range(chunks):
            rec = sent[c].transpose(0, 1).reshape(E_loc, n * cs, D)
            with record_function("expert_ffn"):
                y = expert_ffn_apply(rec, w1, b1, w2, b2,
                                     self.experts.activation)
            y = y.reshape(E_loc, n, cs, -1).transpose(0, 1).contiguous()
            back.append(alltoall(y, group=group))    # [n(owner), E_loc, cs, D]
        expert_out = torch.cat([b.reshape(E, cs, -1) for b in back], dim=1)
        with record_function("moe_combine"):
            out = self._combine(mode, expert_out, r, C)
        aux, z, stats = self._ep_mean(r, group)
        return out, aux, z, stats

    def _ep_mean(self, r, group):
        """aux, z and stats averaged over the ep group in one all-reduce
        (their gradient stays local); the balance recomputed from the
        mean loads so the scalar agrees with the loads reported."""
        from ...distributed.collective import ReduceOp, all_reduce
        vec = torch.cat([r.aux.detach().reshape(1), r.z.detach().reshape(1),
                         r.stats]).to(torch.float32).clone()
        all_reduce(vec, ReduceOp.AVG, group)
        aux = _MeanForward.apply(r.aux, vec[0])
        z = _MeanForward.apply(r.z, vec[1])
        stats = vec[2:].clone()
        load = stats[len(STATS_FIELDS):]
        stats[2] = 1.0 - 0.5 * torch.sum(
            torch.abs(load - 1.0 / self.num_experts))
        return aux, z, stats

    # -- telemetry -------------------------------------------------------
    def _publish_stats(self) -> None:
        from ...monitor import enabled as _mon_enabled
        if self._router_stats is None or not _mon_enabled():
            return
        _publish_one(self, count_drops=True)


def _publish_row(stats_row, label: str, num_experts: int, registry=None,
                 dropped_assignments=None) -> None:
    """Publish one layer's router gauges from a stats row ``[drop_frac,
    entropy, balance_frac, load_0..E-1]`` (host floats), with the JAX
    package's names and labels."""
    from ...monitor import get_registry
    reg = registry or get_registry()
    s = [float(v) for v in stats_row]
    nf = len(STATS_FIELDS)
    reg.gauge("moe_router_drop_pct",
              "dropped (token, choice) assignments, % of T*k"
              ).set(100.0 * s[0], layer=label)
    reg.gauge("moe_router_entropy",
              "mean per-token routing entropy (nats)"
              ).set(s[1], layer=label)
    reg.gauge("moe_router_balance_pct",
              "expert-load balance: 100 * (1 - TV distance from "
              "uniform); 100 = perfectly balanced").set(
                  100.0 * s[2], layer=label)
    for e, v in enumerate(s[nf:nf + num_experts]):
        reg.gauge("moe_expert_load_share",
                  "per-expert share of kept assignments").set(
                      v, layer=label, expert=e)
    if dropped_assignments is not None:
        reg.counter("moe_dropped_tokens_total",
                    "capacity-overflow-dropped (token, choice) "
                    "assignments").inc(round(dropped_assignments),
                                       layer=label)


def _publish_one(layer: MoELayer, registry=None, count_drops=False) -> None:
    s = layer.router_stats.detach().double().cpu().numpy()
    dropped = (float(s[0]) * layer._last_tokens * layer.top_k
               if count_drops else None)
    _publish_row(s, layer._label, layer.num_experts, registry,
                 dropped_assignments=dropped)


def publish_router_stats(model, registry=None) -> int:
    """Publish the ``moe_router_*`` gauges of every MoE layer of
    ``model`` that has run a forward; returns the number published."""
    layers = [model] if isinstance(model, MoELayer) else \
        [m for m in model.modules() if isinstance(m, MoELayer)]
    count = 0
    for m in layers:
        if m.router_stats is None:
            continue
        _publish_one(m, registry)
        count += 1
    return count
