"""Rank bodies for the port's expert-parallel MoE tests
(``test_torch_moe.py``).

One gloo world of four ranks runs the file's cases in order (``run``, as
in ``_torch_dist_workers``) and pickles each rank's results; the tests
hold them against the JAX package's explicit expert-parallel program in
the parent. This module imports torch and the port only, so a rank never
loads JAX. An ep mesh of ``n`` < 4 ranks leaves the other ranks out of
its cases (they still build its groups, which every rank must).
"""

import os

import numpy as np
import torch

from _torch_dist_workers import run as _run

WORLD_BUDGET_S = 240

#: the layer cases' shapes: tokens [B, S, D] over E experts of hidden H
D, E, H, B, S = 16, 8, 32, 8, 32
#: the GPT cases' AdamW rate, and the clipped SGD's rate and norm
LR, SGD_LR, CLIP = 1e-4, 0.1, 0.5


def run(out_dir: str, cases) -> None:
    """One rank of the world over this module's cases; a rank still
    running after ``WORLD_BUDGET_S`` writes its stack to ``hung<r>.txt``
    and exits."""
    import faulthandler
    import _torch_dist_workers
    hung = open(os.path.join(out_dir, f"hung{os.environ['RANK']}.txt"), "w")
    faulthandler.dump_traceback_later(WORLD_BUDGET_S, exit=True, file=hung)
    _torch_dist_workers.CASES.update(CASES)
    _run(out_dir, cases)
    faulthandler.cancel_dump_traceback_later()


def _mesh(axes):
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.spmd import make_mesh
    mesh = make_mesh(axes)
    env.set_mesh(mesh)
    return mesh


def _reset():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.incubate.moe import reset_moe_stats
    from paddle_tpu_torch.testing import chaos
    fleet.reset()
    reset_moe_stats()
    chaos.reset()


def _layer(inputs, cf, mesh=None, **kw):
    """The JAX layer's weights in a port ``MoELayer``; with ``mesh``
    cut to this rank's experts."""
    from paddle_tpu_torch.distributed.spmd import apply_param_shardings
    from paddle_tpu_torch.incubate.moe import MoELayer
    from paddle_tpu_torch.models import load_jax_weights
    m = load_jax_weights(MoELayer(D, num_experts=E, d_hidden=H,
                                  capacity_factor=cf, device="cpu", **kw),
                         inputs["moe_weights"])
    if mesh is not None:
        apply_param_shardings(m, mesh)
    return m


# the (ep, dispatch, capacity factor, router losses in the loss, leaves
# cut) runs of case_ep_layer: cf 0.5 drops, cf E (8.0) is ample
EP_RUNS = ((2, "sort", 0.5, True, False), (4, "sort", 0.5, True, True),
           (4, "einsum", 0.5, True, True), (2, "sort", 8.0, False, False),
           (4, "sort", 8.0, False, True))


def case_ep_layer(rank, inputs, out_dir):
    """Each run of ``EP_RUNS``: this rank's rows of the global tokens
    through the layer, ``loss = mean(out^2)`` (+ 0.01 aux + 1e-3 z),
    backward; the gradients scaled to the global loss's (x and the
    expert blocks divided by n, the gate averaged over ep)."""
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.distributed.collective import ReduceOp, all_reduce
    from paddle_tpu_torch.incubate.moe import MOE_STATS, reset_moe_stats
    x = inputs["moe_x"]
    out = {}
    for n, mode, cf, router, cut in EP_RUNS:
        mesh = _mesh({"ep": n})
        if rank < n:
            reset_moe_stats()
            m = _layer(inputs, cf, mesh if cut else None)
            rows = B // n
            xl = torch.from_numpy(x[rank * rows:(rank + 1) * rows].copy())
            xl.requires_grad_()
            with flag_scope("moe_dispatch", mode):
                o = m(xl)
            loss = o.square().mean()
            if router:
                loss = loss + 0.01 * m.aux_loss + 1e-3 * m.z_loss
            loss.backward()
            g = m.gate.weight.grad.clone()
            all_reduce(g, ReduceOp.AVG, mesh.group("ep"))
            e_loc = E // n
            blk = slice(0, e_loc) if cut else slice(rank * e_loc,
                                                    (rank + 1) * e_loc)
            out[(n, mode, cf)] = {
                "out": o.detach().numpy(), "aux": float(m.aux_loss.detach()),
                "z": float(m.z_loss.detach()),
                "stats": m.router_stats.numpy(),
                "x_grad": xl.grad.numpy() / n, "gate_grad": g.numpy(),
                "w1_grad": m.experts.w1.grad[blk].numpy() / n,
                "b2_grad": m.experts.b2.grad[blk].numpy() / n,
                "w1_shape": tuple(m.experts.w1.shape),
                "stats_moe": dict(MOE_STATS)}
        _reset()
    return out


def case_scatter_gather(rank, inputs, out_dir):
    """``global_scatter`` / ``global_gather`` over ep = 4 on this rank's
    16 rows (uniform counts): the exchanged rows, the round trip, and
    the gradient of ``sum(scatter(x) * w)``."""
    from paddle_tpu_torch.incubate.moe import global_gather, global_scatter
    _mesh({"ep": 4})
    x = torch.from_numpy(inputs["sg_x"][rank].copy()).requires_grad_()
    w = torch.from_numpy(inputs["sg_w"][rank].copy())
    counts = np.full(4, 4)
    sent = global_scatter(x, counts, counts)
    back = global_gather(sent, None, None)
    (sent * w).sum().backward()
    res = {"sent": sent.detach().numpy(), "back": back.detach().numpy(),
           "x_grad": x.grad.numpy()}
    _reset()
    return res


def _gpt_step(inputs, mesh, clipped=False):
    """The MoE GPT's ``TrainStep`` on ``mesh``: AdamW, or with
    ``clipped`` SGD under the global-norm clip (whose update scales with
    the norm, where Adam's would not)."""
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_weights)
    from paddle_tpu_torch.optimizer import SGD, AdamW, ClipGradByGlobalNorm
    cfg = gpt_tiny(**inputs["gpt_cfg"])
    model = load_jax_weights(GPTForPretraining(cfg, device="cpu"),
                             inputs["gpt_weights"])
    crit = GPTPretrainingCriterion()

    def loss_fn(layer, ids, labels):
        return crit(layer(ids), labels) + layer.moe_loss()
    opt = SGD(SGD_LR, parameters=model.parameters(),
              grad_clip=ClipGradByGlobalNorm(CLIP)) if clipped else \
        AdamW(LR, parameters=model.parameters())
    return TrainStep(model, loss_fn, opt, mesh=mesh, data_spec=P("ep"))


def case_gpt_ep(rank, inputs, out_dir):
    """The MoE GPT through ``TrainStep`` on ep = 2 and ep = 4
    (``data_spec=P("ep")``): two steps on the global batch, the losses
    and the gathered parameters; the expert blocks' local shape; at ep =
    4 also under the clipped SGD, with the global norm the clip read."""
    from paddle_tpu_torch.incubate.moe import MOE_STATS
    out = {}
    for n, clipped in ((2, False), (4, False), (4, True)):
        mesh = _mesh({"ep": n})
        if rank < n:
            step = _gpt_step(inputs, mesh, clipped)
            clip, norms = step.optimizer._grad_clip, []
            if clip is not None:
                norm = clip.global_norm
                clip.global_norm = lambda *a: norms.append(
                    float(norm(*a))) or norm(*a)
            losses = [float(step(*inputs["gpt_batch"])) for _ in range(2)]
            params = step.state_dict()["params"]
            out[(n, clipped)] = {
                "losses": losses, "ep_degree": step._ep_degree,
                "params": params if rank == 0 else None, "norms": norms,
                "w1_shape": tuple(step.layer.gpt.layers[0].moe.experts
                                  .w1.shape),
                "ep_dispatches": MOE_STATS["ep_dispatches"]}
        _reset()
    return out


def case_gpt_mp(rank, inputs, out_dir):
    """The MoE GPT through ``TrainStep`` under SGD (its update scales with
    the gradient, so a missing or doubled mp reduction shows), two steps:
    at dp = 1 x mp = 2 (ranks 0-1) with ``crit + moe_loss``, and at ep =
    2 x mp = 2 (``data_spec=P("ep")``) at capacity factor 8 (no drops)
    with ``crit`` alone. Losses and the gathered parameters, rank 0's."""
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_weights)
    from paddle_tpu_torch.optimizer import SGD
    out = {}
    for name, axes, cf, spec in (("mp", {"mp": 2}, None, P("dp")),
                                 ("ep_mp", {"ep": 2, "mp": 2}, 8.0,
                                  P("ep"))):
        mesh = _mesh(axes)
        n = int(np.prod(list(axes.values())))
        if rank < n:
            cfg = dict(inputs["gpt_cfg"])
            if cf is not None:
                cfg["moe_capacity_factor"] = cf
            model = load_jax_weights(
                GPTForPretraining(gpt_tiny(**cfg), device="cpu"),
                inputs["gpt_weights"])
            crit = GPTPretrainingCriterion()
            aux = cf is None

            def loss_fn(layer, ids, labels):
                loss = crit(layer(ids), labels)
                return loss + layer.moe_loss() if aux else loss
            step = TrainStep(model, loss_fn, SGD(SGD_LR, parameters=
                                                 model.parameters()),
                             mesh=mesh, data_spec=spec)
            losses = [float(step(*inputs["gpt_batch"])) for _ in range(2)]
            params = step.state_dict()["params"]
            out[name] = {"losses": losses,
                         "params": params if rank == 0 else None,
                         "w1": tuple(model.gpt.layers[0].moe.experts.w1
                                     .shape),
                         "qkv": tuple(model.gpt.layers[0].attn.qkv_weight
                                      .shape)}
        _reset()
    return out


def case_ckpt(rank, inputs, out_dir):
    """ep = 4: a ``CheckpointManager`` saves the sharded state (the
    expert blocks a rank's own) every 2 steps over 4 steps; a fresh step
    resumes from step 4 and runs 2 more, against 6 uninterrupted steps."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    root = os.path.join(out_dir, "moe_ckpt")
    batch = inputs["gpt_batch"]
    mesh = _mesh({"ep": 4})
    ref_step = _gpt_step(inputs, mesh)
    ref = [float(ref_step(*batch)) for _ in range(6)]
    _reset()
    mesh = _mesh({"ep": 4})
    a = _gpt_step(inputs, mesh)
    with CheckpointManager(a, root, interval_steps=2, keep_n=2) as mgr:
        first = []
        for i in range(4):
            first.append(float(a(*batch)))
            mgr.on_step(dataloader_state={"offset": i + 1})
    _reset()
    mesh = _mesh({"ep": 4})
    b = _gpt_step(inputs, mesh)
    with CheckpointManager(b, root, interval_steps=2, keep_n=2) as mgr:
        info = mgr.resume()
        rest = [float(b(*batch)) for _ in range(2)]
    files = sorted(os.listdir(os.path.join(root, "step_4")))
    _reset()
    return {"ref": ref, "first": first, "rest": rest, "step": info["step"],
            "files": files}


def case_hang(rank, inputs, out_dir):
    """The chaos ``collective.hang`` drill on ep = 4: at the layer's
    expert exchange (op ``moe.all_to_all``) under a 1 s budget, and at a
    ``TrainStep``'s dispatch (op ``moe_step``) under 10 s; every rank
    arms its own injector, so every rank abandons the call before its
    first collective and the world stays in step."""
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.distributed.collective import \
        CollectiveTimeoutError
    from paddle_tpu_torch.testing import chaos
    out = {}
    mesh = _mesh({"ep": 4})
    m = _layer(inputs, 2.0, mesh)
    rows = B // 4
    xl = torch.from_numpy(inputs["moe_x"][rank * rows:(rank + 1) * rows]
                          .copy())
    with torch.no_grad(), flag_scope("collective_timeout_s", 1.0):
        out["healthy"] = bool(torch.isfinite(m(xl + 1.0)).all())
        chaos.arm("collective.hang", at=1)
        try:
            m(xl + 2.0)
            out["layer"] = None
        except CollectiveTimeoutError as e:
            out["layer"] = (e.op, e.group_axis, e.timeout_s)
    chaos.reset()
    step = _gpt_step(inputs, mesh)
    out["ep_degree"] = step._ep_degree
    float(step(*inputs["gpt_batch"]))
    with flag_scope("collective_timeout_s", 10.0):
        float(step(*inputs["gpt_batch"]))
        chaos.arm("collective.hang", at=1)
        try:
            step(*inputs["gpt_batch"])
            out["step"] = None
        except CollectiveTimeoutError as e:
            out["step"] = (e.op, e.group_axis, e.timeout_s)
    _reset()
    return out


def case_refused(rank, inputs, out_dir):
    """Where the JAX layer falls back to its auto path on an ep mesh the
    port raises ``NotImplementedError`` naming the reason; an MoE layer
    on a mesh with pp or sp above 1 raises too, and one on mp x ep runs
    (its entry None)."""
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.incubate.moe import MOE_STATS, MoELayer
    from paddle_tpu_torch.nn.layers.common import Linear
    x = torch.from_numpy(inputs["moe_x"][:2].copy())
    out = {"fallbacks": 0}

    def attempt(tag, build, mesh_axes):
        _mesh(mesh_axes)
        try:
            build()(x)
            out[tag] = None
        except NotImplementedError as e:
            out[tag] = str(e)
        out["fallbacks"] += MOE_STATS["fallbacks"]
        _reset()
    attempt("heterogeneous_experts", lambda: MoELayer(
        D, [Linear(D, D, "cpu") for _ in range(E)], device="cpu"),
        {"ep": 4})
    attempt("custom_gate", lambda: MoELayer(
        D, num_experts=E, d_hidden=H, gate=Linear(D, E, "cpu"),
        device="cpu"), {"ep": 4})
    attempt("indivisible", lambda: MoELayer(
        D, num_experts=6, d_hidden=H, device="cpu"), {"ep": 4})
    with flag_scope("moe_expert_parallel", False):
        attempt("flag_off", lambda: _layer(inputs, 2.0), {"ep": 4})
    for ax in ("mp", "pp", "sp"):
        attempt(ax, lambda: _layer(inputs, 2.0), {ax: 2, "ep": 2})
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
