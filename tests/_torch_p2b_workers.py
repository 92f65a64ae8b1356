"""Rank bodies for the port's sequence-parallel, tensor-parallel encoder
and sharded-checkpoint tests (``test_torch_sequence_parallel.py``,
``test_torch_ernie_hybrid.py``, ``test_torch_checkpoint_manager.py``).

One gloo world of four ranks runs a file's cases in order (``run``, as
in ``_torch_dist_workers``) and pickles each rank's results; the tests
hold them against the JAX package in the parent. This module imports
torch and the port only, so a rank never loads JAX.
"""

import os

import torch

from _torch_dist_workers import run as _run


def run(out_dir: str, cases) -> None:
    """One rank of the world over this module's cases. A rank still
    running after ``WORLD_BUDGET_S`` (a peer failed and left it waiting
    in a collective) writes its stack to ``hung<r>.txt`` and exits, so
    the spawn fails instead of hanging."""
    import faulthandler
    import _torch_dist_workers
    hung = open(os.path.join(out_dir, f"hung{os.environ['RANK']}.txt"), "w")
    faulthandler.dump_traceback_later(WORLD_BUDGET_S, exit=True, file=hung)
    _torch_dist_workers.CASES.update(CASES)
    _run(out_dir, cases)
    faulthandler.cancel_dump_traceback_later()


WORLD_BUDGET_S = 240


def _fleet(**degrees):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    fleet.init(is_collective=True, strategy=strategy, backend="gloo")
    return fleet.get_hybrid_communicate_group()


def _reset():
    from paddle_tpu_torch.distributed import fleet
    fleet.reset()


# -- sequence parallelism --------------------------------------------------------
def case_sp_attention(rank, inputs, out_dir):
    """Ring and Ulysses attention over sp = 4, causal and not: each
    rank's output shard and its shard's gradients of ``sum(o * g)``."""
    from paddle_tpu_torch.ops.ring_attention import (ring_attention,
                                                     ulysses_attention)
    hcg = _fleet(sp=4)
    group = hcg.get_sequence_parallel_group()
    q, k, v, g = (torch.from_numpy(a) for a in inputs["sp_qkvg"])
    n = q.shape[1] // 4
    sl = slice(rank * n, (rank + 1) * n)
    out = {"sp_rank": hcg.get_sequence_parallel_rank()}
    for name, fn in (("ring", ring_attention), ("ulysses",
                                                ulysses_attention)):
        for causal in (False, True):
            ql, kl, vl = (t[:, sl].clone().requires_grad_()
                          for t in (q, k, v))
            o = fn(ql, kl, vl, group, causal=causal)
            (o * g[:, sl]).sum().backward()
            out[(name, causal)] = tuple(
                t.detach().numpy() for t in (o, ql.grad, kl.grad, vl.grad))
    return out


def _gpt_step(inputs, mesh, **over):
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_weights)
    from paddle_tpu_torch.optimizer import AdamW
    cfg = gpt_tiny(**dict(inputs["gpt_cfg"], **over))
    model = load_jax_weights(GPTForPretraining(cfg, device="cpu"),
                             inputs["gpt_weights"])
    crit = GPTPretrainingCriterion()
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)
    return TrainStep(model, lambda layer, i, t, *m: crit(layer(i), t, *m),
                     opt, seed=0, mesh=mesh,
                     data_spec=None if mesh is None else P("dp"))


def case_sp_gpt(rank, inputs, out_dir):
    """The sequence-parallel GPT at sp = 2 x mp = 2 and sp = 4: two steps
    at dropout 0 (against JAX) and at dropout 0.1 (against the port's
    single-process step), a masked batch at dropout 0.1; losses and, on
    rank 0, the gathered parameters; and the refusal of a step over the
    same GPT without ``sequence_parallel``."""
    out = {}
    for sp, mp in ((2, 2), (4, 1)):
        for tag, over, batch in (
                ("jax", {}, inputs["gpt_batch"]),
                ("dropout", {"hidden_dropout_prob": 0.1,
                             "attention_dropout_prob": 0.1},
                 inputs["gpt_batch"]),
                ("masked", {"hidden_dropout_prob": 0.1,
                            "attention_dropout_prob": 0.1},
                 inputs["gpt_masked"])):
            hcg = _fleet(sp=sp, mp=mp)
            step = _gpt_step(inputs, hcg.mesh, sequence_parallel=True,
                             **over)
            losses = [float(step(*batch)) for _ in range(2)]
            params = step.state_dict()["params"]
            out[(sp, mp, tag)] = {"losses": losses,
                                  "params": params if rank == 0 else None}
            _reset()
        out[(sp, mp, "refused")] = _refusal(
            lambda mesh: _gpt_step(inputs, mesh), sp=sp, mp=mp)
    return out


def _refusal(build, **degrees):
    """The message of the ``NotImplementedError`` that ``build(mesh)``
    raises on a fleet of ``degrees`` (None if it builds)."""
    hcg = _fleet(**degrees)
    try:
        build(hcg.mesh)
        msg = None
    except NotImplementedError as e:
        msg = str(e)
    _reset()
    return msg


# -- the tensor-parallel encoder -------------------------------------------------
def _ernie(inputs, mesh=None, stamp=True, seed=3, **over):
    from paddle_tpu_torch.distributed.spmd import apply_hybrid_specs
    from paddle_tpu_torch.models import (ErnieForPretraining, ernie_tiny,
                                         load_jax_weights)
    cfg = ernie_tiny(**dict(inputs["ernie_cfg"], **over))
    if "ernie_weights" in inputs and not over.get("hidden_dropout_prob"):
        m = load_jax_weights(ErnieForPretraining(cfg, device="cpu"),
                             inputs["ernie_weights"])
    else:
        m = ErnieForPretraining(cfg, device="cpu", seed=seed, mesh=mesh)
    if stamp:
        apply_hybrid_specs(m)
    return m


def _ernie_loss(amp: bool):
    from paddle_tpu_torch.amp import auto_cast

    def loss(layer, ids, tt, mask, pos, labels, w, sop):
        if amp:
            with auto_cast(level="O1"):
                return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
        return layer.loss(*layer(ids, tt, mask, pos), labels, sop, w)
    return loss


def _ernie_step(model, mesh, amp=False):
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01)
    if mesh is None:
        return TrainStep(model, _ernie_loss(amp), opt, seed=0)
    return TrainStep(model, _ernie_loss(amp), opt, seed=0, mesh=mesh,
                     data_spec=P(("dp", "sharding")), zero_axis="sharding")


def case_ernie_hybrid(rank, inputs, out_dir):
    """ERNIE through ``apply_hybrid_specs`` at sharding = 2 x mp = 2,
    ZeRO over sharding: 3 steps in f32 and under O1 from the JAX weights
    (dropout 0), 3 at dropout 0.1 from a model built with ``mesh=``; the
    stamped blocks' shapes; one backward's ``decoder_bias`` gradient;
    the same model without stamped specs (replicated); the refusal of a
    step at sp = 2 x mp = 2 (the encoder does not run
    sequence-parallel)."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import apply_param_shardings
    batch = [torch.from_numpy(a) for a in inputs["ernie_batch"]]
    out = {}
    for tag, amp in (("f32", False), ("o1", True)):
        hcg = _fleet(sharding=2, mp=2)
        step = _ernie_step(_ernie(inputs), hcg.mesh, amp)
        if tag == "f32":
            out["shapes"] = {k: tuple(p.shape)
                             for k, p in step.layer.named_parameters()}
            out["slot_shape"] = tuple(step.optimizer._accumulators[id(
                step.layer.ernie.embeddings.word_embeddings.weight)][0]
                .shape)
        losses = [float(step(*batch)) for _ in range(3)]
        params = step.state_dict()["params"]      # a collective
        out[tag] = {"losses": losses, "params": params if rank == 0
                    else None}
        _reset()
    hcg = _fleet(sharding=2, mp=2)
    step = _ernie_step(_ernie(inputs, hcg.mesh, hidden_dropout_prob=0.1,
                              attention_dropout_prob=0.1), hcg.mesh)
    losses = [float(step(*batch)) for _ in range(3)]
    params = step.state_dict()["params"]
    out["dropout"] = {"losses": losses,
                      "params": params if rank == 0 else None}
    _reset()
    hcg = _fleet(sharding=2, mp=2)
    m = apply_param_shardings(_ernie(inputs), hcg.mesh)
    r = hcg.get_sharding_parallel_rank()
    sub = [t[r * 2:(r + 1) * 2] for t in batch]
    _ernie_loss(False)(m, *sub).backward()
    got = []
    dist.all_gather_object(got, m.decoder_bias.grad.numpy())
    out["bias_grad"] = got
    out["bias_grad_mp_group"] = hcg.get_model_parallel_group().ranks
    _reset()
    hcg = _fleet(sharding=2, mp=2)
    plain = fleet.distributed_model(_ernie(inputs, stamp=False))
    out["replicated"] = tuple(
        plain._layers.ernie.encoder.layers[0].self_attn.q_proj.weight.shape)
    _reset()
    out["sp_refused"] = _refusal(
        lambda mesh: _ernie_step(_ernie(inputs), mesh), sp=2, mp=2)
    return out


# -- sharded checkpoints -----------------------------------------------------------
def case_reshard(rank, inputs, out_dir):
    """ERNIE at sharding = 2 x mp = 2, dropout 0.1: 2 steps, a sharded
    save (async, committed at ``wait``), 2 more; resumed from it at the
    same layout, at mp = 4 and (rank 0) in one process, 2 steps each."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    batch = [torch.from_numpy(a) for a in inputs["ernie_batch"]]
    drop = dict(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    path = os.path.join(out_dir, "reshard", "step_2")
    hcg = _fleet(sharding=2, mp=2)
    a = _ernie_step(_ernie(inputs, hcg.mesh, **drop), hcg.mesh)
    out = {"first": [float(a(*batch)) for _ in range(2)]}
    a.save_sharded(path, asynchronous=True)
    out["visible_before_wait"] = os.path.isdir(path)
    ckpt.wait()
    out["ref"] = [float(a(*batch)) for _ in range(2)]
    out["logical_bytes"] = sum(
        p.numel() * 4 * 3 for p in a.layer.parameters())
    out["local_shapes"] = [tuple(p.shape) for p in a.layer.parameters()]
    ref_state = [t.clone() for t in a.layer.parameters()]
    _reset()
    for tag, degrees, seed in (("same", dict(sharding=2, mp=2), 5),
                               ("mp4", dict(mp=4), 6)):
        hcg = _fleet(**degrees)
        b = _ernie_step(_ernie(inputs, hcg.mesh, seed=seed, **drop),
                        hcg.mesh)
        b.load_sharded(path)
        out[tag] = {"step_count": b.step_count,
                    "losses": [float(b(*batch)) for _ in range(2)]}
        if tag == "same":
            out[tag]["params_equal"] = all(
                torch.equal(x, y) for x, y in zip(ref_state,
                                                  b.layer.parameters()))
        _reset()
    if rank == 0:
        c = _ernie_step(_ernie(inputs, seed=7, **drop), None)
        c.load_sharded(path)
        out["one"] = [float(c(*batch)) for _ in range(2)]
    dist.barrier()
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
