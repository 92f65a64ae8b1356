"""Rank bodies for the port's multi-process CPU tests.

Each test file spawns ONE gloo world (``paddle_tpu_torch.distributed.
spawn`` with ``"_torch_dist_workers:run"``) that runs every case of the
file in order and pickles each rank's results to ``out/rank<r>.pkl``;
the tests then hold the results against the JAX package in the parent.
This module imports torch and the port only, so a rank never loads JAX.
"""

import os
import pickle
import traceback

import numpy as np
import torch

N = 4            # ranks of every world


def run(out_dir: str, cases) -> None:
    """One rank: start the gloo world from the launcher's environment
    (over a FileStore in ``out_dir``), run ``cases`` in order, write
    ``rank<r>.pkl`` ({case: result, or the traceback string})."""
    torch.set_num_threads(1)
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env(
        backend="gloo", init_method="file://" + os.path.join(out_dir,
                                                              "store"))
    rank = dist.get_rank()
    inputs = {}
    path = os.path.join(out_dir, "inputs.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            inputs = pickle.load(f)
    results = {}
    for name in cases:
        try:
            results[name] = CASES[name](rank, inputs, out_dir)
        except Exception:
            results[name] = "FAILED\n" + traceback.format_exc()
        _reset_fleet()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()


def write_env(path: str) -> None:
    """A spawn target: write the launcher's environment to a file."""
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_MASTER",
            "MASTER_PORT", "PADDLE_LOCAL_RANK", "RANK", "WORLD_SIZE",
            "LOCAL_WORLD_SIZE")
    with open(os.path.join(path, f"env_{os.environ['RANK']}"), "w") as f:
        f.write(",".join(os.environ[k] for k in keys))


def fail_on_rank_1() -> None:
    """A spawn target that raises on rank 1."""
    if os.environ["RANK"] == "1":
        raise ValueError("rank 1 gives up")


def _reset_fleet() -> None:
    from paddle_tpu_torch.distributed import fleet
    fleet.reset()


def _fleet(dp: int, mp: int, sharding: int = 1):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "sharding_degree": sharding}
    fleet.init(is_collective=True, strategy=strategy, backend="gloo")
    return fleet.get_hybrid_communicate_group()


# -- collectives -------------------------------------------------------------
def _per_rank():
    return np.random.RandomState(0).randn(N, 4, 3).astype(np.float32)


def case_collectives(rank, inputs, out_dir):
    import paddle_tpu_torch.distributed as dist
    x = _per_rank()
    mine = torch.from_numpy(x[rank])
    out = {}
    for name, op in (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX),
                     ("min", dist.ReduceOp.MIN), ("avg", dist.ReduceOp.AVG)):
        t = mine.clone()
        ret = dist.all_reduce(t, op=op)
        out["all_reduce_" + name] = t.numpy()
        out["in_place_" + name] = ret is t
    t = torch.from_numpy(np.abs(x[rank]) + 0.5)
    out["all_reduce_prod"] = dist.all_reduce(t, op=dist.ReduceOp.PROD).numpy()
    out["all_gather"] = dist.all_gather(mine.clone()).numpy()
    lst = []
    dist.all_gather(lst, mine.clone())
    out["all_gather_list"] = [t.numpy() for t in lst]
    out["broadcast"] = dist.broadcast(mine.clone(), src=3).numpy()
    out["reduce"] = dist.reduce(mine.clone(), dst=2).numpy()
    blocks = np.random.RandomState(1).randn(N, N, 2).astype(np.float32)
    out["alltoall"] = dist.alltoall(torch.from_numpy(blocks[rank])).numpy()
    out["alltoall_list"] = [t.numpy() for t in dist.alltoall(
        list(torch.from_numpy(blocks[rank]).unbind(0)))]
    out["shift+1"] = dist.ppermute_shift(mine.clone(), shift=1).numpy()
    out["shift-1"] = dist.ppermute_shift(mine.clone(), shift=-1).numpy()
    recv = torch.zeros(4, 3)
    dist.scatter(recv, list(torch.from_numpy(x).unbind(0))
                 if rank == 1 else None, src=1)
    out["scatter_list"] = recv.numpy()
    sub = dist.new_group(ranks=[0, 2])
    if rank in (0, 2):
        t = mine.clone()
        dist.all_reduce(t, group=sub)
        out["subset"] = t.numpy()
    out["subset_nranks"] = sub.nranks
    buf = torch.zeros(3)
    if rank % 2 == 0:
        dist.send(torch.tensor([1.0, 2.0, 3.0]) * (rank + 1), dst=rank + 1)
    else:
        dist.recv(buf, src=rank - 1)
    out["recv"] = buf.numpy()
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    out["objects"] = objs
    out["arrays"] = [a.numpy() for a in dist.all_reduce_arrays(
        [mine, mine * 2])]
    dist.barrier()
    out["wait_is_identity"] = dist.wait(mine) is mine
    out["world"] = (dist.get_world_size(), dist.get_group(0).nranks)
    return out


def case_topology(rank, inputs, out_dir):
    hcg = _fleet(2, 2)
    out = {"coord": hcg.topology().get_coord(rank),
           "dp_rank": hcg.get_data_parallel_rank(),
           "mp_rank": hcg.get_model_parallel_rank(),
           "dp_group": hcg.get_data_parallel_group().ranks,
           "mp_group": hcg.get_model_parallel_group().ranks,
           "mode": hcg.get_parallel_mode()}
    import paddle_tpu_torch.distributed as dist
    t = torch.full((1,), float(rank))
    dist.all_reduce(t, group=hcg.get_model_parallel_group())
    out["mp_sum"] = float(t)
    return out


def case_data_parallel(rank, inputs, out_dir):
    from paddle_tpu_torch.distributed import DataParallel
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(1.0)
        lin.bias.zero_()
    dp = DataParallel(lin)
    x = torch.full((2, 3), float(rank + 1))
    with dp.no_sync():
        dp(x).sum().backward()
        dp.apply_collective_grads()            # deferred: stays local
    local = lin.weight.grad.clone()
    dp.apply_collective_grads()
    return {"local": local.numpy(), "synced": lin.weight.grad.numpy()}


def case_watchdog(rank, inputs, out_dir):
    """The chaos hang under a 0.5 s budget on every rank: each raises
    CollectiveTimeoutError; the abandoned calls never start their
    collective, so the group's next one is matched on every rank."""
    import time

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.distributed.collective import \
        CollectiveTimeoutError
    from paddle_tpu_torch.testing import chaos
    g = dist.new_group()
    t0 = time.perf_counter()
    err = None
    with flag_scope("collective_timeout_s", 0.5):
        chaos.configure("collective.hang@1")
        try:
            dist.all_reduce(torch.ones(2), group=g)
        except CollectiveTimeoutError as e:
            err = (type(e).__name__, e.op, e.group_axis, e.timeout_s)
        finally:
            chaos.reset()
    secs = time.perf_counter() - t0
    t = torch.ones(1)
    dist.all_reduce(t, group=g)
    return {"error": err, "seconds": secs, "after": float(t)}


# -- GPT ---------------------------------------------------------------------
def _gpt(inputs, **over):
    from paddle_tpu_torch.models import (GPTForPretraining, gpt_tiny,
                                         load_jax_weights)
    cfg = gpt_tiny(**dict(inputs["cfg"], **over))
    return load_jax_weights(GPTForPretraining(cfg, device="cpu"),
                            inputs["weights"])


def _loss_fn():
    from paddle_tpu_torch.models import GPTPretrainingCriterion
    crit = GPTPretrainingCriterion()
    return lambda layer, ids, labels, *mask: crit(layer(ids), labels, *mask)


def _mp_gather_last(t, hcg):
    import paddle_tpu_torch.distributed as dist
    blocks = dist.all_gather(t.contiguous(),
                             group=hcg.get_model_parallel_group())
    return torch.cat(list(blocks.unbind(0)), -1)


def case_tp_logits(rank, inputs, out_dir):
    """mp = 4 through ``fleet.distributed_model`` (TensorParallel), dp =
    2 x mp = 2 through ``apply_param_shardings``."""
    from paddle_tpu_torch.distributed import apply_param_shardings, fleet
    out = {}
    for dp, mp in ((1, 4), (2, 2)):
        hcg = _fleet(dp, mp)
        if mp == 4:
            model = fleet.distributed_model(_gpt(inputs)).eval()
            out["wrapper"] = (type(model).__name__,
                              sorted(model.state_dict()) ==
                              sorted(inputs["weights"]))
        else:
            model = apply_param_shardings(_gpt(inputs), hcg.mesh).eval()
        ids = torch.from_numpy(inputs["ids"])
        b = ids.shape[0] // dp
        r = hcg.get_data_parallel_rank()
        with torch.no_grad():
            logits = model(ids[r * b:(r + 1) * b])
        out[(dp, mp)] = {
            "dp_rank": r, "logits": _mp_gather_last(logits, hcg).numpy(),
            "qkv_shape": tuple(dict(model.named_parameters())[
                "gpt.layers.0.attn.qkv_weight"].shape)}
        _reset_fleet()
    return out


def _train(inputs, dp, mp, steps, batches, opt_kw=None, clip=None,
           sharding=1, **step_kw):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    hcg = _fleet(dp, mp, sharding)
    model = _gpt(inputs, **(opt_kw or {}))
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=None if clip is None
                else ClipGradByGlobalNorm(clip))
    if sharding > 1:
        # ZeRO over the sharding axis, the batch over dp and sharding
        step = TrainStep(fleet.distributed_model(model), _loss_fn(), opt,
                         seed=0, mesh=hcg.mesh,
                         data_spec=P(("dp", "sharding")),
                         zero_axis="sharding", **step_kw)
    else:
        step = TrainStep(model, _loss_fn(), opt, seed=0, mesh=hcg.mesh,
                         data_spec=P("dp"), zero_axis="dp", **step_kw)
    losses = [float(step(*batches[i % len(batches)])) for i in range(steps)]
    return step, losses


def case_train_jax(rank, inputs, out_dir):
    """dp=2 x mp=2, ZeRO-1 over dp, the clip at 0.5, dropout off."""
    step, losses = _train(inputs, 2, 2, 3, [inputs["batch"]], clip=0.5)
    w_in = step.layer.gpt.layers[0].mlp.w_in
    slot = step.optimizer._accumulators[id(w_in)][0]
    path = os.path.join(out_dir, "train_jax.pdparams")
    step.save(path)
    state = step.state_dict()
    return {"losses": losses, "params": state["params"] if rank == 0
            else None, "w_in": tuple(w_in.shape),
            "w_in_slot": tuple(slot.shape), "path": path,
            "opt_keys": sorted(state["opt_state"]) if rank == 0 else None}


def case_train_sharding(rank, inputs, out_dir):
    """dp = 2 x sharding = 2 through ``ShardingParallel``: ZeRO-1 over
    sharding, the batch over both axes, the clip at 0.5."""
    step, losses = _train(inputs, 2, 1, 3, [inputs["batch"]], clip=0.5,
                          sharding=2)
    w_in = step.layer._layers.gpt.layers[0].mlp.w_in
    slot = step.optimizer._accumulators[id(w_in)][0]
    state = step.state_dict()
    return {"losses": losses, "mode": type(step.layer).__name__,
            "w_in_slot": tuple(slot.shape),
            "params": state["params"] if rank == 0 else None}


def case_mp_layers(rank, inputs, out_dir):
    """The mp layers at mp = 4 against their dense products from the
    same full weights: a column layer (gathered and not) into a row
    layer (given the full input and the split one), the vocab-sharded
    embedding and ``split``; outputs and each rank's gradient blocks."""
    from paddle_tpu_torch.distributed import apply_param_shardings, split
    from paddle_tpu_torch.distributed.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    hcg = _fleet(1, 4)
    g = torch.Generator().manual_seed(0)
    col = ColumnParallelLinear(8, 16, device="cpu", generator=g)
    col_split = ColumnParallelLinear(8, 16, gather_output=False,
                                     device="cpu", generator=g)
    row = RowParallelLinear(16, 8, device="cpu", generator=g)
    row_split = RowParallelLinear(16, 8, input_is_parallel=True,
                                  device="cpu", generator=g)
    emb = VocabParallelEmbedding(32, 8, device="cpu", generator=g)
    layers = (col, col_split, row, row_split, emb)
    with torch.no_grad():
        for lyr in layers:
            for p in lyr.parameters():
                p.normal_(0.0, 0.5, generator=g)
    full = [{k: p.detach().clone() for k, p in lyr.named_parameters()}
            for lyr in layers]
    for lyr in layers:
        apply_param_shardings(lyr, hcg.mesh)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(1))
    ids = torch.tensor([[0, 9, 17, 31], [8, 16, 24, 5]])
    y = row(col(x))
    z = row_split(col_split(x))
    e = emb(ids)
    (y.square().sum() + z.square().sum() + e.square().sum()).backward()
    torch.manual_seed(5)
    s = split(ids, (32, 8), "embedding")
    torch.manual_seed(5)
    s_ref = torch.empty(32, 8).normal_(0.0, 0.02)[ids]
    # the dense products and their gradients, in float64
    fc, fcs, fr, frs, fe = [{k: v.double().requires_grad_(True)
                             for k, v in d.items()} for d in full]
    xd = x.double()
    yd = (xd @ fc["weight"] + fc["bias"]) @ fr["weight"] + fr["bias"]
    zd = (xd @ fcs["weight"] + fcs["bias"]) @ frs["weight"] + frs["bias"]
    ed = fe["weight"][ids]
    (yd.square().sum() + zd.square().sum() + ed.square().sum()).backward()
    n = 16 // 4

    def err(a, b):
        b = b.detach()
        return float((a.double() - b).abs().max() / b.abs().max())
    return {
        "y": err(y, yd), "z": err(z, zd), "e": err(e, ed),
        "split": err(s, s_ref.double()),
        "col_w": err(col.weight.grad,
                     fc["weight"].grad[:, rank * n:(rank + 1) * n]),
        "col_b": err(col.bias.grad, fc["bias"].grad[rank * n:(rank + 1) * n]),
        "row_w": err(row.weight.grad,
                     fr["weight"].grad[rank * n:(rank + 1) * n]),
        "row_b": err(row.bias.grad, fr["bias"].grad),
        "emb_w": err(emb.weight.grad,
                     fe["weight"].grad[rank * 8:(rank + 1) * 8]),
        "shapes": (tuple(col.weight.shape), tuple(row.weight.shape),
                   tuple(emb.weight.shape))}


def case_train_dropout(rank, inputs, out_dir):
    """The same world with dropout 0.1: the port's single-process step's
    masks, sliced by dp rank and mp heads."""
    step, losses = _train(inputs, 2, 2, 3, [inputs["batch"]],
                          opt_kw=dict(hidden_dropout_prob=0.1,
                                      attention_dropout_prob=0.1))
    state = step.state_dict()
    return {"losses": losses,
            "params": state["params"] if rank == 0 else None}


def case_masked(rank, inputs, out_dir):
    """A loss mask that keeps more positions on dp rank 0's rows than on
    rank 1's: dp=2 x mp=2, 2 steps."""
    step, losses = _train(inputs, 2, 2, 2, [inputs["masked"]])
    state = step.state_dict()
    return {"losses": losses,
            "params": state["params"] if rank == 0 else None}


def case_accum(rank, inputs, out_dir):
    """grad_accum_steps=2 over two batches, one update."""
    step, losses = _train(inputs, 2, 2, 2, inputs["halves"],
                          grad_accum_steps=2)
    state = step.state_dict()
    return {"losses": losses, "steps": step.step_count,
            "microsteps": step.stats()["microsteps"],
            "params": state["params"] if rank == 0 else None}


def case_clip_norm(rank, inputs, out_dir):
    """The clip's global norm of an mp=4 model's gradients."""
    from paddle_tpu_torch.distributed import apply_param_shardings
    from paddle_tpu_torch.distributed.meta_parallel.parallel_layers.mp_layers \
        import mp_group_of
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm
    hcg = _fleet(1, 4)
    model = apply_param_shardings(_gpt(inputs), hcg.mesh)
    loss = _loss_fn()(model, *[torch.from_numpy(a)
                               for a in inputs["batch"]])
    loss.backward()
    params = list(model.parameters())
    grads = {i: p.grad for i, p in enumerate(params)}
    sharded = {i for i, p in enumerate(params) if p._dist_layout}
    clip = ClipGradByGlobalNorm(1.0)
    norm = clip.global_norm(grads, sharded, mp_group_of(hcg.mesh))
    return {"norm": float(norm), "n_sharded": len(sharded)}


def case_vocab_ce(rank, inputs, out_dir):
    """The vocab-parallel loss and its gradient on an mp=4 block (the
    group given, and marked on the block as a sharded head marks it);
    under the same mesh, whole logits take the single-device loss and an
    unmarked block whose labels run past it is refused."""
    from paddle_tpu_torch.distributed.meta_parallel import \
        ParallelCrossEntropy
    from paddle_tpu_torch.distributed.meta_parallel.parallel_layers.mp_layers \
        import mark_mp_block
    hcg = _fleet(1, 4)
    group = hcg.get_model_parallel_group()
    logits, labels = inputs["ce"]
    lab = torch.from_numpy(labels)
    V = logits.shape[-1] // N
    out = {}
    for how in ("given", "marked"):
        block = torch.from_numpy(logits[..., rank * V:(rank + 1) * V].copy())
        block.requires_grad_(True)
        if how == "given":
            loss = ParallelCrossEntropy(mp_group=group)(block, lab)
        else:
            loss = ParallelCrossEntropy()(mark_mp_block(block * 1.0, group),
                                          lab)
        loss.mean().backward()
        out[how] = {"loss": loss.detach().numpy(),
                    "grad": block.grad.numpy()}
    whole = torch.from_numpy(logits)
    out["whole"] = ParallelCrossEntropy()(whole, lab).numpy()
    try:
        ParallelCrossEntropy()(torch.from_numpy(
            logits[..., rank * V:(rank + 1) * V].copy()), lab)
        out["unmarked"] = None
    except ValueError as e:
        out["unmarked"] = str(e)
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
