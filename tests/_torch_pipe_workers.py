"""Rank bodies for the port's pipeline tests (``test_torch_pipeline.py``).

One gloo world of four ranks runs every case in order (``run``, as in
``_torch_dist_workers``) and pickles each rank's results; the tests
hold them against the JAX package in the parent. This module imports
torch and the port only, so a rank never loads JAX.
"""

import os

import numpy as np
import torch

from _torch_dist_workers import run as _run


def run(out_dir: str, cases) -> None:
    """One rank of the world over this module's cases. A rank still
    running after ``WORLD_BUDGET_S`` (a peer failed and left it waiting
    on a handoff) writes its stack to ``hung<r>.txt`` and exits, so the
    spawn fails instead of hanging."""
    import faulthandler
    import _torch_dist_workers
    hung = open(os.path.join(out_dir, f"hung{os.environ['RANK']}.txt"), "w")
    faulthandler.dump_traceback_later(WORLD_BUDGET_S, exit=True, file=hung)
    _torch_dist_workers.CASES.update(CASES)
    _run(out_dir, cases)
    faulthandler.cancel_dump_traceback_later()


WORLD_BUDGET_S = 300


def _fleet(pp=1, mp=1, dp=1, sharding=1, schedule=None):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": pp, "sharding_degree": sharding}
    if schedule is not None:
        strategy.pipeline_configs = {"schedule_mode": schedule}
    fleet.init(is_collective=True, strategy=strategy, backend="gloo")
    return fleet.get_hybrid_communicate_group()


def _reset():
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.meta_parallel import spmd_pipeline
    fleet.reset()
    spmd_pipeline.reset_pipeline_stats()


def case_pipe_topology(rank, inputs, out_dir):
    """pp = 2 x mp = 2, sharding = 2 x mp = 2 and sp = 2 x mp = 2
    build."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    out = {}
    hcg = _fleet(pp=2, mp=2)
    t = torch.full((1,), float(rank))
    dist.all_reduce(t, group=hcg.get_model_parallel_group())
    out["pp_mp"] = {
        "coord": hcg.topology().get_coord(rank),
        "stage": hcg.get_stage_id(), "mode": hcg.get_parallel_mode(),
        "pp_group": hcg.get_pipe_parallel_group().ranks,
        "mp_group": hcg.get_model_parallel_group().ranks,
        "prev": hcg.get_prev_stage_rank(), "next": hcg.get_next_stage_rank(),
        "p2p": [g.ranks for g in hcg.get_p2p_groups()], "mp_sum": float(t)}
    _reset()
    hcg = _fleet(sharding=2, mp=2)
    out["sharding_mp"] = {"mode": hcg.get_parallel_mode(),
                          "sharding_group":
                              hcg.get_sharding_parallel_group().ranks}
    _reset()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"sp_degree": 2, "mp_degree": 2}
    fleet.init(strategy=strategy, backend="gloo")
    hcg = fleet.get_hybrid_communicate_group()
    out["sp"] = {"sp_group": hcg.get_sequence_parallel_group().ranks,
                 "sp_rank": hcg.get_sequence_parallel_rank(),
                 "sp_size": hcg.get_sequence_parallel_world_size()}
    return out


def case_p2p(rank, inputs, out_dir):
    """Tagged transfers between ranks 0 and 1 posted in one order and
    received in the other; the route of a CPU tensor; the tuple-axis
    gather at dp = 2 x sharding = 2."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective, spmd
    out = {"route": collective.p2p_route(torch.zeros(1))}
    if rank == 0:
        works = [dist.collective.isend(torch.full((3,), float(t)), 1, tag=t)
                 for t in (5, 2, 9)]
        for w in works:
            w.wait()
    elif rank == 1:
        got = {}
        for t in (9, 2, 5):
            buf = torch.zeros(3)
            dist.recv(buf, 0, tag=t)
            got[t] = buf.tolist()
        out["got"] = got
    dist.barrier()
    hcg = _fleet(dp=2, sharding=2)
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    layout = {0: ("dp", "sharding")}
    mine = spmd.shard_tensor(full, layout, hcg.mesh)
    out["block"] = mine.numpy().copy()
    out["gathered"] = spmd.gather_tensor(mine.contiguous(), layout,
                                         hcg.mesh).numpy()
    return out


# -- GPT over the pipeline ---------------------------------------------------
def _pipe_step(inputs, layout, style, schedule, zero=None, clip=0.5,
               seed=0, **over):
    """A TrainStep over GPTForPretrainingPipe on ``layout`` (pp, mp, dp)
    with the JAX weights; ``style`` "forward" (crit(layer(ids), labels))
    or "pretraining" (layer.pretraining_loss(ids, labels, mask))."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretrainingPipe,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_weights)
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    pp, mp, dp = layout
    hcg = _fleet(pp=pp, mp=mp, dp=dp, schedule=schedule)
    model = fleet.distributed_model(GPTForPretrainingPipe(
        gpt_tiny(**dict(inputs["cfg"], **over)),
        num_microbatches=inputs["M"], device="cpu"))
    load_jax_weights(model, inputs["pipe_weights"])
    crit = GPTPretrainingCriterion()
    if style == "forward":
        def loss_fn(layer, ids, labels, mask):
            return crit(layer(ids), labels)
    else:
        def loss_fn(layer, ids, labels, mask):
            return layer.pretraining_loss(ids, labels, mask)
    opt = AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=None if clip is None
                else ClipGradByGlobalNorm(clip))
    step = TrainStep(model, loss_fn, opt, seed=seed, mesh=hcg.mesh,
                     data_spec=P("dp"), zero_axis=zero)
    return step


def _train_case(inputs, layout, style, schedule, steps=3, zero=None,
                **over):
    from paddle_tpu_torch.distributed.meta_parallel import spmd_pipeline
    step = _pipe_step(inputs, layout, style, schedule, zero=zero, **over)
    losses = [float(step(*inputs["batch"])) for _ in range(steps)]
    state = step.state_dict()
    blk = step.layer.blocks
    out = {"losses": losses, "params": state["params"],
           "in_flight": spmd_pipeline.PIPELINE_STATS["max_in_flight"],
           "stage": blk.stage_id(), "local_layers":
               tuple(blk.stacked__attn__qkv_weight.shape),
           "handoffs": (spmd_pipeline.PIPELINE_STATS["sent"],
                        spmd_pipeline.PIPELINE_STATS["received"])}
    if zero:
        w = blk.stacked__mlp__w_in
        out["slot"] = tuple(step.optimizer._accumulators[id(w)][0].shape)
    _reset()
    return out


LAYOUTS = {"pp2_mp2": (2, 2, 1), "pp4": (4, 1, 1), "pp2_dp2": (2, 1, 2)}


def case_gpt_pipe(rank, inputs, out_dir):
    """Every layout x (the forward style, pretraining_loss under each
    schedule), 3 AdamW steps with the clip at 0.5, dropout 0; ZeRO-1
    over dp where there is a dp axis."""
    out = {}
    for name, layout in LAYOUTS.items():
        zero = "dp" if layout[2] > 1 else None
        out[(name, "forward", "fill_drain")] = _train_case(
            inputs, layout, "forward", "fill_drain", zero=zero)
        for sched in ("fill_drain", "1f1b"):
            out[(name, "pretraining", sched)] = _train_case(
                inputs, layout, "pretraining", sched, zero=zero)
    return out


def case_dropout(rank, inputs, out_dir):
    """Dropout 0.1 at pp = 2 x mp = 2 and pp = 4: both schedules, 2
    steps; then the 1f1b step's state loaded into a fill-drain step,
    whose next loss is the 1f1b step's next."""
    from paddle_tpu_torch.distributed.meta_parallel import spmd_pipeline
    drop = dict(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    out = {}
    for name in ("pp2_mp2", "pp4"):
        for sched in ("fill_drain", "1f1b"):
            step = _pipe_step(inputs, LAYOUTS[name], "pretraining", sched,
                              clip=None, **drop)
            losses = [float(step(*inputs["batch"])) for _ in range(2)]
            state = step.state_dict()
            res = {"losses": losses, "params": state["params"],
                   "in_flight":
                       spmd_pipeline.PIPELINE_STATS["max_in_flight"],
                   "stage": step.layer.blocks.stage_id()}
            if sched == "1f1b":
                res["next"] = float(step(*inputs["batch"]))
                _reset()
                other = _pipe_step(inputs, LAYOUTS[name], "pretraining",
                                   "fill_drain", clip=None, **drop)
                other.set_state_dict(state)
                res["loaded_equal"] = all(
                    np.array_equal(v, state["params"][k])
                    for k, v in other.state_dict()["params"].items())
                res["next_loaded"] = float(other(*inputs["batch"]))
            out[(name, sched)] = res
            _reset()
    return out


def _jax_name(port_name: str) -> str:
    """A port stage's parameter name under the JAX single controller,
    where the tied embedding's parameters live at its first site."""
    stage, idx, rest = port_name.split(".", 2)
    if rest.startswith("shared.") and stage != "stage_0":
        return "stage_0.0." + rest
    return port_name


def case_eager(rank, inputs, out_dir):
    """``build_gpt_pipe`` at pp = 2 x mp = 2 through
    ``PipelineParallel.train_batch``: 3 AdamW steps; each step's
    schedule log, loss and the tied table's copy on this stage."""
    from paddle_tpu_torch.distributed.spmd import shard_tensor
    from paddle_tpu_torch.models import build_gpt_pipe, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW
    hcg = _fleet(pp=2, mp=2)
    cfg = gpt_tiny(**inputs["cfg"])
    pipe = build_gpt_pipe(cfg, num_stages=2, accumulate_steps=inputs["M"],
                          device="cpu")
    weights = inputs["eager_weights"]
    with torch.no_grad():
        for k, p in pipe.named_parameters():
            full = torch.from_numpy(weights[_jax_name(k)])
            p.copy_(shard_tensor(full, p._dist_layout, hcg.mesh))
    opt = AdamW(1e-3, parameters=pipe.parameters(), weight_decay=0.01)
    ids, labels, _ = inputs["batch"]
    data = (torch.from_numpy(ids), torch.from_numpy(labels).long())
    out = {"stage": hcg.get_stage_id(), "logs": [], "losses": [],
           "tables": [], "names": sorted(k for k, _ in
                                         pipe.named_parameters())}
    table = next(p for k, p in pipe.named_parameters()
                 if k.endswith("shared.word_embeddings.weight"))
    for _ in range(3):
        out["losses"].append(float(pipe.train_batch(data, opt)))
        out["logs"].append(list(pipe._schedule_log))
        out["tables"].append(table.detach().numpy().copy())
    out["eval"] = float(pipe.eval_batch(data))
    return out


def case_zero_sharding(rank, inputs, out_dir):
    """sharding = 2 x mp = 2, ZeRO-1 over sharding, the batch over
    sharding: GPTForPretraining, 3 AdamW steps with the clip at 0.5."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_weights)
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    hcg = _fleet(sharding=2, mp=2)
    model = fleet.distributed_model(GPTForPretraining(
        gpt_tiny(**inputs["cfg"]), device="cpu"))
    load_jax_weights(model, inputs["dense_weights"])
    crit = GPTPretrainingCriterion()
    opt = AdamW(1e-3, parameters=model.parameters(), weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(0.5))
    step = TrainStep(model, lambda layer, i, t, m: crit(layer(i), t, m),
                     opt, seed=0, mesh=hcg.mesh, data_spec=P("sharding"),
                     zero_axis="sharding")
    losses = [float(step(*inputs["batch"])) for _ in range(3)]
    w_in = step.layer._layers.gpt.layers[0].mlp.w_in
    return {"losses": losses, "params": step.state_dict()["params"],
            "mode": type(step.layer).__name__,
            "w_in": tuple(w_in.shape),
            "slot": tuple(step.optimizer._accumulators[id(w_in)][0].shape)}


def case_localsgd(rank, inputs, out_dir):
    """dp = 4: LocalSGD k = 1 against the synchronous step (SGD), then
    k = 4 and adaptive (AdamW) through ``strategy.localsgd`` /
    ``adaptive_localsgd``, 8 calls each."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        LocalSGDTrainStep
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_weights)
    from paddle_tpu_torch.optimizer import SGD, AdamW
    crit = GPTPretrainingCriterion()

    def loss_fn(layer, ids, labels):
        return crit(layer(ids), labels)

    def model():
        return load_jax_weights(GPTForPretraining(gpt_tiny(**inputs["cfg"]),
                                                  device="cpu"),
                                inputs["dense_weights"])
    batches = inputs["local_batches"]
    out = {}
    hcg = _fleet(dp=4)
    m1 = model()
    local = LocalSGDTrainStep(m1, loss_fn, SGD(0.5, parameters=m1.parameters()),
                              hcg.mesh, k_steps=1)
    m2 = model()
    sync = TrainStep(m2, loss_fn, SGD(0.5, parameters=m2.parameters()),
                     mesh=hcg.mesh, data_spec=P("dp"))
    out["k1"] = [float(local(*b)) for b in batches[:4]]
    out["sync"] = [float(sync(*b)) for b in batches[:4]]
    out["k1_params"] = max(float((a - b).abs().max()) for a, b in zip(
        m1.parameters(), m2.parameters()))
    for name, strat_kw in (("k4", {"localsgd": True, "localsgd_configs":
                                   {"k_steps": 4}}),
                           ("adaptive", {"adaptive_localsgd": True,
                                         "adaptive_localsgd_configs":
                                             {"init_k_steps": 2}})):
        strategy = fleet.DistributedStrategy()
        for k, v in strat_kw.items():
            setattr(strategy, k, v)
        m = model()
        opt = fleet.distributed_optimizer(
            AdamW(1e-3, parameters=m.parameters(), weight_decay=0.01),
            strategy)
        step = TrainStep(m, loss_fn, opt)
        out[name] = {"type": type(step).__name__,
                     "losses": [float(step(*b)) for b in batches],
                     "stats": step.stats()}
    step.sync_to_layer()
    out["synced"] = [p.detach().numpy().copy() for p in m.parameters()][:2]
    return out


def case_pipe_watchdog(rank, inputs, out_dir):
    """pp = 2 x mp = 2 under FLAGS_collective_timeout_s = 1 with the chaos
    hang armed: the step raises CollectiveTimeoutError as a
    ``pipeline_step`` of the pp group on every rank, nothing of it ran,
    and the next step runs."""
    from paddle_tpu_torch.core import flag_scope
    from paddle_tpu_torch.distributed.collective import \
        CollectiveTimeoutError
    from paddle_tpu_torch.testing import chaos
    step = _pipe_step(inputs, LAYOUTS["pp2_mp2"], "pretraining", "1f1b")
    err = None
    with flag_scope("collective_timeout_s", 1.0):
        chaos.configure("collective.hang@1")
        try:
            step(*inputs["batch"])
        except CollectiveTimeoutError as e:
            err = (e.op, e.group_axis)
        finally:
            chaos.reset()
    return {"error": err, "steps": step.step_count,
            "loss": float(step(*inputs["batch"]))}


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
