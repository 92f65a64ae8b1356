"""Rank bodies for the port's fleet host-module tests
(``test_torch_fleet_utils.py``).

One gloo world of four ranks runs the file's cases in order (``run``, as
in ``_torch_dist_workers``) and pickles each rank's results; the tests
hold them against the JAX package's ``auto_parallel`` on the virtual CPU
devices and read the checkpoints with the JAX ``verify_checkpoint``.
This module imports torch and the port only, so a rank never loads JAX.
"""

import os

import numpy as np
import torch

from _torch_dist_workers import _fleet
from _torch_dist_workers import run as _run

WORLD_BUDGET_S = 240
N = 4
#: the tensor the auto_parallel cases cut, and the two meshes
DATA = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
MESH_A = ([[0, 1], [2, 3]], ["x", "y"])
MESH_B = ([[3, 2], [1, 0]], ["p", "q"])


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


def case_auto_parallel(rank, inputs, out_dir):
    """This rank's blocks: ``shard_tensor`` of DATA over mesh A by
    ``[0, 1]`` and ``[0, -1]`` and in the dict form over a nested list;
    ``shard_op``'s inputs; ``reshard`` to mesh B by ``[1, 0]`` and back
    to A replicated; the meshes' topology."""
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.auto_parallel import (
        ProcessMesh, get_mesh, reshard, shard_op, shard_tensor)
    a = ProcessMesh(*MESH_A)
    b = ProcessMesh(*MESH_B)
    out = {"shape": a.shape, "names": a.dim_names, "ids": b.process_ids,
           "axes": a.mesh.axis_names, "coords": b.mesh.coords}
    t = shard_tensor(torch.from_numpy(DATA.copy()),
                     dist_attr={"process_mesh": a, "dims_mapping": [0, 1]})
    out["xy"] = t.numpy().copy()
    out["x_"] = shard_tensor(torch.from_numpy(DATA.copy()), process_mesh=a,
                             dims_mapping=[0, -1]).numpy().copy()
    out["dict"] = shard_tensor(
        torch.ones(4, 6), dist_attr={"process_mesh": [[0, 1], [2, 3]],
                                     "dims_mapping": [0, -1]}).shape
    x, y = torch.ones(4, 6), torch.zeros(4, 6)
    add = shard_op(torch.add, dist_attr={
        "process_mesh": [[0, 1], [2, 3]], x: {"dims_mapping": [0, -1]},
        y: {"dims_mapping": [0, -1]}})
    out["op"] = add(x, y).numpy().copy()
    out["op_x"] = tuple(x.shape)
    r = reshard(shard_tensor(torch.from_numpy(DATA.copy()), process_mesh=a,
                             dims_mapping=[0, -1]),
                process_mesh=b, dims_mapping=[1, 0])
    out["b"] = r.numpy().copy()
    out["b_spec"] = tuple(r.spec)
    out["back"] = reshard(r, process_mesh=a).numpy().copy()
    with a:
        out["active"] = get_mesh() is a.mesh
    out["after"] = env.get_mesh() is None
    return out


def _gpt_step(seed):
    from paddle_tpu_torch.distributed.spmd import P
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         GPTPretrainingCriterion, gpt_tiny)
    from paddle_tpu_torch.optimizer import AdamW
    hcg = _fleet(2, 2)
    model = GPTForPretraining(gpt_tiny(), device="cpu", seed=seed)
    crit = GPTPretrainingCriterion()
    return TrainStep(model, lambda m, i, l: crit(m(i), l),
                     AdamW(1e-3, parameters=model.parameters()),
                     mesh=hcg.mesh, data_spec=P("dp"))


def case_persistables(rank, inputs, out_dir):
    """dp = 2 x mp = 2: ``save_persistables`` of a stepped ``TrainStep``
    (sharded, each rank its blocks), ``load_persistables`` into a fresh
    step of another seed, the next step's loss of both; then a layer laid
    on the mesh (parameters and buffers) into a fresh layer."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.spmd import apply_param_shardings
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
    ids = np.random.RandomState(0).randint(0, 256, (4, 16)).astype(np.int64)
    path = os.path.join(out_dir, "persistables")
    a = _gpt_step(11)
    a(ids, ids)
    fleet.save_persistables(a, path, asynchronous=False)
    fleet.reset()
    b = _gpt_step(222)
    fleet.load_persistables(b, path)
    pa, pb = a.state_dict()["params"], b.state_dict()["params"]
    out = {"equal": all(torch.equal(torch.as_tensor(pa[k]),
                                    torch.as_tensor(pb[k])) for k in pa),
           "next": (float(a(ids, ids)), float(b(ids, ids))),
           "files": sorted(os.listdir(path))}
    fleet.reset()
    hcg = _fleet(2, 2)
    layer_path = os.path.join(out_dir, "layer_persistables")
    m = apply_param_shardings(
        GPTForPretraining(gpt_tiny(), device="cpu", seed=5), hcg.mesh)
    fleet.save_persistables(m, layer_path, asynchronous=False)
    m2 = apply_param_shardings(
        GPTForPretraining(gpt_tiny(), device="cpu", seed=6), hcg.mesh)
    fleet.load_persistables(m2, layer_path)
    out["layer_equal"] = all(torch.equal(p, q) for p, q in zip(
        m.parameters(), m2.parameters()))
    out["layer_block"] = tuple(m2.gpt.layers[0].attn.qkv_weight.shape)
    out["paths"] = (path, layer_path)
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}
