"""Rank bodies for the port's ps-sharded recsys tests
(``test_torch_recsys.py``).

One gloo world of two ranks (a ``ps`` mesh axis of 2) runs the file's
cases in order (``run``, as in ``_torch_dist_workers``) and pickles each
rank's results; the tests hold them against the JAX package's explicit
``shard_map`` program in the parent. This module imports torch and the
port only, so a rank never loads JAX.
"""

import os

import numpy as np

from _torch_dist_workers import run as _run

WORLD_BUDGET_S = 120
PS = 2


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


class _PsMesh:
    """``with _PsMesh():`` a ``{"ps": 2}`` mesh is active, with clean
    recsys stats; the mesh is dropped on exit."""

    def __enter__(self):
        from paddle_tpu_torch import recsys
        from paddle_tpu_torch.distributed import env
        from paddle_tpu_torch.distributed.spmd import make_mesh
        recsys.reset()
        self.mesh = make_mesh({"ps": PS})
        env.set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        from paddle_tpu_torch.distributed import env
        env.set_mesh(None)
        return False


def case_sharded(rank, inputs, out_dir):
    """The id stream of ``inputs["stream"]`` through a ps = 2
    ``ShardedEmbeddingTable``: every pull's rows, the pushes, then the
    gathered ``state_dict`` and this rank's block shape and counters."""
    from paddle_tpu_torch.recsys import RECSYS_STATS, ShardedEmbeddingTable
    V, D, lr, seed = inputs["table"]
    with _PsMesh():
        t = ShardedEmbeddingTable(V, D, lr=lr, seed=seed, device="cpu")
        pulls = [t.pull(np.arange(V))]
        for ids, g in inputs["stream"]:
            pulls.append(t.pull(ids))
            t.push(ids, g)
        pulls.append(t.pull(np.arange(V)))
        return {"pulls": pulls, "state": t.state_dict(),
                "block": tuple(t.data.shape), "shards": t.num_shards,
                "stats": dict(RECSYS_STATS)}


def case_dlrm(rank, inputs, out_dir):
    """DLRM over ps = 2 ``ShardedEmbeddingTable`` slots from the JAX
    model's dense weights: the losses of ``inputs["batches"]`` (Adam on
    the dense parameters), the dense state and the tables' states."""
    import torch
    from paddle_tpu_torch.models import load_jax_weights
    from paddle_tpu_torch.models.dlrm import DLRM, dlrm_tiny
    from paddle_tpu_torch.optimizer import Adam
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable
    cfg = dlrm_tiny(**inputs["dlrm_cfg"])
    with _PsMesh():
        tables = [ShardedEmbeddingTable(v, cfg.embedding_dim, lr=0.05,
                                        seed=f, device="cpu")
                  for f, v in enumerate(cfg.vocab_list())]
        model = load_jax_weights(DLRM(cfg, tables=tables, device="cpu"),
                                 inputs["dlrm_weights"])
        opt = Adam(learning_rate=1e-2, parameters=list(model.parameters()))
        losses = []
        for dense, ids, labels in inputs["batches"]:
            loss = model.loss(dense, ids, labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        with torch.no_grad():
            dense_state = {k: v.numpy().copy()
                           for k, v in model.state_dict().items()}
        return {"losses": losses, "dense": dense_state,
                "tables": [t.state_dict() for t in tables]}


def case_refused(rank, inputs, out_dir):
    """``FLAGS_recsys_sharded_lookup`` off on the ps mesh: the JAX auto
    path has no counterpart, so a lookup and a push raise."""
    from paddle_tpu_torch.core.flags import flag_scope
    from paddle_tpu_torch.recsys import RECSYS_STATS, ShardedEmbeddingTable
    out = {}
    with _PsMesh(), flag_scope("recsys_sharded_lookup", False):
        t = ShardedEmbeddingTable(16, 4, device="cpu")
        for what, fn in (("pull", lambda: t.pull([1, 2])),
                         ("push", lambda: t.push(
                             [1], np.ones((1, 4), np.float32)))):
            try:
                fn()
                out[what] = None
            except NotImplementedError as e:
                out[what] = str(e)
        out["fallbacks"] = RECSYS_STATS["fallbacks"]
    return out


def case_restore(rank, inputs, out_dir):
    """A global-row-order state (a one-process table's) loaded into a
    ps = 2 table: every row and its g2 read back."""
    from paddle_tpu_torch.recsys import ShardedEmbeddingTable
    state = inputs["restore_state"]
    V, D = state["data"].shape
    with _PsMesh():
        t = ShardedEmbeddingTable(V, D, seed=99, device="cpu")
        t.load_state_dict(state)
        return {"rows": t.pull(np.arange(V)), "state": t.state_dict()}


CASES = {"sharded": case_sharded, "dlrm": case_dlrm,
         "refused": case_refused, "restore": case_restore}
