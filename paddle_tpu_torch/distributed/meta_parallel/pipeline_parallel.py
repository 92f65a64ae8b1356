"""Pipeline-parallel engine over a :class:`PipelineLayer`: the
microbatched eager schedule.

Counterpart of ``paddle_tpu/distributed/meta_parallel/pipeline_
parallel.py``: ``forward_backward_pipeline`` runs ``accumulate_steps``
microbatches as warmup forwards (``S - 1``), steady forward/backward
pairs and cooldown backwards, the order of the JAX engine, whose
single controller walks every stage of a microbatch in turn;
``train_batch`` adds one optimizer step, ``eval_batch`` runs forwards
only. ``_schedule_log`` records ``("F"|"B", stage, microbatch)``.

In the port a stage is a process (the :class:`PipelineLayer` built
under a fleet topology holds this rank's stage only): every rank runs
the same order of microbatches on its own stage, receives its input
from the previous stage and its output's gradient from the next, sends
the other way (``pp_utils.StageHandoff``, shape and dtype sent with
each activation), and logs its own stage's entries, which are the JAX
log's entries of that stage, in order. The loss, known on the last
stage, is the mean of the microbatches' losses, reported unscaled
under a scaler and broadcast to every stage. ``train_batch`` sums the
shared layers' gradients over their stages and averages every gradient
over the data-parallel group before the update. Without a pp group the
engine is the JAX one: every stage in this process, a detached copy of
each stage's input standing for the handoff.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .parallel_base import _MetaParallelBase
from .parallel_layers.pp_layers import PipelineLayer

__all__ = ["PipelineParallel"]


class PipelineParallel(_MetaParallelBase):
    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None,
                 accumulate_steps: Optional[int] = None):
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel needs a PipelineLayer")
        if hcg is None:
            hcg = layers._hcg
        super().__init__(layers, hcg, strategy)
        cfg = getattr(strategy, "pipeline_configs", None) or {}
        self.accumulate_steps = int(
            accumulate_steps if accumulate_steps is not None
            else cfg.get("accumulate_steps", 1))
        self.num_stages = layers.num_stages
        # schedule log for tests/inspection: ("F"|"B", stage, microbatch)
        self._schedule_log: List[tuple] = []
        self._handoff = None
        if layers.stage_id is not None:
            from .pp_utils import StageHandoff
            self._handoff = StageHandoff(hcg.get_pipe_parallel_group(),
                                         hcg.get_prev_stage_rank(),
                                         hcg.get_next_stage_rank())

    def _my_stages(self) -> List[int]:
        sid = self._layers.stage_id
        return list(range(self.num_stages)) if sid is None else [sid]

    # -- helpers -----------------------------------------------------------
    def _split_micro(self, data):
        """Split [B, ...] batch tensors into accumulate_steps microbatches."""
        inputs, labels = data
        n = self.accumulate_steps

        def split(t):
            if not isinstance(t, torch.Tensor):
                t = torch.as_tensor(t)
            B = t.shape[0]
            if B % n:
                raise ValueError(f"batch {B} not divisible into {n} "
                                 "microbatches")
            m = B // n
            return [t[i * m:(i + 1) * m] for i in range(n)]
        return split(inputs), split(labels)

    def _device(self):
        p = next(iter(self._layers.parameters()), None)
        return p.device if p is not None else torch.device("cpu")

    def _fwd_stage(self, s: int, x, mb: int):
        self._schedule_log.append(("F", s, mb))
        return self._layers.stage(s)(x)

    def _bwd_stage(self, out, grad, mb: int, s: int) -> None:
        self._schedule_log.append(("B", s, mb))
        out.backward(grad)

    def _from_last(self, value: float) -> torch.Tensor:
        """The last stage's float on every stage (a pp broadcast)."""
        t = torch.tensor([value], dtype=torch.float32, device=self._device())
        if self._handoff is not None:
            from ..collective import broadcast
            broadcast(t, self._hcg.get_pipe_parallel_group().ranks[-1],
                      self._hcg.get_pipe_parallel_group())
        return t[0]

    # -- 1F1B --------------------------------------------------------------
    def forward_backward_pipeline(self, data, scaler=None):
        """One microbatched forward and backward; gradients accumulate
        into ``.grad``. Returns the mean loss over the microbatches
        (unscaled), the same on every stage.

        Warmup: ``S - 1`` forwards, then forward/backward pairs, then
        the remaining backwards; at most ``S`` microbatches in flight."""
        self._schedule_log.clear()
        micro_in, micro_lab = self._split_micro(data)
        M, S = self.accumulate_steps, self.num_stages
        stages = self._my_stages()
        last = S - 1
        dev = self._device()

        losses = {}            # scaled losses (backward roots)
        report = {}            # UNSCALED values for the returned loss
        inputs = [dict() for _ in range(M)]      # stage input leaves
        outputs = [dict() for _ in range(M)]     # stage output tensors
        ho = self._handoff

        def run_forward(mb):
            x = micro_in[mb].to(dev)
            for s in stages:
                if s > 0:
                    # the handoff: a detached copy (one process) or the
                    # previous stage's activation (a stage a process)
                    x = (ho.recv_fwd(mb, device=dev) if ho is not None
                         else x.detach())
                    x.requires_grad_(True)
                inputs[mb][s] = x
                x = self._fwd_stage(s, x, mb)
                outputs[mb][s] = x
                if s < last and ho is not None:
                    ho.send_fwd(x, mb, meta=True)
            if last in stages:
                loss = self._layers.loss(x, micro_lab[mb].to(dev)) / M
                report[mb] = loss.detach()
                if scaler is not None:
                    loss = scaler.scale(loss)
                losses[mb] = loss

        def run_backward(mb):
            for s in reversed(stages):
                if s == last:
                    self._bwd_stage(losses[mb], None, mb, s)
                else:
                    out = outputs[mb][s]
                    grad = (ho.recv_bwd(mb, out) if ho is not None
                            else inputs[mb][s + 1].grad)
                    self._bwd_stage(out, grad, mb, s)
                if s > 0 and ho is not None:
                    ho.send_bwd(inputs[mb][s].grad, mb)
            inputs[mb] = {}                # free activations
            outputs[mb] = {}

        warmup = min(S - 1, M)
        steady = M - warmup

        for mb in range(warmup):
            run_forward(mb)
        for i in range(steady):
            run_forward(warmup + i)
            run_backward(i)
        for mb in range(steady, M):
            run_backward(mb)
        if ho is not None:
            ho.flush()

        total = 0.0
        if last in stages:
            total = float(report[0]) if M else 0.0
            for mb in range(1, M):
                total += float(report[mb])
        return self._from_last(total)

    def _sync_grads(self) -> None:
        self._layers.allreduce_shared_weight_gradients()
        if self._hcg is None or \
                self._hcg.get_data_parallel_world_size() <= 1:
            return
        from ..collective import ReduceOp, all_reduce
        group = self._hcg.get_data_parallel_group()
        for p in self._layers.parameters():
            if p.grad is not None:
                all_reduce(p.grad, ReduceOp.AVG, group)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """Microbatched train step: the schedule's forward and backward,
        then ONE optimizer step."""
        loss = self.forward_backward_pipeline(data, scaler)
        self._sync_grads()
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """Forwards only. With ``compute_loss`` the mean loss (every
        stage), else the last stage's outputs (the last stage only)."""
        micro_in, micro_lab = self._split_micro(data)
        M, S = self.accumulate_steps, self.num_stages
        stages, last, dev = self._my_stages(), S - 1, self._device()
        ho = self._handoff
        outs = []
        for mb in range(M):
            x = micro_in[mb].to(dev)
            for s in stages:
                if s > 0 and ho is not None:
                    x = ho.recv_fwd(mb, device=dev)
                x = self._fwd_stage(s, x, mb)
                if s < last and ho is not None:
                    ho.send_fwd(x, mb, meta=True)
            if last in stages:
                outs.append(self._layers.loss(x, micro_lab[mb].to(dev)) / M
                            if compute_loss else x)
        if ho is not None:
            ho.flush()
        if not compute_loss:
            return outs
        total = 0.0
        if last in stages:
            total = float(outs[0])
            for v in outs[1:]:
                total += float(v)
        return self._from_last(total)
