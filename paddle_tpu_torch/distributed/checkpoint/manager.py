"""CheckpointManager: the auto-resume driver over atomic checkpoints.

Counterpart of ``paddle_tpu/distributed/checkpoint/manager.py``:

- **interval saves**: :meth:`CheckpointManager.on_step` after every
  optimizer step commits a checkpoint of the whole training state (the
  ``TrainStep``'s parameters, slots, step count, dropout generator and
  lr, and the caller's dataloader position) every ``interval_steps``
  steps into ``<root>/step_<N>``, asynchronously by default: an
  interval save commits at the first step boundary after its files are
  written (:meth:`~Checkpointer.pending_ready`), so a kill loses at
  most one interval;
- **preemption**: SIGTERM is latched by a handler and honoured at the
  next step boundary with a final synchronous save, then
  :class:`PreemptionSignal` is raised;
- **resume()** restores the newest valid checkpoint into the step
  (resharded into its layout), skipping torn or uncommitted directories
  and failed restores with a ``checkpoint_fallback`` flight event, and
  hands back the saved dataloader position;
- **retention**: the ``keep_n`` newest valid checkpoints survive
  :meth:`~CheckpointManager.gc`; the last valid one is never deleted;
- the sidecar (``MANAGER_STATE_NAME``, covered by the manifest) holds
  the dataloader position and the goodput ledger's ``state()``; saves
  and waits are measured as goodput's ``checkpoint_stall``, and
  ``resume()`` restores the ledger, which adds the dead time since the
  saved incarnation's last commit to ``restart_gap``.

On a mesh of several ranks (a sharded save) every rank drives its own
manager over the same root: saves are collective, rank 0 alone deletes,
and each step boundary the ranks agree whether a preemption was latched
on any of them and whether the pending save is written on all of them,
so they commit and stop at the same step.
"""

from __future__ import annotations

import json
import logging
import os
import signal as signal_mod
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("paddle_tpu_torch.checkpoint")

__all__ = ["CheckpointManager", "PreemptionSignal", "MANAGER_STATE_NAME"]

MANAGER_STATE_NAME = "manager_state.json"


class PreemptionSignal(Exception):
    """Raised by ``on_step`` after a latched SIGTERM has been honoured
    with a final committed checkpoint; carries the checkpoint path."""

    def __init__(self, message: str, path: Optional[str] = None,
                 step: Optional[int] = None):
        super().__init__(message)
        self.path = path
        self.step = step


class CheckpointManager:
    """Drive interval and preemption checkpoints and resume for one
    ``TrainStep``. Use as a context manager (restores the signal
    handlers on exit) or call :meth:`close`::

        with CheckpointManager(step, root, interval_steps=50) as mgr:
            start = mgr.resume() or {}
            for i in range(start.get("step", 0), total_steps):
                loss = step(*batch(i))
                mgr.on_step(dataloader_state={"offset": i + 1})
    """

    def __init__(self, train_step, root: str, interval_steps: int = 100,
                 keep_n: int = 3, asynchronous: bool = True,
                 preempt_signals=(signal_mod.SIGTERM,)):
        self._step = train_step
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.interval_steps = max(1, int(interval_steps))
        self.keep_n = max(1, int(keep_n))
        self.asynchronous = asynchronous
        self._preempt: Optional[int] = None
        self._old_handlers: Dict[int, Any] = {}
        self._dataloader_state: Optional[dict] = None
        self.save_count = 0
        for sig in preempt_signals or ():
            try:
                self._old_handlers[sig] = signal_mod.signal(
                    sig, self._on_signal)
            except (ValueError, OSError):
                # not the main thread: interval saves still work,
                # preemption latching does not
                logger.warning("CheckpointManager: cannot install "
                               "handler for signal %s", sig)

    # -- the latch and the ranks -------------------------------------------
    def _on_signal(self, signum, frame):
        # latch only: the next on_step() boundary commits, never the
        # middle of an update
        self._preempt = signum

    @property
    def preempted(self) -> bool:
        return self._preempt is not None

    def _multi(self) -> bool:
        """A sharded step over several ranks (saves are collective)."""
        from .. import env
        return self._step.mesh is not None and env.get_world_size() > 1

    def _rank0(self) -> bool:
        from .. import env
        return not self._multi() or env.get_rank() == 0

    def _agree(self, preempt: bool, ready: bool):
        """``(any rank latched a preemption, every rank's pending save
        is written)``."""
        if not self._multi():
            return preempt, ready
        from ..collective import all_gather_object
        votes: list = []
        all_gather_object(votes, (bool(preempt), bool(ready)))
        return any(v[0] for v in votes), all(v[1] for v in votes)

    # -- paths -------------------------------------------------------------
    def step_dir(self, n: int) -> str:
        return os.path.join(self.root, f"step_{int(n)}")

    # -- saving ------------------------------------------------------------
    def save(self, asynchronous: Optional[bool] = None,
             dataloader_state: Optional[dict] = None) -> str:
        """Commit a checkpoint of the current training state (returns
        its final path). A synchronous save is durable on return; an
        async one after the next :meth:`wait`, save or step boundary
        that finds it written."""
        from ...monitor import goodput as _goodput
        from . import save_train_step
        if dataloader_state is not None:
            self._dataloader_state = dataloader_state
        n = int(self._step.step_count)
        path = self.step_dir(n)
        state = {"step": n, "saved_at": time.time(),
                 "dataloader": self._dataloader_state}
        led = _goodput.active_ledger()
        if led is not None:
            # the ledger rides the sidecar: resume() restores it and
            # attributes the restart gap
            state["goodput"] = led.state()
        asynchronous = (self.asynchronous if asynchronous is None
                        else asynchronous)
        with _goodput.measure("checkpoint_stall"):
            save_train_step(self._step, path, asynchronous=asynchronous,
                            extra_files={MANAGER_STATE_NAME:
                                         json.dumps(state, indent=1)})
        if not asynchronous:
            self.gc()
        self.save_count += 1
        return path

    def wait(self) -> None:
        """Commit the pending async save (re-raising its failure)."""
        from ...monitor import goodput as _goodput
        from . import wait as ckpt_wait
        with _goodput.measure("checkpoint_stall"):
            ckpt_wait()

    def on_step(self, dataloader_state: Optional[dict] = None) \
            -> Optional[str]:
        """Call once per optimizer step, after the step. Honours a
        latched preemption (final synchronous commit, then raises
        :class:`PreemptionSignal`), else saves every ``interval_steps``
        steps, and commits a pending async save whose files are written.
        Returns the path of a save it started."""
        from ...testing import chaos
        from . import Checkpointer
        if dataloader_state is not None:
            self._dataloader_state = dataloader_state
        if chaos.active() and chaos.probe("worker.die"):
            raise chaos.ChaosFault(
                "worker.die",
                f"chaos: worker died at step {self._step.step_count}")
        ckpt = Checkpointer.instance()
        preempt, ready = self._agree(self._preempt is not None,
                                     ckpt.pending_ready())
        if preempt:
            signum = self._preempt if self._preempt is not None \
                else signal_mod.SIGTERM
            # a failed earlier async save must not stop the final commit
            try:
                self.wait()
            except Exception as e:
                logger.warning("preemption: the pending async save had "
                               "failed (%r); committing the final "
                               "checkpoint anyway", e)
            path = self.save(asynchronous=False)
            from . import _record_event
            _record_event("preempted", signal=int(signum),
                          step=int(self._step.step_count), path=path)
            logger.warning("preemption (signal %s): final checkpoint "
                           "committed at %s", signum, path)
            raise PreemptionSignal(
                f"preempted by signal {signum}; final checkpoint "
                f"committed at {path}", path=path,
                step=int(self._step.step_count))
        if (self._step.step_count
                and self._step.step_count % self.interval_steps == 0):
            path = self.save()
            if self.asynchronous:
                self.gc()
            return path
        if ready:
            # the pending save's files are down: commit now, so a kill
            # loses at most one interval
            self.wait()
            self.gc()
        return None

    # -- resume ------------------------------------------------------------
    def resume(self) -> Optional[dict]:
        """Restore the newest valid checkpoint into the step. Returns
        ``{"step", "path", "dataloader"}``, or None without one. Invalid
        directories and failed restores fall back to the next newest
        (each skip a ``checkpoint_fallback`` flight event naming the
        step resumed from)."""
        from . import (_record_event, checkpoint_steps, load_train_step,
                       verify_checkpoint)
        skipped = []
        result = None
        for n in reversed(checkpoint_steps(self.root)):
            path = self.step_dir(n)
            reason = verify_checkpoint(path)
            if reason is None:
                try:
                    load_train_step(self._step, path)
                except Exception as e:
                    reason = f"restore failed: {e!r}"
            if reason is not None:
                logger.warning("resume: skipping %s: %s", path, reason)
                skipped.append((n, reason))
                continue
            meta = self._read_sidecar(path)
            self._dataloader_state = (meta or {}).get("dataloader")
            saved_goodput = (meta or {}).get("goodput")
            if saved_goodput:
                from ...monitor import goodput as _goodput
                led = _goodput.active_ledger()
                if led is not None:
                    gap = led.restore(saved_goodput)
                    logger.info("goodput ledger restored (restart gap "
                                "%.1fs attributed)", gap)
            logger.info("resumed from %s (step %d)", path, n)
            result = {"step": n, "path": path,
                      "dataloader": self._dataloader_state}
            break
        for bad_n, bad_reason in skipped:
            _record_event("checkpoint_fallback", step=bad_n,
                          reason=bad_reason,
                          fallback_to=result["step"] if result else None)
        return result

    @staticmethod
    def _read_sidecar(path: str) -> Optional[dict]:
        try:
            with open(os.path.join(path, MANAGER_STATE_NAME)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- retention ---------------------------------------------------------
    def gc(self) -> None:
        """Delete valid checkpoints beyond the ``keep_n`` newest, and
        orphaned staging directories. Never deletes the last valid
        checkpoint; invalid committed directories stay for forensics.
        Validity here is the ``manifest`` level (stat only), whatever
        ``FLAGS_checkpoint_verify`` says. On several ranks, rank 0
        deletes."""
        import shutil
        from . import (REPLACED_SUFFIX, STAGING_SUFFIX, Checkpointer,
                       checkpoint_steps, verify_checkpoint)
        if not self._rank0():
            return
        valid = [n for n in reversed(checkpoint_steps(self.root))
                 if verify_checkpoint(self.step_dir(n),
                                      level="manifest") is None]
        for n in valid[self.keep_n:]:
            shutil.rmtree(self.step_dir(n), ignore_errors=True)
            logger.info("checkpoint GC: removed %s", self.step_dir(n))
        pending = Checkpointer.instance().pending_path()
        for name in os.listdir(self.root):
            if not name.endswith((STAGING_SUFFIX, REPLACED_SUFFIX)):
                continue
            full = os.path.join(self.root, name)
            if full == pending or not os.path.isdir(full):
                continue
            shutil.rmtree(full, ignore_errors=True)
            logger.info("checkpoint GC: removed orphan staging dir %s",
                        full)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Commit the pending save and restore the signal handlers
        (idempotent)."""
        try:
            self.wait()
        finally:
            for sig, old in self._old_handlers.items():
                try:
                    signal_mod.signal(sig, old)
                except (ValueError, OSError):
                    pass
            self._old_handlers = {}

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
