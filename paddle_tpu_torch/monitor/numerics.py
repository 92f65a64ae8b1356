"""NaN/Inf watchdog: eager post-step numerics checks over dicts of tensors.

Port of ``paddle_tpu/monitor/numerics.py``. ``TrainStep(
check_numerics=...)`` runs its check after ``backward()`` and before the
optimizer's update, so a trip names the first offending gradient of the
step itself; :func:`check_numerics` and :class:`NaNWatchdog` serve eager
training loops directly.

A check over a dict reads the card once: every floating tensor's
``isfinite(t).all()`` flag is stacked on the device and the stack is
read back in one copy (one read per tensor would be 200 syncs on
BERT-base). Only on a trip does :func:`first_nonfinite` walk the names.
"""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Optional

import torch

__all__ = ["NonFiniteError", "all_finite", "nonfinite_entries",
           "first_nonfinite", "check_numerics", "NaNWatchdog"]


class NonFiniteError(RuntimeError):
    """Raised when the watchdog finds a NaN/Inf; carries the offender name
    and the step index for programmatic handling."""

    def __init__(self, message: str, offender: Optional[str] = None,
                 step: Optional[int] = None):
        super().__init__(message)
        self.offender = offender
        self.step = step


def _floating(v) -> bool:
    return isinstance(v, torch.Tensor) and v.is_floating_point()


def _finite_flags(tree: Dict[str, Any]):
    """(names, flags): a bool tensor of one flag per floating tensor
    entry, still on its device; python floats are checked on the host
    and folded in as constants."""
    names, flags = [], []
    for k, v in tree.items():
        if _floating(v):
            names.append(k)
            flags.append(torch.isfinite(v.detach()).all())
        elif isinstance(v, float):
            names.append(k)
            flags.append(torch.tensor(math.isfinite(v)))
    return names, flags


def _host_flags(flags) -> List[bool]:
    """One device-to-host copy per device the flags live on."""
    by_dev: Dict[torch.device, list] = {}
    for i, f in enumerate(flags):
        by_dev.setdefault(f.device, []).append(i)
    out = [True] * len(flags)
    for idx in by_dev.values():
        vals = torch.stack([flags[i] for i in idx]).cpu().tolist()
        for i, ok in zip(idx, vals):
            out[i] = bool(ok)
    return out


def all_finite(tree: Dict[str, Any]) -> bool:
    """True iff every floating entry of a name -> tensor dict is finite,
    with one host read for the whole dict."""
    _, flags = _finite_flags(tree)
    return all(_host_flags(flags)) if flags else True


def nonfinite_entries(tree: Dict[str, Any]) -> List[str]:
    """Names (sorted) of entries containing any NaN/Inf."""
    names, flags = _finite_flags(tree)
    return sorted(n for n, ok in zip(names, _host_flags(flags)) if not ok)


def first_nonfinite(tree: Dict[str, Any]) -> Optional[str]:
    """First (sorted-name) entry with a non-finite value, or None. Name
    order, not op order, so "first" is deterministic and the same in
    both packages."""
    bad = nonfinite_entries(tree)
    return bad[0] if bad else None


def check_numerics(tree: Dict[str, Any], step: Optional[int] = None,
                   what: str = "tensor", action: str = "raise",
                   registry=None) -> Optional[str]:
    """Check a name -> tensor dict; on a non-finite entry record a
    ``numerics_nonfinite_total{what=...}`` counter and raise
    :class:`NonFiniteError` (``action="raise"``) or warn
    (``action="warn"``). Returns the offender name (None when clean)."""
    if all_finite(tree):
        return None
    offender = first_nonfinite(tree)
    from .metrics import get_registry
    reg = registry if registry is not None else get_registry()
    reg.counter("numerics_nonfinite_total",
                "NaN/Inf watchdog trips by kind").inc(what=what)
    at = f" at step {step}" if step is not None else ""
    msg = (f"NaN/Inf detected{at}: first non-finite {what} is "
           f"{offender!r} (check_numerics watchdog; see "
           f"docs/OBSERVABILITY.md)")
    if action == "warn":
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return offender
    raise NonFiniteError(msg, offender=offender, step=step)


class NaNWatchdog:
    """Stateful watchdog for eager training loops::

        dog = NaNWatchdog()               # or action="warn"
        for step, batch in enumerate(loader):
            loss = loss_fn(model(batch))
            loss.backward()
            dog.check_loss(loss, step)
            dog.check_grads(model, step)
            opt.step(); opt.clear_grad()

    With an enabled loss scaler (an object with ``is_enable()``)
    non-finite gradients are the scaler's to skip: the trip is counted
    (``handled="amp_skip"``) and not raised, as in the JAX package.
    """

    def __init__(self, action: str = "raise", registry=None):
        self.action = action
        self._registry = registry
        self.trips = 0

    def _reg(self):
        from .metrics import get_registry
        return self._registry if self._registry is not None \
            else get_registry()

    def check_loss(self, loss, step: Optional[int] = None) -> Optional[str]:
        if all_finite({"loss": loss}):
            return None
        self.trips += 1
        return check_numerics({"loss": loss}, step=step, what="loss",
                              action=self.action, registry=self._reg())

    def check_grads(self, layer_or_grads, step: Optional[int] = None,
                    scaler=None) -> Optional[str]:
        """``layer_or_grads``: a module (the ``.grad`` of its named
        parameters) or a name -> tensor dict."""
        if hasattr(layer_or_grads, "named_parameters"):
            grads = {k: p.grad for k, p in layer_or_grads.named_parameters()
                     if p.grad is not None}
        else:
            grads = dict(layer_or_grads)
        if all_finite(grads):
            return None
        self.trips += 1
        offender = first_nonfinite(grads)
        if scaler is not None and scaler.is_enable():
            self._reg().counter(
                "numerics_nonfinite_total",
                "NaN/Inf watchdog trips by kind").inc(
                    what="grad", handled="amp_skip")
            return offender
        return check_numerics(grads, step=step, what="grad",
                              action=self.action, registry=self._reg())
