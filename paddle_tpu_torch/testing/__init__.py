"""Test-support utilities shipped with the framework.

``paddle_tpu_torch.testing.chaos`` is the deterministic fault injector
the recovery paths (a poisoned serving request, a skipped non-finite
training step) are proven against: a copy of
``paddle_tpu/testing/chaos.py`` (the same spec and seed fire on the same
occurrences), see docs/FAULT_TOLERANCE.md.
"""

from . import chaos  # noqa: F401

__all__ = ["chaos"]
