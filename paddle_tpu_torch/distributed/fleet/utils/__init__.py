"""fleet.utils: activation recompute (the ``fs`` helpers come with the
later parts of ``distributed/``)."""

from .recompute import (recompute, recompute_sequential,  # noqa: F401
                        resolve_checkpoint_policy)

__all__ = ["recompute", "recompute_sequential", "resolve_checkpoint_policy"]
