"""fleet.utils: activation recompute and the filesystem transports
(``fs``: ``LocalFS``, ``HDFSClient``, ``retry_with_backoff``)."""

from . import fs  # noqa: F401
from .fs import HDFSClient, LocalFS, retry_with_backoff  # noqa: F401
from .recompute import (recompute, recompute_sequential,  # noqa: F401
                        resolve_checkpoint_policy)

__all__ = ["recompute", "recompute_sequential", "resolve_checkpoint_policy",
           "fs", "LocalFS", "HDFSClient", "retry_with_backoff"]
