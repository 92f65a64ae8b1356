"""paddle.callbacks namespace: the hapi callback family
(``paddle_tpu/callbacks.py``)."""

from .hapi.callbacks import *  # noqa: F401,F403
from .hapi.callbacks import __all__  # noqa: F401
