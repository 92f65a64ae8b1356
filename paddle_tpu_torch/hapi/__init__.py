from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401
from . import callbacks  # noqa: F401
