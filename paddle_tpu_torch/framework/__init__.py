from .io import load, save  # noqa: F401

# the JAX package's static-graph switch (``paddle_tpu/__init__.py:129-
# 143``); the port has no ``static/``, so the mode only makes the APIs
# that need it (``hapi.Model.prepare``) refuse
_static_mode = [False]


def enable_static() -> None:
    _static_mode[0] = True


def disable_static(place=None) -> None:
    """Return to eager (dygraph) mode, the default."""
    _static_mode[0] = False


def in_dynamic_mode() -> bool:
    return not _static_mode[0]
