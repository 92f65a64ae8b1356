from .auto_cast import auto_cast, cast_inputs

__all__ = ["auto_cast", "cast_inputs"]
