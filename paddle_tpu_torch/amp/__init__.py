from .auto_cast import auto_cast, cast_inputs, is_active

__all__ = ["auto_cast", "cast_inputs", "is_active"]
