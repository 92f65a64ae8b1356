from .auto_cast import amp_guard, auto_cast, cast_inputs, is_active

__all__ = ["auto_cast", "amp_guard", "cast_inputs", "is_active"]
