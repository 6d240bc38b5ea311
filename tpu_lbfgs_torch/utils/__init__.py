from .accurate import compensated_dot, compensated_norm_sq

__all__ = ["compensated_dot", "compensated_norm_sq"]
