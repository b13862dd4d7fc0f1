from .partition import by_class
from .synthetic import class_images, lm_tokens

__all__ = ["by_class", "class_images", "lm_tokens"]
