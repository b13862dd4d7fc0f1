from .partition import by_class
from .synthetic import class_images

__all__ = ["by_class", "class_images"]
