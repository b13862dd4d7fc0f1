from .partition import (by_class, class_pools, population_classes,
                        sample_class_batches)
from .synthetic import class_images, lm_tokens

__all__ = ["by_class", "class_images", "class_pools", "lm_tokens",
           "population_classes", "sample_class_batches"]
