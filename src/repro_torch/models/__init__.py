from .cnn import (cnn_accuracy, cnn_features, cnn_logits, cnn_loss,
                  cnn_specs, params_from_numpy, stack_params)
from .spec import ParamSpec, init_params

__all__ = ["ParamSpec", "cnn_accuracy", "cnn_features", "cnn_logits",
           "cnn_loss", "cnn_specs", "init_params", "params_from_numpy",
           "stack_params"]
