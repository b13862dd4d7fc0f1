from .cnn import (cnn_accuracy, cnn_accuracy_many, cnn_accuracy_shifted,
                  cnn_features, cnn_logits, cnn_logits_shifted, cnn_loss,
                  cnn_loss_shifted, cnn_specs, conv3x3_same_shifted,
                  params_from_numpy, stack_params)
from .config import (ArchConfig, InputShape, MLAConfig, MoEConfig,
                     RGLRUConfig, SSMConfig)
from .spec import ParamSpec, count_params, init_from_specs, init_params
from .transformer import (cache_specs, decode_step, encode,
                          forward_train, loss_fn, param_specs, prefill)

__all__ = ["ArchConfig", "InputShape", "MLAConfig", "MoEConfig",
           "ParamSpec", "RGLRUConfig", "SSMConfig", "cache_specs", "count_params",
           "cnn_accuracy", "cnn_accuracy_many", "cnn_accuracy_shifted",
           "cnn_features", "cnn_logits", "cnn_logits_shifted", "cnn_loss",
           "cnn_loss_shifted", "cnn_specs", "conv3x3_same_shifted",
           "decode_step", "encode", "forward_train", "init_from_specs",
           "init_params", "loss_fn", "param_specs", "params_from_numpy",
           "prefill", "stack_params"]
