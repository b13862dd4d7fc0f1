"""The LLM zoo's launch layer: step builders (``steps``), the batched
serving driver (``serve``), the hierarchical FL training driver
(``train``), and the encoder run once before a serve run's prefill
(``encode``)."""
from repro_torch.models.transformer import encode

from .steps import (init_fl_histories, make_hfl_train_step,
                    make_prefill_step, make_serve_step, make_train_step)

__all__ = ["encode", "init_fl_histories", "make_hfl_train_step",
           "make_prefill_step", "make_serve_step", "make_train_step"]
