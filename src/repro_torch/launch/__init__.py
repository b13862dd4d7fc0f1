"""The LLM zoo's launch layer: step builders (``steps``), the batched
serving driver (``serve``) and the hierarchical FL training driver
(``train``)."""
from .steps import (init_fl_histories, make_hfl_train_step,
                    make_prefill_step, make_serve_step, make_train_step)

__all__ = ["init_fl_histories", "make_hfl_train_step", "make_prefill_step",
           "make_serve_step", "make_train_step"]
