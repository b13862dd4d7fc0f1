"""The LLM zoo's launch layer: step builders (``steps``) and the batched
serving driver (``serve``)."""
from .steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
