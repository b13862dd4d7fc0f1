from .sgd import paper_lr

__all__ = ["paper_lr"]
