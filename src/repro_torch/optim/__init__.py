from .sgd import (OptState, adam_init, adam_step, paper_lr, sgd_init,
                  sgd_step)

__all__ = ["OptState", "adam_init", "adam_step", "paper_lr", "sgd_init",
           "sgd_step"]
