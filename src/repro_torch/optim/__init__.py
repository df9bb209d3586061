from .optimizers import (OPTIMIZERS, Optimizer, adam, apply_updates,
                         global_norm, make_optimizer, proximal_grad, sgd,
                         zeros_like_f32)

__all__ = ["OPTIMIZERS", "Optimizer", "adam", "apply_updates",
           "global_norm", "make_optimizer", "proximal_grad", "sgd",
           "zeros_like_f32"]
