from .optimizers import (OPTIMIZERS, Optimizer, adam, adamw, apply_updates,
                         clip_by_global_norm, global_norm, make_optimizer,
                         proximal_grad, sgd, zeros_like_f32)

__all__ = ["OPTIMIZERS", "Optimizer", "adam", "adamw", "apply_updates",
           "clip_by_global_norm", "global_norm", "make_optimizer",
           "proximal_grad", "sgd", "zeros_like_f32"]
