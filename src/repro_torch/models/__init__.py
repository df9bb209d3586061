from .small import ModelDef, make_cnn

__all__ = ["ModelDef", "make_cnn"]
