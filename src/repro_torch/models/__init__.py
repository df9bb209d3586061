from .config import ArchConfig, param_count
from .small import ModelDef, make_cnn
from .transformer import (decode_step, forward, init_cache, init_params,
                          prefill)

__all__ = ["ArchConfig", "ModelDef", "decode_step", "forward", "init_cache",
           "init_params", "make_cnn", "param_count", "prefill"]
