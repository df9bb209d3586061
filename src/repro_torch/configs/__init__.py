from .registry import all_configs, get_config, list_architectures
from .shapes import INPUT_SHAPES, InputShape

__all__ = ["all_configs", "get_config", "list_architectures",
           "INPUT_SHAPES", "InputShape"]
