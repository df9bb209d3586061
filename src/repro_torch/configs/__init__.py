from .registry import PORT_ONLY, all_configs, get_config, list_architectures
from .shapes import INPUT_SHAPES, InputShape

__all__ = ["PORT_ONLY", "all_configs", "get_config", "list_architectures",
           "INPUT_SHAPES", "InputShape"]
