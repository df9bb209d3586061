from .config import ArchConfig, param_count
from .small import (SMALL_MODELS, ModelDef, make_char_lstm, make_cnn,
                    make_speech_cnn)
from .ssm import (init_mamba_cache, mamba_block, mamba_decode_step,
                  ssd_chunked)
from .transformer import (decode_step, forward, grads_of, init_cache,
                          init_params, loss_fn, make_train_step, prefill,
                          warm_cross_caches)

__all__ = ["ArchConfig", "ModelDef", "decode_step", "forward", "grads_of",
           "init_cache", "init_mamba_cache", "init_params", "loss_fn",
           "make_char_lstm", "make_cnn", "make_speech_cnn",
           "make_train_step", "SMALL_MODELS", "mamba_block",
           "mamba_decode_step", "param_count", "prefill", "ssd_chunked",
           "warm_cross_caches"]
