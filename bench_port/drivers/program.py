"""The system under test, built from a configuration file: the port's
model definitions and its FL task, and the two models' reference halves
(the weight maker, the loss) that go with each model kind."""
from __future__ import annotations

import torch

from bench_port.reference import train as ref_train
from bench_port.reference import weights as ref_weights


def arch_config(model: dict, precision: dict):
    """The port's ``ArchConfig`` of an LM configuration file, every size
    taken from the file."""
    from repro_torch.configs import get_config
    ssm = model["ssm_cfg"]
    cfg = get_config(model["arch"]).replace(
        n_layers=model["n_layer"], d_model=model["d_model"],
        vocab=ref_weights.vocab_rows(model), ssm_state=ssm["d_state"],
        ssm_conv=ssm["d_conv"], ssm_expand=ssm["expand"],
        ssm_head_dim=ssm["headdim"], norm_eps=model["norm_epsilon"],
        tie_embeddings=model["tie_embeddings"],
        dtype=precision["activations"], param_dtype=precision["params"])
    if (cfg.d_inner, cfg.ssm_heads, cfg.pattern) != (
            model["d_inner"], model["nheads"], ("mamba",)):
        raise ValueError(f"the port's {model['arch']} is not the file's: "
                         f"d_inner {cfg.d_inner}, heads {cfg.ssm_heads}, "
                         f"pattern {cfg.pattern}")
    return cfg


def model_def(config: dict):
    """The port's ``ModelDef`` of the configuration (a classifier: the
    CNN, or the LM's next token at the last position)."""
    model = config["model"]
    if model["kind"] == "cnn":
        from repro_torch.models.small import make_cnn
        return make_cnn(model["image_size"], model["channels"],
                        model["classes"], model["fc_width"], model["name"])
    if model["kind"] == "lm":
        from repro_torch.examples.federated_pretrain import cfg_as_model
        return cfg_as_model(arch_config(model, config["precision"]),
                            model["arch"])
    raise ValueError(f"unknown model kind {model['kind']!r}")


def make_weights(config: dict, seed: int, device) -> dict:
    """The benchmark's weights of the configuration from ``seed``, on the
    device, checked against the file's parameter count."""
    model = config["model"]
    gen = torch.Generator(device=device).manual_seed(seed)
    make = {"cnn": ref_weights.cnn_params, "lm": ref_weights.lm_params}
    params = make[model["kind"]](model, gen)
    n = ref_weights.count(params)
    if n != config["params"]:
        raise ValueError(f"{config['name']}: {n} params, the file says "
                         f"{config['params']}")
    return params


def set_precision(config: dict) -> None:
    """The configuration's stated TF32 use on the card."""
    precision = config["precision"]
    torch.backends.cudnn.allow_tf32 = precision.get("convolutions") == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = precision.get("matmuls") == "tf32"


def client_loss(config: dict):
    """The reference loss of one client batch for the model kind."""
    return {"cnn": ref_train.cnn_loss,
            "lm": ref_train.lm_last_token_loss}[config["model"]["kind"]]
