"""OpenNMT-py state_dict -> the port's params (the port's counterpart of
`nanodecoder_tpu.models.importer`).

The reference basecaller saves `.pt` dicts of {model, generator, vocab,
opts, optim}.  `KEY_RULES` below map the OpenNMT-py v0.x names of a
transformer or biLSTM encoder and a transformer decoder onto the flat
`save_params_npz` keys; `import_flat` builds the same flat float32
arrays as the JAX package's `import_state_dict`, and `import_state_dict`
hands them to `train.checkpoint.params_from_numpy`, which checks every
key and shape against the config.

Layout moves:
  nn.Linear.weight (out, in)     -> w (in, out): transpose;
  nn.Conv1d.weight (out, in, k)  -> w (k, in, out), the stored layout;
  nn.LSTM weight_ih_l0 (4H, in), weight_hh_l0 (4H, H) -> wx (in, 4H),
    wh (H, 4H), gate order i, f, g, o unchanged; bias_ih_l0 + bias_hh_l0
    -> the one bias b;
  nn.LayerNorm weight / bias     -> scale / bias;
  nn.Embedding.weight            -> table.
An RNN-decoder checkpoint raises NotImplementedError, as in the JAX
package: its OpenNMT layout is not pinned down.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np
import torch

from nanodecoder_tpu_torch.config import ModelConfig
from nanodecoder_tpu_torch.device import resolve_device
from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy


def _t(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).T


def _conv(x) -> np.ndarray:
    return np.transpose(np.asarray(x, dtype=np.float32), (2, 1, 0))


def _arr(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _lstm_bias(sd: Mapping[str, Any], prefix: str) -> np.ndarray:
    return _arr(sd[f"{prefix}.bias_ih_l0"]) + _arr(sd[f"{prefix}.bias_hh_l0"])


# Flat key suffix -> (OpenNMT name suffix, layout move), per module kind.
_LINEAR = {"w": (".weight", _t), "b": (".bias", _arr)}
_LN = {"scale": (".weight", _arr), "bias": (".bias", _arr)}
_MHA = {f"{ours}/{leaf}": (f".{theirs}{suffix}", move)
        for ours, theirs in (("q", "linear_query"), ("k", "linear_keys"),
                             ("v", "linear_values"), ("o", "final_linear"))
        for leaf, (suffix, move) in _LINEAR.items()}
_FFN = {f"{ours}/{leaf}": (f".{theirs}{suffix}", move)
        for ours, theirs in (("in", "w_1"), ("out", "w_2"))
        for leaf, (suffix, move) in _LINEAR.items()}
_LSTM = {"wx": (".weight_ih_l0", _t), "wh": (".weight_hh_l0", _t)}

# Per layer i: (our prefix, OpenNMT prefix, rules).
KEY_RULES: dict[str, list[tuple[str, str, dict[str, tuple[str, Callable]]]]] = {
    "transformer_encoder": [
        ("encoder/body/layers/{i}/ln1", "encoder.transformer.{i}.layer_norm", _LN),
        ("encoder/body/layers/{i}/attn", "encoder.transformer.{i}.self_attn", _MHA),
        ("encoder/body/layers/{i}/ln2", "encoder.transformer.{i}.feed_forward.layer_norm",
         _LN),
        ("encoder/body/layers/{i}/ffn", "encoder.transformer.{i}.feed_forward", _FFN),
    ],
    "lstm_encoder": [
        ("encoder/body/layers/{i}/fwd", "encoder.rnn.{i}.fwd", _LSTM),
        ("encoder/body/layers/{i}/bwd", "encoder.rnn.{i}.bwd", _LSTM),
        ("encoder/body/layers/{i}/proj", "encoder.rnn.{i}.proj", _LINEAR),
    ],
    "transformer_decoder": [
        ("decoder/layers/{i}/ln1", "decoder.transformer_layers.{i}.layer_norm_1", _LN),
        ("decoder/layers/{i}/self_attn", "decoder.transformer_layers.{i}.self_attn", _MHA),
        ("decoder/layers/{i}/ln2", "decoder.transformer_layers.{i}.layer_norm_2", _LN),
        ("decoder/layers/{i}/cross_attn", "decoder.transformer_layers.{i}.context_attn",
         _MHA),
        ("decoder/layers/{i}/ln3",
         "decoder.transformer_layers.{i}.feed_forward.layer_norm", _LN),
        ("decoder/layers/{i}/ffn", "decoder.transformer_layers.{i}.feed_forward", _FFN),
    ],
}


def _apply(out: dict[str, np.ndarray], sd: Mapping[str, Any], ours: str, theirs: str,
           rules: dict[str, tuple[str, Callable]]) -> None:
    for leaf, (suffix, move) in rules.items():
        out[f"{ours}/{leaf}"] = move(sd[theirs + suffix])


def import_flat(sd: Mapping[str, Any], cfg: ModelConfig) -> dict[str, np.ndarray]:
    """A state_dict-like mapping (torch tensors or numpy arrays) -> the
    flat `save_params_npz` arrays, float32 in the stored layouts."""
    if cfg.decoder_type != "transformer":
        raise NotImplementedError(
            "RNN-decoder import pends the real reference layout")
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    out: dict[str, np.ndarray] = {}
    front = "encoder.frontend"
    for i in range(len(cfg.conv_channels)):
        out[f"encoder/frontend/convs/{i}/w"] = _conv(sd[f"{front}.convs.{i}.weight"])
        out[f"encoder/frontend/convs/{i}/b"] = _arr(sd[f"{front}.convs.{i}.bias"])
    _apply(out, sd, "encoder/frontend/proj", f"{front}.proj", _LINEAR)
    _apply(out, sd, "encoder/frontend/ln", f"{front}.ln", _LN)
    encoder = {"transformer": "transformer_encoder", "lstm": "lstm_encoder"}
    if cfg.encoder_type not in encoder:
        raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}")
    for kind, n_layers in ((encoder[cfg.encoder_type], cfg.enc_layers),
                           ("transformer_decoder", cfg.dec_layers)):
        for i in range(n_layers):
            for ours, theirs, rules in KEY_RULES[kind]:
                _apply(out, sd, ours.format(i=i), theirs.format(i=i), rules)
            if kind == "lstm_encoder":
                for d in ("fwd", "bwd"):
                    out[f"encoder/body/layers/{i}/{d}/b"] = _lstm_bias(
                        sd, f"encoder.rnn.{i}.{d}")
    _apply(out, sd, "encoder/body/ln_out", "encoder.layer_norm", _LN)
    _apply(out, sd, "decoder/ln_out", "decoder.layer_norm", _LN)
    out["tgt_embed/table"] = _arr(sd["decoder.embeddings.weight"])
    _apply(out, sd, "generator", "generator", _LINEAR)
    return out


def import_state_dict(sd: Mapping[str, Any], cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> dict[str, Any]:
    """The full model from a state_dict-like mapping, as nested float32
    tensors on `device`."""
    return params_from_numpy(import_flat(sd, cfg), cfg, device)


def load_torch_checkpoint(path: str, cfg: ModelConfig,
                          device: str | torch.device = "cuda") -> dict[str, Any]:
    """Load a reference-style `.pt` checkpoint ({'model': state_dict,
    'generator': state_dict, ...}, or a bare state_dict) onto `device`.
    The file is unpickled in full (it holds the reference's option and
    vocabulary objects), so load only checkpoints from a trusted source."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location=dev, weights_only=False)
    sd = dict(ckpt["model"]) if "model" in ckpt else dict(ckpt)
    # The reference saves its generator, nn.Sequential(Linear, LogSoftmax),
    # apart: 0.weight / 0.bias.
    for k, v in (ckpt.get("generator") or {}).items():
        sd["generator." + k.replace("0.weight", "weight").replace("0.bias", "bias")] = v
    return import_state_dict(sd, cfg, dev)
