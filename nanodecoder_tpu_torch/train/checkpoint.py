"""Weights interchange with the JAX package's flat `.npz` export.

`nanodecoder_tpu.train.checkpoint.save_params_npz` writes one array per
parameter under its `/`-joined pytree path, e.g.
`encoder/body/layers/0/attn/q/w`.  The port keeps the same nesting as
plain dicts and lists of tensors, so every parameter is found under the
same path in both packages.

Layouts: a dense `w` stays (in, out) (the port multiplies `x @ w` as the
JAX package does); a conv `w` is stored (W, I, O) and becomes torch's
(O, I, W) for `conv1d`.  `params_to_numpy` is the exact inverse.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from nanodecoder_tpu_torch.config import ModelConfig
from nanodecoder_tpu_torch.device import resolve_device


def _ln(prefix: str, d: int) -> dict[str, tuple[int, ...]]:
    return {f"{prefix}/scale": (d,), f"{prefix}/bias": (d,)}


def _dense(prefix: str, n_in: int, n_out: int) -> dict[str, tuple[int, ...]]:
    return {f"{prefix}/w": (n_in, n_out), f"{prefix}/b": (n_out,)}


def expected_param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Flat key -> stored shape for a transformer/transformer model."""
    if cfg.encoder_type != "transformer" or cfg.decoder_type != "transformer":
        raise ValueError("the port runs transformer encoders and decoders only")
    d, v = cfg.d_model, cfg.vocab_size
    dk = d // cfg.dec_heads * cfg.dec_kv
    shapes: dict[str, tuple[int, ...]] = {}
    in_ch = 1
    for i, (ch, ker) in enumerate(zip(cfg.conv_channels, cfg.conv_kernels)):
        shapes[f"encoder/frontend/convs/{i}/w"] = (ker, in_ch, ch)
        shapes[f"encoder/frontend/convs/{i}/b"] = (ch,)
        in_ch = ch
    shapes.update(_dense("encoder/frontend/proj", in_ch, d))
    shapes.update(_ln("encoder/frontend/ln", d))
    for i in range(cfg.enc_layers):
        p = f"encoder/body/layers/{i}"
        shapes.update(_ln(f"{p}/ln1", d))
        shapes.update(_ln(f"{p}/ln2", d))
        for name in "qkvo":
            shapes.update(_dense(f"{p}/attn/{name}", d, d))
        shapes.update(_dense(f"{p}/ffn/in", d, cfg.enc_ffn_dim))
        shapes.update(_dense(f"{p}/ffn/out", cfg.enc_ffn_dim, d))
    shapes.update(_ln("encoder/body/ln_out", d))
    for i in range(cfg.dec_layers):
        p = f"decoder/layers/{i}"
        for ln in ("ln1", "ln2", "ln3"):
            shapes.update(_ln(f"{p}/{ln}", d))
        for attn in ("self_attn", "cross_attn"):
            shapes.update(_dense(f"{p}/{attn}/q", d, d))
            shapes.update(_dense(f"{p}/{attn}/k", d, dk))
            shapes.update(_dense(f"{p}/{attn}/v", d, dk))
            shapes.update(_dense(f"{p}/{attn}/o", d, d))
        shapes.update(_dense(f"{p}/ffn/in", d, cfg.dec_ffn_dim))
        shapes.update(_dense(f"{p}/ffn/out", cfg.dec_ffn_dim, d))
    shapes.update(_ln("decoder/ln_out", d))
    shapes["tgt_embed/table"] = (v, d)
    shapes.update(_dense("generator", d, v))
    return shapes


def _is_conv_weight(key: str) -> bool:
    return key.startswith("encoder/frontend/convs/") and key.endswith("/w")


def params_from_numpy(flat: dict[str, np.ndarray], cfg: ModelConfig,
                      device: str | torch.device = "cuda") -> dict[str, Any]:
    """Flat `save_params_npz` arrays -> nested float32 tensors on `device`.
    Raises when a key is missing or extra or a shape disagrees with cfg."""
    dev = resolve_device(device)
    want = expected_param_shapes(cfg)
    if set(flat) != set(want):
        missing = sorted(set(want) - set(flat))
        extra = sorted(set(flat) - set(want))
        raise ValueError(f"param keys differ from the config: missing "
                         f"{missing[:5]}, unexpected {extra[:5]}")
    root: dict[str, Any] = {}
    for key in sorted(flat, key=_sort_key):
        arr = np.asarray(flat[key], np.float32)
        if arr.shape != want[key]:
            raise ValueError(f"{key}: shape {arr.shape}, config wants {want[key]}")
        if _is_conv_weight(key):
            arr = arr.transpose(2, 1, 0)  # (W, I, O) -> (O, I, W)
        _insert(root, key.split("/"), torch.tensor(arr, device=dev))
    return root


def params_to_numpy(params: dict[str, Any]) -> dict[str, np.ndarray]:
    """Nested tensors -> flat `save_params_npz` arrays (inverse of
    params_from_numpy)."""
    flat: dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            key = "/".join(path)
            arr = node.detach().cpu().numpy()
            flat[key] = arr.transpose(2, 1, 0) if _is_conv_weight(key) else arr

    walk(params, [])
    return flat


def load_params_npz(path: str, cfg: ModelConfig,
                    device: str | torch.device = "cuda") -> dict[str, Any]:
    """Load a `save_params_npz` export onto `device`."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(flat, cfg, device)


def _sort_key(key: str):
    # Numeric path parts sort as numbers so list slots fill in order.
    return [(0, int(p), "") if p.isdigit() else (1, 0, p) for p in key.split("/")]


def _insert(root: dict[str, Any], parts: list[str], value) -> None:
    node: Any = root
    for part, nxt in zip(parts[:-1], parts[1:]):
        child_default: Any = [] if nxt.isdigit() else {}
        if isinstance(node, list):
            idx = int(part)
            if idx == len(node):
                node.append(child_default)
            node = node[idx]
        else:
            node = node.setdefault(part, child_default)
    last = parts[-1]
    if isinstance(node, list):
        assert int(last) == len(node)
        node.append(value)
    else:
        node[last] = value
