"""Weights interchange with the JAX package's flat `.npz` export, and the
port's training checkpoints.

`nanodecoder_tpu.train.checkpoint.save_params_npz` writes one array per
parameter under its `/`-joined pytree path, e.g.
`encoder/body/layers/0/attn/q/w`.  The port keeps the same nesting as
plain dicts and lists of tensors, so every parameter is found under the
same path in both packages, and the port's `save_params_npz` writes a
file that the JAX package's `load_params_npz` reads.

Layouts: a dense `w` stays (in, out) (the port multiplies `x @ w` as the
JAX package does); a conv `w` is stored (W, I, O) and becomes torch's
(O, I, W) for `conv1d`.  `params_to_numpy` is the exact inverse.

`CheckpointManager` keeps training checkpoints in the port's own format:

    <directory>/config.json            Config.to_json()
    <directory>/<step>/params.npz      save_params_npz keys and layouts
    <directory>/<step>/opt_state.npz   count, step, mu/<key>, nu/<key>

A save writes a temporary directory and renames it into place, so an
interrupted save leaves the earlier steps readable; the newest
`max_to_keep` steps are kept.  The JAX package's orbax checkpoint
directories are not read (reading them needs orbax, which imports JAX).
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import numpy as np
import torch

from nanodecoder_tpu_torch.config import Config, ModelConfig
from nanodecoder_tpu_torch.device import resolve_device
from nanodecoder_tpu_torch.models.model import named_leaves
from nanodecoder_tpu_torch.train.trainer import TrainState
from nanodecoder_tpu_torch.utils.logging import get_logger

log = get_logger("checkpoint")


def _ln(prefix: str, d: int) -> dict[str, tuple[int, ...]]:
    return {f"{prefix}/scale": (d,), f"{prefix}/bias": (d,)}


def _dense(prefix: str, n_in: int, n_out: int) -> dict[str, tuple[int, ...]]:
    return {f"{prefix}/w": (n_in, n_out), f"{prefix}/b": (n_out,)}


def _lstm_cell(prefix: str, n_in: int, hidden: int) -> dict[str, tuple[int, ...]]:
    return {f"{prefix}/wx": (n_in, 4 * hidden), f"{prefix}/wh": (hidden, 4 * hidden),
            f"{prefix}/b": (4 * hidden,)}


def _encoder_body_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d = cfg.d_model
    shapes: dict[str, tuple[int, ...]] = {}
    for i in range(cfg.enc_layers):
        p = f"encoder/body/layers/{i}"
        if cfg.encoder_type == "lstm":
            for direction in ("fwd", "bwd"):
                shapes.update(_lstm_cell(f"{p}/{direction}", d, cfg.lstm_hidden))
            shapes.update(_dense(f"{p}/proj", 2 * cfg.lstm_hidden, d))
            continue
        shapes.update(_ln(f"{p}/ln1", d))
        shapes.update(_ln(f"{p}/ln2", d))
        for name in "qkvo":
            shapes.update(_dense(f"{p}/attn/{name}", d, d))
        shapes.update(_dense(f"{p}/ffn/in", d, cfg.enc_ffn_dim))
        shapes.update(_dense(f"{p}/ffn/out", cfg.enc_ffn_dim, d))
    shapes.update(_ln("encoder/body/ln_out", d))
    return shapes


def _rnn_decoder_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d = cfg.d_model
    shapes: dict[str, tuple[int, ...]] = {}
    for i in range(cfg.dec_layers):
        shapes.update(_lstm_cell(f"decoder/layers/{i}", 2 * d if i == 0 else d, d))
    score = cfg.rnn_attention
    if score == "general":
        shapes["decoder/attn/wa/w"] = (d, d)
    elif score == "mlp":
        shapes["decoder/attn/wq/w"] = (d, d)
        shapes.update(_dense("decoder/attn/wk", d, d))
        shapes["decoder/attn/va/w"] = (d, 1)
    elif score != "dot":
        raise ValueError(f"unknown attention score {score!r}")
    shapes["decoder/attn/wo/w"] = (2 * d, d)
    if score == "mlp":
        shapes["decoder/attn/wo/b"] = (d,)
    return shapes


def _transformer_decoder_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d = cfg.d_model
    dk = d // cfg.dec_heads * cfg.dec_kv
    shapes: dict[str, tuple[int, ...]] = {}
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
    return shapes


def expected_param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Flat key -> stored shape for cfg's encoder and decoder types."""
    if cfg.encoder_type not in ("transformer", "lstm"):
        raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}")
    decoders = {"transformer": _transformer_decoder_shapes, "rnn": _rnn_decoder_shapes}
    if cfg.decoder_type not in decoders:
        raise ValueError(f"unknown decoder_type {cfg.decoder_type!r}")
    d, v = cfg.d_model, cfg.vocab_size
    shapes: dict[str, tuple[int, ...]] = {}
    in_ch = 1
    for i, (ch, ker) in enumerate(zip(cfg.conv_channels, cfg.conv_kernels)):
        shapes[f"encoder/frontend/convs/{i}/w"] = (ker, in_ch, ch)
        shapes[f"encoder/frontend/convs/{i}/b"] = (ch,)
        in_ch = ch
    shapes.update(_dense("encoder/frontend/proj", in_ch, d))
    shapes.update(_ln("encoder/frontend/ln", d))
    shapes.update(_encoder_body_shapes(cfg))
    shapes.update(decoders[cfg.decoder_type](cfg))
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
    flat = {}
    for key, t in named_leaves(params).items():
        arr = t.detach().cpu().numpy()
        flat[key] = arr.transpose(2, 1, 0) if _is_conv_weight(key) else arr
    return flat


def save_params_npz(path: str, params: dict[str, Any]) -> None:
    """Write params as the JAX package's flat `.npz` export."""
    np.savez(path, **params_to_numpy(params))


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


def load_config(directory: str) -> Config:
    with open(os.path.join(directory, "config.json")) as f:
        return Config.from_json(f.read())


class CheckpointManager:
    """Training checkpoints of one run (format in the module docstring)."""

    PARAMS, OPT = "params.npz", "opt_state.npz"

    def __init__(self, directory: str, config: Config, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.config = config
        self.max_to_keep = max_to_keep
        cfg_path = os.path.join(self.directory, "config.json")
        if not os.path.exists(cfg_path):
            tmp = cfg_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(config.to_json())
            os.replace(tmp, cfg_path)

    def all_steps(self) -> list[int]:
        """The saved steps, oldest first (only completed saves)."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, self.OPT)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state) -> None:
        """Write a TrainState (params, opt_state, step) as `step`."""
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_params_npz(os.path.join(tmp, self.PARAMS), state.params)
        opt = {"count": np.asarray(int(state.opt_state["count"]), np.int64),
               "step": np.asarray(int(state.step), np.int64)}
        for name in ("mu", "nu"):
            for key, arr in params_to_numpy(state.opt_state.get(name, {})).items():
                opt[f"{name}/{key}"] = arr
        np.savez(os.path.join(tmp, self.OPT), **opt)
        final = os.path.join(self.directory, str(step))
        old = None
        if os.path.exists(final):  # a re-save of one step replaces it
            old = os.path.join(self.directory, f".old-{step}-{os.getpid()}")
            os.rename(final, old)
        os.rename(tmp, final)
        if old is not None:
            shutil.rmtree(old)
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(s)))
        log.info("saved checkpoint @ step %d -> %s", step, self.directory)

    def restore(self, step: int | None = None, device: str | torch.device = "cuda"):
        """The TrainState saved at `step` (default: the latest) on `device`;
        opt_state's mu and nu are keyed by param path."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        root = os.path.join(self.directory, str(step))
        mcfg = self.config.model
        params = load_params_npz(os.path.join(root, self.PARAMS), mcfg, device)
        with np.load(os.path.join(root, self.OPT)) as data:
            flat = {k: data[k] for k in data.files}
        opt: dict[str, Any] = {"count": torch.tensor(int(flat["count"]),
                                                     dtype=torch.int64)}
        for name in ("mu", "nu"):
            part = {k[len(name) + 1:]: v for k, v in flat.items()
                    if k.startswith(name + "/")}
            if part:
                opt[name] = named_leaves(params_from_numpy(part, mcfg, device))
        log.info("restored checkpoint @ step %d from %s", step, self.directory)
        return TrainState(params, opt, int(flat["step"]))
