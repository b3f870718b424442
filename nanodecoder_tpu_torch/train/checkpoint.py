"""Weights interchange with the JAX package's flat `.npz` export, the
port's training checkpoints, and the JAX package's orbax checkpoints.

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
`max_to_keep` of the port's steps are kept.

The JAX package's `CheckpointManager` (orbax, `StandardSave` of the
whole TrainState) writes `<directory>/config.json` too, and per step

    <directory>/<step>/default/_METADATA        the pytree's leaves (JSON)
    <directory>/<step>/default/manifest.ocdbt   an OCDBT key-value store
                                                (`io.ocdbt`) of zarr v2
                                                arrays (`io.zarr`)

with one array per leaf, named by its path joined with dots:
`params.encoder.body.layers.0.attn.q.w`, optax's state under
`opt_state.<i>...` (see `_optax_layout`) and `step`.
`read_jax_checkpoint` builds the port's TrainState from such a step
without JAX, orbax or tensorstore (zstd and CRC32C run in
`native.zstd`), and `CheckpointManager.restore` and the CLIs take
either format.  The port never writes into, renames or deletes a step
directory that it did not write: a save onto one raises
FileExistsError, and pruning counts the port's steps alone.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from nanodecoder_tpu_torch.config import Config, ModelConfig, TrainConfig
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


# -- the JAX package's orbax checkpoints ----------------------------------------

JAX_ITEM = "default"  # the item directory orbax's CheckpointManager writes per step


def is_jax_checkpoint(step_dir: str) -> bool:
    """Whether `step_dir` is a step the JAX package's CheckpointManager
    wrote (`default/manifest.ocdbt` or `default/_METADATA` inside)."""
    item = os.path.join(step_dir, JAX_ITEM)
    return any(os.path.isfile(os.path.join(item, n)) for n in ("manifest.ocdbt", "_METADATA"))


def jax_steps(directory: str) -> list[int]:
    """The JAX package's orbax steps in `directory`, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and is_jax_checkpoint(os.path.join(directory, n)))


def _optax_layout(cfg: TrainConfig) -> tuple[str | None, str, list[str]]:
    """Where optax keeps its state in the TrainState that the JAX package
    builds (`nanodecoder_tpu.train.optim.build_optimizer`): (Adam's
    prefix or None for SGD, the schedule's prefix, the empty states).

    The chain is [clip_by_global_norm (only when grad_clip > 0), the
    optimizer]; adam is (scale_by_adam, scale_by_schedule), adamw puts
    add_decayed_weights between them, sgd is (identity,
    scale_by_schedule).  Clipping, weight decay and identity keep an
    EmptyState, recorded as a leaf of None."""
    i = 1 if cfg.grad_clip > 0 else 0
    empty = ["opt_state.0"] if i else []
    opt = f"opt_state.{i}"
    if cfg.optimizer == "adam":
        return f"{opt}.0", f"{opt}.1", empty
    if cfg.optimizer == "adamw":
        return f"{opt}.0", f"{opt}.2", empty + [f"{opt}.1"]
    if cfg.optimizer == "sgd":
        return None, f"{opt}.1", empty + [f"{opt}.0"]
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _jax_leaves(item: str) -> dict[str, bool]:
    """Dotted leaf name -> whether it holds an array, from `_METADATA`'s
    tree_metadata."""
    with open(os.path.join(item, "_METADATA")) as f:
        tree = json.load(f)["tree_metadata"]
    leaves = {}
    for entry in tree.values():
        name = ".".join(str(k["key"]) for k in entry["key_metadata"])
        leaves[name] = entry["value_metadata"].get("value_type") != "None"
    return leaves


def _check_jax_leaves(leaves: dict[str, bool], want_arrays: set[str], want_empty: set[str],
                      where: str) -> None:
    arrays = {k for k, v in leaves.items() if v}
    empty = {k for k, v in leaves.items() if not v}
    missing = sorted((want_arrays - arrays) | (want_empty - empty))
    extra = sorted((arrays - want_arrays) | (empty - want_empty))
    if missing or extra:
        raise ValueError(f"{where}: the TrainState's leaves differ from the config's: "
                         f"missing {missing[:5]}{' ...' if len(missing) > 5 else ''}, "
                         f"left over {extra[:5]}{' ...' if len(extra) > 5 else ''}")


def _resolve_jax_step(directory: str, step: int | None) -> str:
    steps = jax_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no orbax checkpoints in {directory}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(f"no orbax checkpoint of step {step} in {directory}")
    return os.path.join(os.path.abspath(directory), str(step))


def _read_jax(directory: str, step: int | None, device, config: Config | None,
              params_only: bool):
    from nanodecoder_tpu_torch.io.ocdbt import OcdbtStore
    from nanodecoder_tpu_torch.io.zarr import ZarrArray

    config = config or load_config(directory)
    step_dir = _resolve_jax_step(directory, step)
    item = os.path.join(step_dir, JAX_ITEM)
    if not os.path.isfile(os.path.join(item, "manifest.ocdbt")):
        raise ValueError(f"{item}: no manifest.ocdbt; only OCDBT checkpoints (orbax's "
                         "default) are read")
    store = OcdbtStore(item)
    keys = list(expected_param_shapes(config.model))
    adam, schedule, empty = _optax_layout(config.train)
    dotted = {k: k.replace("/", ".") for k in keys}
    want = {f"params.{d}" for d in dotted.values()} | {f"{schedule}.count", "step"}
    if adam is not None:
        want |= {f"{adam}.count"} | {f"{adam}.{m}.{d}" for m in ("mu", "nu")
                                     for d in dotted.values()}
    _check_jax_leaves(_jax_leaves(item), want, set(empty), item)

    def floats(prefix: str) -> dict[str, np.ndarray]:
        return {k: ZarrArray(store, f"{prefix}.{d}").as_float32() for k, d in dotted.items()}

    def integer(name: str) -> int:
        arr = ZarrArray(store, name).read()
        if arr.shape != ():
            raise ValueError(f"{item}: {name} has shape {arr.shape}, want a scalar")
        return int(arr)

    params = params_from_numpy(floats("params"), config.model, device)
    if params_only:
        return params
    count = integer(f"{schedule}.count")
    opt: dict[str, Any] = {"count": torch.tensor(count, dtype=torch.int64)}
    if adam is not None:
        if integer(f"{adam}.count") != count:
            raise ValueError(f"{item}: Adam's count {integer(f'{adam}.count')} differs from "
                             f"the schedule's {count}")
        for m in ("mu", "nu"):
            opt[m] = named_leaves(params_from_numpy(floats(f"{adam}.{m}"), config.model,
                                                    device))
    state = TrainState(params, opt, integer("step"))
    log.info("read orbax checkpoint @ step %d from %s", state.step, step_dir)
    return state


def read_jax_checkpoint(directory: str, step: int | None = None,
                        device: str | torch.device = "cuda", config: Config | None = None
                        ) -> TrainState:
    """The port's TrainState from the JAX package's orbax checkpoint of
    `step` (default: the latest) in `directory`: params nested as
    `params_from_numpy` makes them, opt_state {"count", "mu", "nu"} (SGD:
    {"count"}) with mu and nu keyed by param path, and the step.  `config`
    defaults to the directory's config.json and must be the one the run
    trained with: every leaf is checked against it."""
    return _read_jax(directory, step, device, config, params_only=False)


def read_jax_params(directory: str, step: int | None = None,
                    device: str | torch.device = "cuda", config: Config | None = None
                    ) -> dict[str, Any]:
    """The params alone of `read_jax_checkpoint` (the optimizer's arrays
    are not read)."""
    return _read_jax(directory, step, device, config, params_only=True)


class CheckpointManager:
    """Training checkpoints of one run (format in the module docstring)."""

    PARAMS, OPT = "params.npz", "opt_state.npz"

    def __init__(self, directory: str, config: Config, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.config = config
        self.max_to_keep = max_to_keep
        self.last_saved: int | None = None  # the step this manager's last save wrote
        cfg_path = os.path.join(self.directory, "config.json")
        if not os.path.exists(cfg_path):  # per-process name: ranks may race here
            tmp = f"{cfg_path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(config.to_json())
            os.replace(tmp, cfg_path)

    def all_steps(self) -> list[int]:
        """The saved steps, oldest first (only completed saves)."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, self.OPT)))

    def latest_step(self) -> int | None:
        """The port's newest step."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest(self) -> tuple[int, bool] | None:
        """(the newest step of either format, whether it is the JAX
        package's orbax step); on a tie the port's step."""
        steps = [(s, True) for s in self.all_steps()] + [(s, False) for s in
                                                          jax_steps(self.directory)]
        if not steps:
            return None
        step, port = max(steps)
        return step, not port

    def save(self, step: int, state) -> None:
        """Write a TrainState (params, opt_state, step) as `step`.  A step
        directory that is not the port's (no opt_state.npz inside, e.g. the
        JAX package's orbax step) is never replaced: FileExistsError."""
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final) and not os.path.isfile(os.path.join(final, self.OPT)):
            raise FileExistsError(f"{final} exists and is not a checkpoint of the port's "
                                  "trainer; it is left as it is")
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
        old = None
        if os.path.exists(final):  # a re-save of one step replaces it
            old = os.path.join(self.directory, f".old-{step}-{os.getpid()}")
            os.rename(final, old)
        os.rename(tmp, final)
        if old is not None:
            shutil.rmtree(old)
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(s)))
        self.last_saved = step
        log.info("saved checkpoint @ step %d -> %s", step, self.directory)

    def restore(self, step: int | None = None, device: str | torch.device = "cuda"):
        """The TrainState saved at `step` (default: the newest of either
        format; on a tie the port's) on `device`, from the port's files or
        the JAX package's orbax step (`read_jax_checkpoint`); opt_state's
        mu and nu are keyed by param path."""
        if step is None:
            newest = self.latest()
            if newest is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
            step, is_jax = newest
        else:
            is_jax = step not in self.all_steps() and step in jax_steps(self.directory)
        if is_jax:
            return read_jax_checkpoint(self.directory, step, device, self.config)
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
