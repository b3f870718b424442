"""Plain references, one module a model family.  A configuration file
names the module that judges and counts it with "reference" (a module of
this package); without the key it is `model`, the transformer.  Each
module gives `Ref` (the forward pass: `Ref(flat, model, precision,
dropout)`, `encode`, `decode`), `param_shapes(model)`,
`train_step_flops` and `serve_batch_flops`."""

from __future__ import annotations

import importlib


def module(config: dict):
    """The reference module of a configuration file's contents."""
    return importlib.import_module(f"{__name__}.{config.get('reference') or 'model'}")
