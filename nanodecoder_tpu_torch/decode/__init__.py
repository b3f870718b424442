"""Greedy, beam-search and sampling decoding, penalties, batch
basecalling (`Translator`) and the streaming engine.

The JAX package's re-exports resolve on first use, so the engine's
finishing processes load `decode.finish` without torch."""

from nanodecoder_tpu_torch._lazy import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "greedy_decode": "greedy", "beam_decode": "beam", "length_penalty": "penalties",
    "Translator": "translator",
})
