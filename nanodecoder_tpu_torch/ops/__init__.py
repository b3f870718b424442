"""Hand-written CUDA kernels (csrc/) with their wrappers and plain PyTorch
versions.  The JAX package's re-exports resolve on first use."""

from nanodecoder_tpu_torch._lazy import lazy_exports

__getattr__ = lazy_exports(__name__, {
    "decode_attention": "attention", "decode_attention_reference": "attention",
})
