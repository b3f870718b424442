"""The model: modules, encoders (transformer, biLSTM), decoders
(transformer step, input-feed RNN), the OpenNMT importer.

The JAX package's re-exports (`init_model`, `encode`, ...) resolve on
first use: `ops.encoder_attention` imports `models.modules`, and
`models.model` imports it back, so loading `models.model` with this
package would close that cycle.
"""

from nanodecoder_tpu_torch._lazy import lazy_exports

__getattr__ = lazy_exports(__name__, {
    name: "model" for name in ("decode_step", "decode_teacher_forced", "encode",
                               "init_decode_state", "init_model")})
