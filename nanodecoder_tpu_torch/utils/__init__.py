"""Observability: statistics, the inference record, per-stage timers and
logging (the port's copies of `nanodecoder_tpu.utils`)."""
