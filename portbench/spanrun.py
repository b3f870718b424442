"""`ClockedTracer`, the name under which tests/test_torch_spans.py takes
the tracer that puts the device trace on the spans' clock: `trace.Tracer`."""

from portbench.trace import Tracer as ClockedTracer

__all__ = ["ClockedTracer"]
