"""The benchmark of nanodecoder_tpu_torch, the PyTorch and CUDA port, on
one NVIDIA H100.  `python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json once."""
