"""The benchmark of whisper_tpu_torch, the port on one NVIDIA H100.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the checkout's root names the cells; everything a cell
needs is found by name under this folder (cells.py).  The harness runs
the port and compares what it served with a plain reference
(reference/); it imports torch, numpy and the port, never JAX.
"""
