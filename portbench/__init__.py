"""The benchmark of the port (``upow_tpu_torch``) on an NVIDIA H100: see
``harness.py`` and ``PERF.md``."""
