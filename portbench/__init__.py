"""The benchmark of the PyTorch and CUDA port (``minipic_torch``) on an
NVIDIA H100: ``python3 -m portbench.run --workload <cell> ...`` (see
``run.py`` and README.md)."""
