"""minipic_torch — the PyTorch/CUDA port of ``minipic_tpu``.

Same layout and names as the JAX package; plain functions on tensors and
NamedTuple state.  The particle advance runs a hand-written CUDA kernel
(``csrc/advance.cu``) on CUDA tensors and its plain torch version on CPU
tensors.  This package never imports JAX.
"""
