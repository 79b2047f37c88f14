"""vln_hamt_torch — PyTorch / CUDA port of vln_hamt_tpu for one NVIDIA H100.

Mirrors the JAX package's module layout: fine-tuning and evaluation of
the R2R family and the task variants (R2R-Back, CVDN, REVERIE), and
proxy-task pretraining. Every attention on a CUDA tensor runs through
the hand-written kernels in ``csrc/attention.cu`` and
``csrc/attention_bwd.cu`` (``ops/attention.py``).
"""
