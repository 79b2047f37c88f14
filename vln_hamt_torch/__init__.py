"""vln_hamt_torch — PyTorch / CUDA port of vln_hamt_tpu for one NVIDIA H100.

Mirrors the JAX package's module layout. This slice serves R2R greedy
evaluation: every attention on a CUDA tensor runs through the
hand-written kernel in ``csrc/attention.cu`` (``ops/attention.py``).
"""
