"""PyTorch/CUDA port of hnd_ghnd_tpu: the GHND Faster R-CNN serving path,
the GHND distillation step and supervised training of the org Faster
R-CNN.

Imports torch and numpy only; the CUDA kernels of csrc/ build on first use
(_build.py).  See README.md, "PyTorch/CUDA port".
"""
