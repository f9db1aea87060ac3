"""PyTorch/CUDA port of hnd_ghnd_tpu: the GHND Faster R-CNN serving path,
the Mask and Keypoint R-CNN eval heads, GHND distillation and supervised
training of the org Faster R-CNN, run by ``runners.mimic_runner`` and
``runners.coco_runner`` from the YAML configs over the COCO loader, scored
by COCOeval, with checkpoints the JAX package reads.

Imports torch and numpy only; the CUDA kernels of csrc/ build on first use
(_build.py).  See README.md, "PyTorch/CUDA port".
"""
