"""The ``hnd_ghnd`` op namespace the kernel modules define their ops on
(ops/library.py says what an op is made of and imports them all)."""
from __future__ import annotations

import torch

NAMESPACE = "hnd_ghnd"
_lib = torch.library.Library(NAMESPACE, "DEF")


def check_device(t: torch.Tensor, what: str) -> None:
    """The ops run on the CPU (the plain versions) and on CUDA (the
    kernels); a wrapper given a tensor anywhere else raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def define(schema: str, cpu, cuda, fake):
    """Define ``NAMESPACE::schema`` with its CPU, CUDA and fake kernels;
    -> the op's overload."""
    name = schema.split("(", 1)[0]
    _lib.define(schema)
    _lib.impl(name, cpu, "CPU")
    _lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_lib)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
