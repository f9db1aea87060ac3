"""The ``hnd_ghnd`` op namespace the kernel modules define their ops on
(ops/library.py says what an op is made of and imports them all)."""
from __future__ import annotations

import contextlib

import torch

NAMESPACE = "hnd_ghnd"
_lib = torch.library.Library(NAMESPACE, "DEF")


def check_device(t: torch.Tensor, what: str) -> None:
    """The ops run on the CPU (the plain versions) and on CUDA (the
    kernels); a wrapper given a tensor anywhere else raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


_CURRENT = contextlib.nullcontext()


def on_card(device: torch.device):
    """A context in which ``device``, a card, is the current CUDA device.
    The kernels read their card from ``cudaGetDevice`` (its SM count, the
    shared-memory opt-ins, the cooperative grid) and launch on the stream
    the wrapper hands them, so each launch runs under this guard for its
    inputs' card.  On the card that is already current it switches
    nothing (one ``cudaGetDevice``, cached by the runtime), nor for a CPU
    tensor (the launch code rehearsed on the host against a stub
    library)."""
    if device.type != "cuda" or device.index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(device)


def define(schema: str, cpu, cuda, fake):
    """Define ``NAMESPACE::schema`` with its CPU, CUDA and fake kernels;
    -> the op's overload."""
    name = schema.split("(", 1)[0]
    _lib.define(schema)
    _lib.impl(name, cpu, "CPU")
    _lib.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_lib)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
