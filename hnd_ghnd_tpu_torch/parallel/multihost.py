"""Multi-process coordination over ``torch.distributed``.

Counterpart of hnd_ghnd_tpu/parallel/multihost.py (reference
src/utils/main_util.py:29-62 init_distributed_mode / setup_for_distributed,
src/utils/misc_util.py:72-139 all_gather / reduce_dict, :236-262
is_main_process / save_on_master).  One process drives one device.  The
JAX package runs a multi-process job as one global mesh; the port's ranks
reproduce its semantics with explicit collectives:

  * ``all_reduce_grads(params, "sum")``: the GSPMD distill step, whose
    loss is a sum over the global batch (hnd_ghnd_tpu/parallel/mesh.py:
    179-197), so the gradient of N ranks is the sum of theirs;
  * ``all_reduce_grads(params, "avg")``: a GSPMD mean (the ext filter's
    cross-entropy) and the ``shard_map`` steps' ``pmean``
    (mesh.py:369-375), DDP's average;
  * the trainable BatchNorm's statistics over the global batch
    (models/layers.py), which its forward and backward all-reduce.

Each helper keeps the single-process fast path: with no group of more
than one rank up, nothing is communicated.  The group is the default one,
made here (``maybe_init_distributed``) or by the caller before it.  Its
backend is NCCL for a CUDA device and gloo for the CPU, unless named;
gloo also all-reduces CUDA tensors, through the host, which is how two
ranks share one card (NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import builtins
import datetime
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# torch's own default for a gloo group: a rank that dies leaves the others
# waiting at most this long in a collective
DEFAULT_TIMEOUT_S = 1800.0
REDUCE_OPS = ("sum", "avg")

_print = builtins.print


def group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if group_up() else 0


def get_world_size() -> int:
    return dist.get_world_size() if group_up() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def setup_for_distributed(is_master: bool) -> None:
    """Silence ``print`` on every rank but the master (the reference's
    builtins patch, main_util.py:29-40); ``print(..., force=True)`` still
    prints.  ``destroy`` puts the builtin back."""

    def print_(*args, force: bool = False, **kwargs):
        if is_master or force:
            _print(*args, **kwargs)

    builtins.print = print_


def default_backend(device: torch.device | str) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed_mode(dist_url: str, world_size: int, rank: int,
                          device: torch.device | str = "cpu",
                          backend: Optional[str] = None,
                          timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """``init_process_group`` of ``world_size`` ranks at ``dist_url``
    (``env://`` reads MASTER_ADDR and MASTER_PORT, ``tcp://host:port``
    names rank 0's address), unless a group is already up: then that group
    is used.  The backend is ``backend``, else NCCL on a CUDA ``device`` and
    gloo on the CPU; ``timeout_s`` bounds every collective.  Returns True
    when this call made the group."""
    if group_up():
        return False
    dist.init_process_group(
        backend=backend or default_backend(device), init_method=dist_url,
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_s))
    setup_for_distributed(get_rank() == 0)
    return True


def rendezvous_from(args: Any = None, env: Optional[Dict[str, str]] = None
                    ) -> Optional[Tuple[str, int, int]]:
    """(url, world size, rank) of a multi-process launch, or None for one
    process.  The sources, in order: the CLI flags (``--dist_url``,
    ``--world_size``, and JAX's ``--coordinator_address``,
    ``--num_processes``, ``--process_id``), then the environment (RANK,
    WORLD_SIZE as torchrun sets them, with ``env://``; JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID).  A launch is multi-process when a
    rank is known; without one, ``--world_size`` alone runs one process,
    as the reference does without RANK and WORLD_SIZE."""
    env = os.environ if env is None else env

    def first(*values):
        return next((v for v in values if v is not None), None)

    def flag(name):
        return getattr(args, name, None) if args is not None else None

    rank = first(flag("process_id"), env.get("RANK"), env.get("JAX_PROCESS_ID"))
    world = first(flag("world_size"), flag("num_processes"),
                  env.get("WORLD_SIZE"), env.get("JAX_NUM_PROCESSES"))
    coord = first(flag("coordinator_address"),
                  env.get("JAX_COORDINATOR_ADDRESS"))
    url = first(flag("dist_url"), None if coord is None else f"tcp://{coord}")
    if rank is None:
        if url is not None and int(world or 1) == 1:
            return url, 1, 0
        return None
    if world is None:
        raise ValueError("a rank was given but no world size (--world_size, "
                         "--num_processes or WORLD_SIZE)")
    return url or "env://", int(world), int(rank)


def maybe_init_distributed(args: Any = None,
                           device: torch.device | str = "cpu") -> bool:
    """``init_distributed_mode`` from ``rendezvous_from(args)``, with the
    default backend of ``device``; one process when it finds no launch,
    and the caller's group when one is up.  Returns True when this call
    made the group."""
    if group_up():
        return False
    found = rendezvous_from(args)
    if found is None:
        return False
    url, world, rank = found
    return init_distributed_mode(url, world, rank, device)


def destroy() -> None:
    """Leave the group and print on every rank again."""
    if group_up():
        dist.destroy_process_group()
    builtins.print = _print


def local_rank(env: Optional[Dict[str, str]] = None) -> int:
    """LOCAL_RANK (torchrun), else 0."""
    env = os.environ if env is None else env
    return int(env.get("LOCAL_RANK", 0))


def save_on_master(save_fn: Callable, *args, **kwargs) -> None:
    """Run a checkpoint write on rank 0 only (misc_util.py:260-262)."""
    if is_main_process():
        save_fn(*args, **kwargs)


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order (the reference's
    padded-byte all_gather, misc_util.py:72-112)."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_scalars(values: Dict[str, float],
                   average: bool = True) -> Dict[str, float]:
    """Host scalars summed, or averaged, over the ranks (reduce_dict,
    misc_util.py:115-139): the runners' epoch times.  The step's own
    scalars ride in its gradient bucket instead."""
    if get_world_size() == 1:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                     device=_collective_device())
    all_reduce_([t], "avg" if average else "sum")
    return dict(zip(keys, t.tolist()))


def all_reduce_(tensors: Sequence[torch.Tensor], op: str = "sum") -> None:
    """Each tensor summed (``op`` "sum") or averaged ("avg") over the ranks,
    in place: one all-reduce per (dtype, device) of their flattened
    concatenation.  The average is the sum divided by the rank count, as
    ``lax.pmean`` computes it (an IEEE division by a tensor: CUDA's
    ``x / number`` multiplies by the reciprocal)."""
    if op not in REDUCE_OPS:
        raise ValueError(f"all_reduce_: op `{op}` is not one of {REDUCE_OPS}")
    world = get_world_size()
    if world == 1:
        return
    buckets: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for (dtype, device), ts in buckets.items():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        if op == "avg":
            flat = flat / torch.tensor(world, dtype=dtype, device=device)
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


def all_reduce_grads(params: Sequence[torch.Tensor], op: str,
                     extra: Sequence[torch.Tensor] = ()) -> None:
    """The gradients of ``params`` (those that have one: a parameter
    without a gradient has none on every rank) and the ``extra`` tensors
    reduced by ``op`` in one bucket per dtype (see ``all_reduce_``).  No
    DDP wrapper: the step names the semantics."""
    grads = [p.grad for p in params if p.grad is not None]
    all_reduce_(grads + list(extra), op)


def fold_in(seed: int, rank: int) -> int:
    """A seed of its own for ``rank``, derived from ``seed`` (what
    ``jax.random.fold_in(key, axis_index)`` does for a shard's draws)."""
    state = np.random.SeedSequence([int(seed), int(rank)]).generate_state(
        1, np.uint64)[0]
    return int(state) & (2 ** 63 - 1)
