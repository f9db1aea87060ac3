"""One process's mesh over every local card, run as local ranks.

Counterpart of hnd_ghnd_tpu/parallel/mesh.py's ``make_mesh_for_batch`` and
``put_batch`` (mesh.py:43-84) and of the runners' local mesh
(hnd_ghnd_tpu/runners/mimic_runner.py:211-225, coco_runner.py:171-178,
ext_runner.py:179-185): a JAX runner with no multi-process launch builds
one mesh over every local chip, capped by ``--world_size``, of the largest
size that divides the global batch, and shards each batch over it by rows.

The port runs that mesh as D worker processes (``launch_local``), card k
for worker k, in one process group: NCCL across distinct cards, gloo when
a device repeats (two workers sharing one card) or on the CPU.  In a
worker the group's rank and size are the mesh's device index and size
(the steps' collectives, the BatchNorm statistics, the shard of
``fold_in``), and ``multihost.process_index()`` / ``process_count()`` are
0 and 1: the workers are one JAX process, so every worker builds the same
process-level batches (seed, epoch order, buckets) and takes its rows of
each, as ``put_batch`` gives device k its rows (``DetectionLoader(rows=(k,
D))`` slices the batch's indices before it decodes them).
``train.batch_size`` is that process's global batch.  A multi-process launch (torchrun,
``--process_id``) keeps its own semantics: each rank is a JAX process with
one device.
"""
from __future__ import annotations

import os
import pickle
import socket
import sys
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch

from hnd_ghnd_tpu_torch.parallel import multihost


def mesh_size_for_batch(batch_size: int, cards: int) -> int:
    """The largest device count <= ``cards`` that divides ``batch_size``
    (JAX's ``make_mesh_for_batch``: a batch of 4 on 8 devices uses 4)."""
    n = max(int(cards), 1)
    while n > 1 and int(batch_size) % n != 0:
        n -= 1
    return n


def local_devices(args: Any, batch_size: int,
                  devices: Optional[Sequence] = None
                  ) -> Optional[List[torch.device]]:
    """The devices of the local mode for a runner's ``args`` and global
    ``batch_size``, one worker each, or None to run as one process (or as
    the rank of a launch).

    None when a process group is up (the caller's) or a multi-process
    launch is found (``multihost.rendezvous_from``).  The candidates are
    ``devices`` when the caller gives them (a device may repeat: the
    workers then share it over gloo), else every visible card when
    ``--device`` is ``cuda`` (``cuda:K`` pins one card, ``cpu`` is one
    device).  ``--world_size`` caps their number; ``mesh_size_for_batch``
    takes the largest count that divides the batch, and a count of 1 is
    one process."""
    if multihost.group_up() or multihost.rendezvous_from(args) is not None:
        return None
    if devices:
        candidates = [torch.device(d) for d in devices]
    else:
        dev = torch.device(getattr(args, "device", "cuda"))
        if (dev.type != "cuda" or dev.index is not None
                or not torch.cuda.is_available()):
            return None
        candidates = [torch.device("cuda", k)
                      for k in range(torch.cuda.device_count())]
    cap = getattr(args, "world_size", None) or len(candidates)
    n = mesh_size_for_batch(batch_size, min(len(candidates), int(cap)))
    return candidates[:n] if n > 1 else None


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every worker has a card of its own, else gloo (NCCL
    refuses two ranks on one card; gloo stages CUDA tensors through the
    host)."""
    cards = [d for d in devices if d.type == "cuda"]
    distinct = len({d.index for d in cards}) == len(cards)
    return "nccl" if cards and len(cards) == len(devices) and distinct \
        else "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local(fn: Callable, devices: Sequence, fn_args: tuple = (),
                 timeout_s: float = multihost.DEFAULT_TIMEOUT_S) -> Any:
    """``fn(*fn_args, device)`` in one spawned worker per entry of
    ``devices``, worker k on ``devices[k]`` (made its current card) and
    rank k of a group of ``len(devices)`` (``backend_for``) in the local
    mode; returns worker 0's result.  ``timeout_s`` bounds every
    collective.  A worker that raises prints its traceback and exits 1;
    the others are then ended and ``torch.multiprocessing``'s
    ``ProcessExitedException`` is raised here, so no worker's failure is
    swallowed.  Without ``OMP_NUM_THREADS`` set, each worker's torch takes
    its share of the host's cores."""
    devices = [torch.device(d) for d in devices]
    url = f"tcp://127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory(prefix="hnd_local_mesh_") as tmp:
        result = os.path.join(tmp, "worker0.pkl")
        torch.multiprocessing.start_processes(
            _worker, args=(devices, url, backend_for(devices), timeout_s,
                           result, fn, tuple(fn_args)),
            nprocs=len(devices), join=True, start_method="spawn")
        with open(result, "rb") as f:
            return pickle.load(f)


def _worker(k: int, devices: List[torch.device], url: str, backend: str,
            timeout_s: float, result: str, fn: Callable,
            fn_args: tuple) -> None:
    try:
        if "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // len(devices)))
        device = devices[k]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        multihost.init_distributed_mode(url, len(devices), k, device,
                                        backend, timeout_s, local=True)
        out = fn(*fn_args, device)
        multihost.barrier()
        if k == 0:
            with open(result, "wb") as f:
                pickle.dump(out, f)
        multihost.destroy()
    except BaseException:
        # no teardown that could wait on a peer: exit now, and the
        # launcher ends the other workers
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
