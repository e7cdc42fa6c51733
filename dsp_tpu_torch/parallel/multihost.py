"""Multi-process execution on ``torch.distributed`` (port of
``dsp_tpu/parallel/multihost.py``).

PyTorch's idiom is one process a GPU: every process runs the same program
(SPMD), ``torchrun`` starts them and sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, and :func:`initialize`
wires them into one process group (NCCL on the card, gloo on the CPU).
The ('data', 'bank') mesh of ``parallel/mesh.py`` then spans the group.

Failure policy is fail-fast, as in the JAX package: a lost process times
out the next collective and the job must be restarted.  One difference is
intended: where ``jax.distributed`` auto-detection fails although cluster
markers are set, the JAX package warns and goes on as one process; here a
failed init with ``WORLD_SIZE`` set raises, since one process of N would
silently compute on 1/N of the data.

Typical use::

    # torchrun --nproc-per-node=4 my_script.py
    from dsp_tpu_torch.parallel import multihost, make_mesh
    multihost.initialize()                  # no-op in a plain python process
    mesh = make_mesh()                      # every rank on 'bank'
    ...
    ok = multihost.all_hosts_agree(accuracy)
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from dsp_tpu_torch.utils.logging import get_logger

log = get_logger("dsp_tpu_torch.multihost")

_initialized = False        # idempotency: initialize() is call-once

# seconds a rank waits for the rendezvous and for each collective
INIT_TIMEOUT_S = 60.0


def backend_for(device) -> str:
    """The process-group backend of a mesh on ``device``: NCCL for the card,
    gloo for the CPU.  A CUDA mesh without a card raises: it never becomes
    a CPU mesh."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh needs a card and torch.cuda.is_available() is "
                "false (pass device='cpu' for a gloo mesh)")
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no mesh backend for device {dev}")


def local_rank() -> int:
    """This process's card on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current card under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device: str | torch.device = "cuda",
               timeout_s: float = INIT_TIMEOUT_S) -> None:
    """Join this process to the job's process group (no-op for one process).

    With no arguments the group comes from torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); without
    ``WORLD_SIZE`` the run is a plain single process and nothing happens.
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` name the group explicitly.  ``device`` picks the backend
    (:func:`backend_for`); under NCCL the process takes card
    ``LOCAL_RANK``.  Call-once; ``num_processes=1`` is a no-op.  A failed
    init raises ``RuntimeError``."""
    global _initialized
    if _initialized or dist.is_initialized():
        return
    if num_processes == 1:
        log.info("single-process run; distributed init skipped")
        return
    if coordinator_address is None and num_processes is None:
        if os.environ.get("WORLD_SIZE") is None:
            log.info("no torchrun environment (WORLD_SIZE unset); "
                     "single-process run")
            return
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ.get("RANK", "-1"))
    else:
        if coordinator_address is None or num_processes is None:
            raise ValueError("an explicit group needs coordinator_address "
                             "and num_processes")
        init_method = f"tcp://{coordinator_address}"
        world = int(num_processes)
        rank = int(os.environ.get("RANK", "-1")) if process_id is None \
            else int(process_id)
    backend = backend_for(device)
    try:
        if rank < 0:
            raise ValueError("RANK is not set")
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:
        raise RuntimeError(
            f"distributed init failed for rank {rank} of {world} "
            f"({backend}, {init_method}): {e}; going on as one process "
            f"would compute on 1/{world} of the data") from e
    _initialized = True
    log.info("distributed: process %d/%d, %s", dist.get_rank(),
             dist.get_world_size(), backend)


def is_primary() -> bool:
    """True on the process that should write checkpoints / print reports."""
    return not dist.is_initialized() or dist.get_rank() == 0


def all_hosts_agree(value: float, atol: float = 0.0) -> bool:
    """Cross-process consistency check for replicated scalars (e.g.
    accuracy).  Compares the global min against the global max: unlike a
    mean test this cannot be fooled by disagreements that average out."""
    lo, hi = _min_max_across_hosts(value)
    return bool(abs(hi - lo) <= atol + 1e-9 * abs(value))


def jnp_mean_across_hosts(value: float) -> float:
    """Mean of a per-process float32 scalar over every process (the JAX
    package's name, kept so that its counterpart is found)."""
    if not dist.is_initialized():
        return float(np.float32(value))
    t = torch.tensor([value], dtype=torch.float32, device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return float((t / dist.get_world_size()).item())


def _min_max_across_hosts(value: float):
    """Exact float32 (min, max) of a per-process scalar: one MIN reduction
    over (value, -value), negation being exact."""
    if not dist.is_initialized():
        v = float(np.float32(value))
        return v, v
    t = torch.tensor([value, -value], dtype=torch.float32,
                     device=collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    lo, neg_hi = t.tolist()
    return lo, -neg_hi
