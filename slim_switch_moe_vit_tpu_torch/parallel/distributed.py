"""Multi-process runtime init and the rank helpers.

Port of ``slim_switch_moe_vit_tpu/parallel/distributed.py`` (:1-99), which
follows the reference's ``utils.py:224-296``: the rank and world size come
from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) or
SLURM's (``SLURM_PROCID``, ``SLURM_NTASKS``), the rendezvous from
``--dist_url`` (``env://`` reads ``MASTER_ADDR`` / ``MASTER_PORT``;
``tcp://host:port`` and ``file:///path`` work too), and
``torch.distributed.init_process_group`` joins the group.

The backend is ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``.
``SSMV_DIST_BACKEND=gloo`` takes gloo on ``cuda`` too, so that several
ranks can share one card (NCCL refuses two ranks on one device): the
collectives then move CUDA tensors through gloo, which takes them for every
collective the port uses. NCCL with more ranks on a host than it has cards
raises, naming that knob.

Where the JAX function prints "continuing single-host" when the init fails
(:52-57), this one raises: a run that silently falls back to one process
would train another model on another device than was asked for.
"""
from __future__ import annotations

import builtins
import os

import torch
import torch.distributed as dist

BACKEND_ENV = "SSMV_DIST_BACKEND"


def dist_backend(device: str = "cuda") -> str:
    """``nccl`` on ``cuda``, ``gloo`` on ``cpu``; ``SSMV_DIST_BACKEND``
    (read at call time) overrides on ``cuda``."""
    if torch.device(device).type == "cpu":
        return "gloo"
    backend = os.environ.get(BACKEND_ENV, "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"{BACKEND_ENV}={backend!r}: use 'nccl' or 'gloo'")
    return backend


def _ranks_from_env(env):
    """(rank, world size, local rank, ranks on this host) or None."""
    if "RANK" in env and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
        return (int(env["RANK"]), world, int(env.get("LOCAL_RANK", env["RANK"])),
                int(env.get("LOCAL_WORLD_SIZE", world)))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        world = int(env["SLURM_NTASKS"])
        rank = int(env["SLURM_PROCID"])
        return (rank, world, int(env.get("SLURM_LOCALID", rank)),
                int(env.get("SLURM_NTASKS_PER_NODE", world)))
    return None


def init_distributed_mode(args) -> bool:
    """Join the process group the environment describes; returns True when
    running distributed. Sets ``args.distributed``, ``args.rank``,
    ``args.world_size`` and ``args.gpu`` (the local rank), binds the card
    ``LOCAL_RANK % device_count`` on ``cuda``, and silences ``print`` on
    every rank but 0. Raises when the group cannot be formed."""
    found = _ranks_from_env(os.environ)
    if found is None:
        args.distributed = False
        print("Not using distributed mode")
        return False
    rank, world, local_rank, local_world = found
    device = getattr(args, "device", "cuda")
    backend = dist_backend(device)
    if torch.device(device).type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("distributed run on cuda, but no CUDA device "
                               "is visible")
        if backend == "nccl" and local_world > n_cards:
            raise RuntimeError(
                f"NCCL with {local_world} ranks on a host with {n_cards} "
                f"CUDA device(s): NCCL takes one rank per device. Set "
                f"{BACKEND_ENV}=gloo to let several ranks share a card")
        torch.cuda.set_device(local_rank % n_cards)
    print(f"| distributed init (rank {rank} of {world}, {backend}): "
          f"{args.dist_url}", flush=True)
    dist.init_process_group(backend, init_method=args.dist_url,
                            world_size=world, rank=rank)
    args.distributed = True
    args.rank, args.world_size, args.gpu = rank, world, local_rank
    setup_for_distributed(rank == 0)
    return True


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def save_on_master(save_fn, *args, **kwargs):
    """Call a save function on rank 0 only (reference utils.py:264-266)."""
    if is_main_process():
        return save_fn(*args, **kwargs)


def setup_for_distributed(is_master: bool) -> None:
    """Print on the master only, unless ``force=True`` is passed (reference
    utils.py:224-237)."""
    builtin_print = builtins.print

    def print_(*args, **kwargs):
        force = kwargs.pop("force", False)
        if is_master or force:
            builtin_print(*args, **kwargs)

    builtins.print = print_
