"""Multi-process wiring of the mesh (counterpart of
``ebwt2indel_tpu/parallel/launch.py``).

Environment contract, set on every process:

    EBWT_COORD   the address of process 0, e.g. "10.0.0.1:8476", or "auto"
                 to take torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and
                 RANK (``init_method="env://"``)
    EBWT_NPROCS  the number of processes
    EBWT_PROCID  this process's index in [0, EBWT_NPROCS)

Processes join one ``torch.distributed`` group: ``nccl`` when they run on
CUDA (one card per process, ``cuda:<procid % cards>``), ``gloo`` on the
CPU. Every process computes the same calls and emission; only process 0
writes the output file, the others write ``<output>.proc<k>``.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from .. import device as device_mod


def distributed_requested() -> bool:
    return bool(os.environ.get("EBWT_COORD"))


def init_from_env(device="cuda") -> torch.device:
    """Join the process group that the EBWT_* variables describe; returns
    the device this process runs its shards on. Without EBWT_COORD it joins
    nothing and returns ``device`` resolved."""
    dev = device_mod.resolve(device)
    coord = os.environ.get("EBWT_COORD")
    if not coord:
        return dev
    if coord == "auto":
        init, world, rank = "env://", None, None
        procid = int(os.environ["RANK"])
    else:
        world = int(os.environ["EBWT_NPROCS"])
        rank = procid = int(os.environ["EBWT_PROCID"])
        init = f"tcp://{coord}"
    if dev.type == "cuda":
        dev = torch.device("cuda", procid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {} if world is None else {"world_size": world, "rank": rank}
    dist.init_process_group(backend, init_method=init, **kw)
    return dev


def shutdown() -> None:
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def redirect_output(cfg):
    """The config a non-primary process writes to: ``<output>.proc<k>``, so
    that processes do not race on the output file."""
    if is_primary():
        return cfg
    return dataclasses.replace(cfg,
                               output=f"{cfg.output}.proc{process_index()}")
