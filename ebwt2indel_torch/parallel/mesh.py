"""The position mesh: S shards held by R processes (counterpart of
``ebwt2indel_tpu/parallel/shard.py::make_mesh`` and of the collectives that
``jax.shard_map`` gives the JAX package).

Each process holds S / R consecutive shards, on one device or on several of
its own devices (``["cuda:0"] * 4`` runs four shards on one card). A value
that lives on every shard is a ``dict`` from the global shard index to that
shard's tensor, over this process's shards only.

Every collective has two parts: tensor operations over this process's
shards, and, when ``torch.distributed`` is initialised with more than one
process, one ``torch.distributed`` call across processes (``nccl`` for CUDA
tensors, ``gloo`` for CPU ones; ``parallel/launch.py`` chooses). With one
process no process group exists and nothing crosses a process. Every process
must call the same collectives in the same order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod


class Mesh:
    """``size`` shards. Shard s belongs to process ``s // (size / R)``.
    ``devices`` gives one device per local shard (default: every local shard
    on ``device``)."""

    def __init__(self, size: int, device="cuda", devices=None):
        if size < 1:
            raise ValueError(f"a mesh needs at least one shard, got {size}")
        distributed = dist.is_available() and dist.is_initialized()
        self.nprocs = dist.get_world_size() if distributed else 1
        self.proc = dist.get_rank() if distributed else 0
        if size % self.nprocs:
            raise ValueError(f"{size} shards do not split evenly over "
                             f"{self.nprocs} processes")
        self.size = size
        per = size // self.nprocs
        self.local = list(range(self.proc * per, (self.proc + 1) * per))
        if devices is None:
            devices = [device] * per
        if len(devices) != per:
            raise ValueError(f"{len(devices)} devices for {per} local shards")
        self.devices = {s: device_mod.resolve(d)
                        for s, d in zip(self.local, devices)}
        # replicated values (psum results, gathered lists) live here
        self.device = self.devices[self.local[0]]
        # bytes of the rows that this process's all_to_all calls sent to
        # another shard (a diagnostic of the routing's traffic)
        self.routed_bytes = 0

    def owner(self, s: int) -> int:
        return s // (self.size // self.nprocs)

    def synchronize(self) -> None:
        for d in set(self.devices.values()):
            device_mod.synchronize(d)

    def psum(self, parts: dict) -> torch.Tensor:
        """The sum over all shards of same-shaped tensors, on
        ``self.device``."""
        total = None
        for s in self.local:
            x = parts[s].to(self.device)
            total = x.clone() if total is None else total + x
        if self.nprocs > 1:
            dist.all_reduce(total)
        return total

    def psum_int(self, value: int) -> int:
        """The sum over processes of a host integer (this process's part
        already summed over its shards)."""
        if self.nprocs == 1:
            return int(value)
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(t)
        return int(t.item())

    def all_gather(self, parts: dict) -> list[torch.Tensor]:
        """Every shard's tensor, in shard order, on ``self.device``. The
        first dimension may differ between shards; the rest may not."""
        mine = [parts[s].to(self.device) for s in self.local]
        if self.nprocs == 1:
            return mine
        sizes = self.allgather_host(
            np.array([[x.shape[0]] for x in mine], np.int64))[:, 0]
        per = len(self.local)
        flat = torch.cat(mine)
        longest = int(max(sizes.reshape(self.nprocs, per).sum(1)))
        pad = flat.new_zeros((longest - flat.shape[0],) + flat.shape[1:])
        bufs = [torch.empty_like(torch.cat([flat, pad]))
                for _ in range(self.nprocs)]
        dist.all_gather(bufs, torch.cat([flat, pad]))
        out = []
        for p in range(self.nprocs):
            lo = 0
            for k in sizes[p * per:(p + 1) * per]:
                out.append(bufs[p][lo:lo + k])
                lo += int(k)
        return out

    def shift(self, parts: dict, step: int) -> dict:
        """Shard s receives the tensor of shard s - step on its own device
        (step 1: from its left neighbour, -1: from its right), or None where
        that shard does not exist: the neighbour exchange that ``ppermute``
        gives the JAX package."""
        got = self.all_gather(parts)
        return {s: got[s - step].to(self.devices[s])
                if 0 <= s - step < self.size else None for s in self.local}

    def all_to_all(self, rows: dict, dest: dict) -> dict:
        """Route rows to shards: ``rows[s]`` (m, w) int64 goes row by row to
        the shards ``dest[s]`` (m,). Returns each local shard's received
        rows, in the order of their source shards. The counts are exchanged
        first, then the rows."""
        S = self.size
        pieces, counts = {}, {}
        for s in self.local:
            order = torch.argsort(dest[s], stable=True)
            cnt = torch.bincount(dest[s], minlength=S).tolist()
            pieces[s] = list(torch.split(rows[s][order], cnt))
            counts[s] = cnt
            self.routed_bytes += (rows[s].shape[0] - cnt[s]) * \
                rows[s].shape[1] * rows[s].element_size()
        if self.nprocs == 1:
            return {d: torch.cat([pieces[s][d].to(self.devices[d])
                                  for s in self.local]) for d in self.local}
        table = self.allgather_host(
            np.array([counts[s] for s in self.local], np.int64))  # (S, S)
        per = len(self.local)
        w = rows[self.local[0]].shape[1]
        send = []
        for p in range(self.nprocs):
            for s in self.local:
                send += pieces[s][p * per:(p + 1) * per]
        send = torch.cat(send).to(self.device).reshape(-1)
        mine = slice(self.local[0], self.local[-1] + 1)
        in_split = [int(table[self.local, p * per:(p + 1) * per].sum()) * w
                    for p in range(self.nprocs)]
        out_split = [int(table[p * per:(p + 1) * per, mine].sum()) * w
                     for p in range(self.nprocs)]
        recv = send.new_empty(sum(out_split))
        dist.all_to_all_single(recv, send, out_split, in_split)
        recv = recv.reshape(-1, w)
        got = {d: [] for d in self.local}
        lo = 0
        for s in range(S):  # the buffer holds (source, local dest) pieces
            for d in self.local:
                k = int(table[s, d])
                got[d].append(recv[lo:lo + k])
                lo += k
        return {d: torch.cat(got[d]).to(self.devices[d]) for d in self.local}

    def allgather_host(self, local: np.ndarray) -> np.ndarray:
        """Stack the (per-local-shard, ...) int64 host arrays of every
        process into one (S, ...) array on every process (the loader's
        (S, 5) totals table)."""
        if self.nprocs == 1:
            return np.asarray(local, np.int64)
        t = torch.as_tensor(np.asarray(local, np.int64), device=self.device)
        bufs = [torch.empty_like(t) for _ in range(self.nprocs)]
        dist.all_gather(bufs, t)
        return torch.cat(bufs).cpu().numpy()
