"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Without a
usable CUDA device it raises; the CPU runs only when the caller asks for it
(the tests do). There is no environment switch and no silent fallback.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ebwt2indel_torch: a CUDA device was requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"ebwt2indel_torch: unsupported device {device!r} "
                     "(use 'cuda' or 'cpu')")


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host clock read after it times the work, not its enqueue."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
