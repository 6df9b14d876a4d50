"""FM-index over the packed rank blocks: batched F / FL / LF-range / node
extension (counterpart of ``ebwt2indel_tpu/models/fm_index.py``; reference
internal/dna_bwt.hpp:24-420).

Suffix-tree node representation (include.hpp:394-413): an int64 tensor
[..., 7] holding (first_TERM, first_A, first_C, first_G, first_T, last,
depth). A leaf is an int64 tensor [..., 3]: (first, second, depth)
(include.hpp:513-527). Every rank query goes through ``ops.rank``, so on the
card each one is a launch of the CUDA rank kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from ..ops import packing, rank


@dataclasses.dataclass(frozen=True)
class FMIndex:
    """Device mirror of ops.packing.PackedBwt.

    F holds the 4 cumulative boundaries (F_A, F_C, F_G, F_T) with TERM
    lexicographically smallest (dna_bwt.hpp:47-61): F_A = #TERM,
    F_C = F_A + #A, F_G = F_C + #C, F_T = F_G + #G.
    """

    blocks: torch.Tensor  # (n_blocks, 16) int32 holding uint32 bit patterns
    block_counts: torch.Tensor  # (n_blocks, 4) int64
    F: torch.Tensor  # (4,) int64
    n: int
    term: int
    device: torch.device

    @staticmethod
    def from_numpy(blocks, block_counts, F, n: int, term: int,
                   device="cuda") -> "FMIndex":
        """Upload index arrays given as numpy: a PackedBwt's, or a JAX
        FMIndex's (``np.asarray(fm.blocks)``, ...), so both packages can
        run on the identical index."""
        dev = device_mod.resolve(device)
        blocks = np.asarray(blocks)
        if blocks.dtype not in (np.uint32, np.int32) or blocks.ndim != 2 \
                or blocks.shape[1] != 16:
            raise ValueError("blocks must be (n_blocks, 16) 32-bit words")
        # torch.tensor copies: the arrays may be read-only views (JAX's)
        return FMIndex(
            blocks=torch.tensor(blocks.view(np.int32), device=dev),
            # 32-bit counters are uint32 patterns: widen them unsigned
            block_counts=torch.tensor(packing.widen_u32(block_counts),
                                      device=dev),
            F=torch.tensor(np.asarray(F), dtype=torch.int64, device=dev),
            n=int(n), term=int(term), device=dev,
        )

    @staticmethod
    def from_packed(pb: packing.PackedBwt, device="cuda") -> "FMIndex":
        """Upload the full 16-word blocks of a packed BWT."""
        return FMIndex.from_numpy(pb.blocks, pb.block_counts, pb.F, pb.n,
                                  pb.term, device)

    @staticmethod
    def from_file(path: str, term: int = ord("#"), device="cuda") -> "FMIndex":
        return FMIndex.from_packed(packing.pack_file(path, term), device)

    def root(self) -> torch.Tensor:
        """Root suffix-tree node (dna_bwt.hpp:296-308)."""
        z = torch.zeros(1, dtype=torch.int64, device=self.device)
        n = torch.full((1,), self.n, dtype=torch.int64, device=self.device)
        return torch.cat([z, self.F, n, z])

    def first_leaf(self) -> torch.Tensor:
        """Leaf of the empty string: the range of all terminator-first
        suffixes (dna_bwt.hpp:313-317)."""
        z = torch.zeros(1, dtype=torch.int64, device=self.device)
        return torch.cat([z, self.F[:1], z])


def parallel_rank(fm: FMIndex, i: torch.Tensor) -> torch.Tensor:
    return rank.parallel_rank(fm.blocks, i)


def f_char(fm: FMIndex, i: torch.Tensor) -> torch.Tensor:
    """Character code of the F column at position i (dna_bwt.hpp:100-110):
    TERM (4) below F_A, else A..T by boundary comparison."""
    r = (fm.F <= i[..., None]).sum(-1)
    return torch.where(r == 0, 4, r - 1)


def fl(fm: FMIndex, i: torch.Tensor) -> torch.Tensor:
    """FL (psi): F position -> L position of the same character occurrence
    (dna_bwt.hpp:115-133). Defined where F(i) != TERM; elsewhere the rank
    r is clamped to 0 so the select stays in bounds (callers discard it)."""
    cc = f_char(fm, i).clamp(0, 3)
    r = (i - fm.F[cc]).clamp_min(0)
    return rank.select(fm.blocks, fm.block_counts, r, cc)


def lf_range(fm: FMIndex, first: torch.Tensor, second: torch.Tensor):
    """Left-extend right-exclusive ranges by all 4 nucleotides at once
    (dna_bwt.hpp:138-166), both endpoints in one rank launch.
    Returns (lo [..., 4], hi [..., 4])."""
    r = parallel_rank(fm, torch.stack([first, second], dim=-1))
    return fm.F + r[..., 0, :], fm.F + r[..., 1, :]


def extend_coords(fm: FMIndex, coords: torch.Tensor) -> torch.Tensor:
    """The 6 boundaries of suffix-tree nodes extended by all 4 nucleotides
    (dna_bwt.hpp:323-356): one rank of the 6 boundaries per node, in
    node-major order. coords: int64 (C, 6) -> int64 (C, 4, 6)."""
    ranks = parallel_rank(fm, coords)  # (C, 6, 4)
    return fm.F[:, None] + ranks.transpose(1, 2)


def extend_node(fm: FMIndex, nodes: torch.Tensor) -> torch.Tensor:
    """Weiner-link extension of suffix-tree nodes by all 4 nucleotides.
    nodes: int64 (C, 7) -> int64 (C, 4, 7)."""
    depth = (nodes[:, 6] + 1)[:, None, None].expand(-1, 4, 1)
    return torch.cat([extend_coords(fm, nodes[:, :6]), depth], dim=-1)


def node_num_children(nodes: torch.Tensor) -> torch.Tensor:
    """Number of non-empty children of each node (include.hpp:760-768)."""
    c = nodes[..., :6]
    return (c[..., 1:] > c[..., :-1]).sum(-1)
