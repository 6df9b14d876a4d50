"""Typed configuration with the reference CLI's exact defaults and
zero-means-default resolution (reference: ebwt2InDel.cpp:20-74, 1740-1746)."""

from __future__ import annotations

import dataclasses

K_LEFT_DEF = 31
K_RIGHT_DEF = 30
MAX_SNVS_DEF = 2
MCOV_OUT_DEF = 3
MAX_GAP_DEF = 10
K_DEF = 16
COMPLEXITY_DEF = max(K_RIGHT_DEF - 10, 0)  # cpp:64


@dataclasses.dataclass
class Config:
    input1: str = ""
    input2: str = ""  # -2: second eBWT (mode 2)
    input_da: str = ""  # -d: document array (mode 3)
    output: str = ""
    k_left: int = 0  # -L (0 -> 31)
    k_right: int = 0  # -R (0 -> 30)
    K: int = 0  # -k (0 -> 16)
    max_gap: int = 0  # -g (0 -> 10; note: the reference resolves 0 to the
    # default, so "indels disabled" requires passing 0 explicitly... in fact
    # the reference's own resolution max_gap = max_gap==0 ? 10 : max_gap makes
    # -g 0 impossible to request; we reproduce that behavior exactly
    # (cpp:1742)
    max_snvs: int = 0  # -v (0 -> 2)
    mcov_out: int = 0  # -m (0 -> 3)
    complexity: int = 0  # -c (0 -> 20)
    max_variants_per_position: int = 0  # -q (0 = unlimited)
    term: int = ord("#")  # -t

    def resolved(self) -> "Config":
        c = dataclasses.replace(self)
        c.complexity = c.complexity or COMPLEXITY_DEF
        c.K = c.K or K_DEF
        c.max_gap = c.max_gap or MAX_GAP_DEF
        c.k_left = c.k_left or K_LEFT_DEF
        c.k_right = c.k_right or K_RIGHT_DEF
        c.max_snvs = c.max_snvs or MAX_SNVS_DEF
        c.mcov_out = c.mcov_out or MCOV_OUT_DEF
        return c
