"""DNA alphabet constants and host-side helpers.

Character coding matches the reference semantics (reference: internal/dna_string.hpp:335-366):
A=0, C=1, G=2, T=3, TERM=4. The terminator character is configurable (default '#',
reference: ebwt2InDel.cpp:50).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, TERM_CODE = 0, 1, 2, 3, 4
BASES = b"ACGT"
DEFAULT_TERM = ord("#")

# base_to_int maps anything unknown (incl. the terminator) to 0 == 'A'
# (reference: internal/include.hpp:275-289 — the switch default returns 0).
# 'N' maps to a *random* base in the reference (include.hpp:283); the BWT input
# alphabet excludes N so this path is only relevant for tool inputs.


def code_table(term: int = DEFAULT_TERM) -> np.ndarray:
    """ASCII -> code lookup table; 255 marks forbidden characters
    (reference: internal/dna_string.hpp:90-96 validates the same alphabet)."""
    tbl = np.full(256, 255, dtype=np.uint8)
    tbl[ord("A")] = A
    tbl[ord("C")] = C
    tbl[ord("G")] = G
    tbl[ord("T")] = T
    tbl[term] = TERM_CODE
    return tbl


def decode_table(term: int = DEFAULT_TERM) -> np.ndarray:
    """code -> ASCII lookup table."""
    tbl = np.zeros(8, dtype=np.uint8)
    tbl[A] = ord("A")
    tbl[C] = ord("C")
    tbl[G] = ord("G")
    tbl[T] = ord("T")
    tbl[TERM_CODE] = term
    return tbl


def codes_to_str(codes: np.ndarray, term: int = DEFAULT_TERM) -> str:
    return decode_table(term)[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def str_to_codes(s: str | bytes, term: int = DEFAULT_TERM) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("ascii")
    raw = np.frombuffer(s, dtype=np.uint8)
    out = code_table(term)[raw]
    if (out == 255).any():
        bad = raw[out == 255][0]
        raise ValueError(
            f"read forbidden character '{chr(bad)}' (ASCII code {bad}). "
            f"Only A,C,G,T, and {chr(term)} are admitted in the input BWT!"
        )
    return out


def revcomp(s: str) -> str:
    """Reverse complement; non-ACGT characters map to 'N'
    (reference: internal/include.hpp:291-317)."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A",
            "a": "T", "c": "G", "g": "C", "t": "A"}
    return "".join(comp.get(ch, "N") for ch in reversed(s))
