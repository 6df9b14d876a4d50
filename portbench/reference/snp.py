"""The reference tool's event classification and .snp (KisSNP2-style)
record writer, scalar, one cluster at a time: a frozen copy of
``ebwt2indel_torch/models/emit.py`` at commit 53c2062 (itself a
transcription of ebwt2InDel.cpp:144-240 and 1098-1330), kept here so that
later changes to the program do not move the yardstick. Only this
docstring differs from the original.

Quirks of the reference kept: has_run (ebwt2InDel.cpp:144-152),
dH/distance (157-240), event_type (1098-1144), to_file pair (1146-1252),
to_file single (1254-1330).
"""

from __future__ import annotations

import dataclasses


def has_run(s: str, k: int) -> bool:
    """True iff s starts with a run of >= k equal characters; k > len(s) is
    never a run (ebwt2InDel.cpp:144-152)."""
    if k > len(s):
        return False
    for i in range(1, k):
        if s[i] != s[i - 1]:
            return False
    return True


def dH(a: str, b: str) -> int:
    """Right-aligned Hamming distance (ebwt2InDel.cpp:157-171)."""
    ln = min(len(a), len(b))
    return sum(
        1 for i in range(ln) if a[len(a) - i - 1] != b[len(b) - i - 1]
    )


def distance(a: str, b: str, max_gap: int) -> tuple[int, int]:
    """Best right-end indel alignment (ebwt2InDel.cpp:192-240).

    Returns (mismatches-before-indel, signed indel length); positive length =
    insertion in ``a``, negative = insertion in ``b``. The no-indel alignment
    wins only if *strictly* smaller than both indel minima (cpp:223-227); on
    a/b tie the insertion goes to ``b`` (cpp:228-238). min_element takes the
    first minimum on ties, i.e. the shortest gap.
    """
    dist_no_indel = dH(a, b)
    if max_gap == 0:
        return dist_no_indel, 0
    dist_ab = [dH(a[: len(a) - i], b) + i for i in range(1, max_gap + 1)]
    dist_ba = [dH(a, b[: len(b) - i]) + i for i in range(1, max_gap + 1)]
    min_ab = min(range(max_gap), key=lambda i: (dist_ab[i], i))
    min_ba = min(range(max_gap), key=lambda i: (dist_ba[i], i))
    if dist_no_indel < dist_ab[min_ab] and dist_no_indel < dist_ba[min_ba]:
        return dist_no_indel, 0
    if dist_ab[min_ab] < dist_ba[min_ba]:
        return dist_ab[min_ab] - (min_ab + 1), min_ab + 1
    return dist_ba[min_ba] - (min_ba + 1), -(min_ba + 1)


def event_type(left0: str, left1: str, max_gap: int,
               d: tuple[int, int] | None = None) -> str:
    """"type:_SNP_event:X/Y" or "type:_INDEL_event:SEQ/" (cpp:1098-1144)."""
    if d is None:
        d = distance(left0, left1, max_gap)
    out = "type:" + ("_INDEL_event:" if d[1] != 0 else "_SNP_event:")
    if d[1] == 0:
        out += left0[-1] + "/" + left1[-1]
    elif d[1] > 0:
        out += left0[len(left0) - d[1]:] + "/"
    else:
        out += "/" + left1[len(left1) + d[1]:]
    return out


@dataclasses.dataclass
class VariantSingle:
    """variant_single_t (ebwt2InDel.cpp:130-141)."""

    left_context: str
    right_context: str
    support: int


@dataclasses.dataclass
class VariantPair:
    """variant_t (ebwt2InDel.cpp:115-128)."""

    left_context_0: str
    left_context_1: str
    right_context: str
    support_0: int
    support_1: int


class SnpWriter:
    """Stateful .snp writer holding the global cluster_nr / events counters
    (reference globals at ebwt2InDel.cpp:52, 70-72)."""

    def __init__(self, out_file, *, complexity: int, max_snvs: int,
                 mcov_out: int, max_gap: int):
        self.out = out_file
        self.complexity = complexity
        self.max_snvs = max_snvs
        self.mcov_out = mcov_out
        self.max_gap = max_gap
        self.cluster_nr = 1
        self.events = 0

    def _header(self, id_nr: int, right_len: int, cov: int, typ: str) -> str:
        return (
            f">cluster:{self.cluster_nr}_id:{id_nr}_right:{right_len}"
            f"_cov:{cov}_{typ}"
        )

    def write_pair_cluster(self, variants: list[VariantPair]) -> None:
        """to_file for two-sample variants (ebwt2InDel.cpp:1146-1252):
        one record per read per accepted pair; cluster_nr advances only if at
        least one pair was written."""
        found = False
        id_nr = 1
        for v in variants:
            d = distance(v.left_context_0, v.left_context_1, self.max_gap)
            if (
                not has_run(v.right_context, self.complexity)
                and d[0] <= self.max_snvs
                and v.support_0 >= self.mcov_out
                and v.support_1 >= self.mcov_out
            ):
                found = True
                typ = event_type(v.left_context_0, v.left_context_1,
                                 self.max_gap, d)
                # first individual: on insertion-in-1 (d[1] < 0) the longer
                # left context 0 is trimmed on the left (cpp:1187-1201)
                dna0 = (
                    v.left_context_0 if d[1] >= 0
                    else v.left_context_0[-d[1]:]
                )
                self.out.write(
                    self._header(id_nr, len(v.right_context), v.support_0, typ)
                    + "\n" + dna0 + v.right_context + "\n"
                )
                # second individual (cpp:1225-1239)
                dna1 = (
                    v.left_context_1 if d[1] <= 0
                    else v.left_context_1[d[1]:]
                )
                self.out.write(
                    self._header(id_nr, len(v.right_context), v.support_1, typ)
                    + "\n" + dna1 + v.right_context + "\n"
                )
                id_nr += 1
        self.cluster_nr += 1 if found else 0

    def write_single_cluster(self, variants: list[VariantSingle]) -> None:
        """to_file for genotyping mode (ebwt2InDel.cpp:1254-1330).

        Quirks preserved: early return (no cluster_nr advance) when fewer than
        2 variants; max_dist over *consecutive* pairs; the event type of every
        record is computed against good_variants[1]'s left context
        (cpp:1299-1307); cluster_nr advances unconditionally otherwise.
        """
        if len(variants) < 2:
            return
        max_dist = 0
        good: list[VariantSingle] = []
        for i in range(len(variants) - 1):
            d = distance(variants[i].left_context,
                         variants[i + 1].left_context, self.max_gap)
            max_dist = max(max_dist, d[0])
            if variants[i].support >= self.mcov_out:
                good.append(variants[i])
        if variants[-1].support >= self.mcov_out:
            good.append(variants[-1])

        if max_dist <= self.max_snvs and len(good) >= 2:
            id_nr = 1
            for i, v in enumerate(good):
                if not has_run(v.right_context, self.complexity):
                    if i == 0:
                        typ = event_type(v.left_context,
                                         good[1].left_context, self.max_gap)
                    else:
                        typ = event_type(good[i - 1].left_context,
                                         good[1].left_context, self.max_gap)
                    self.out.write(
                        self._header(id_nr, len(v.right_context),
                                     v.support, typ)
                        + "\n" + v.left_context + v.right_context + "\n"
                    )
                    id_nr += 1
                    self.events += 1
        self.cluster_nr += 1
