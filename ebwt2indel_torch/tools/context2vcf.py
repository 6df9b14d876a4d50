"""context2vcf — place .snp call contexts on a reference genome by exact
matching and emit VCF rows. The port's copy of
``ebwt2indel_tpu/tools/context2vcf.py``.

The reference pipeline scores calls by aligning them with BWA and converting
the SAM (snp2vcf.sh → sam2vcf). This tool provides an aligner-free
alternative for the common case: each record's right context (an
error-corrected consensus) is located in the reference by exact substring
search; the variant is the final character of the left context, anchored
immediately before the right context's match position. SNP records yield one
VCF row; INDEL records yield an anchored indel row derived from the header's
event string (models/emit.py::event_type format).

Intended for validation loops (simulate -> call -> context2vcf ->
vcf_vs_vcf) and environments without bwa; for real data with repeats an
aligner remains the more sensitive choice.
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.dna import revcomp
from .sam2vcf import load_fasta


class _KmerIndex:
    """First-occurrence substring finder over the contigs, replacing the
    per-record ``str.find`` scan (O(records x genome) — minutes at the
    40 Mb validation scale) with one sorted k-mer table + binary search
    per query. Semantics match the linear scan exactly: the hit returned
    is the first (contig-order, then position) occurrence; queries
    shorter than k fall back to the linear scan."""

    K = 24

    def __init__(self, genomes: list[tuple[str, str]]):
        self.genomes = genomes
        k = self.K
        tbl = np.full(256, 255, np.uint8)
        for i, b in enumerate(b"ACGT"):
            tbl[b] = i
        keys, cis, poss = [], [], []
        for ci, (_, g) in enumerate(genomes):
            c = tbl[np.frombuffer(g.encode("ascii"), np.uint8)]
            m = len(c) - k + 1
            if m <= 0:
                continue
            key = np.zeros(m, np.uint64)
            bad = np.zeros(m, bool)
            for j in range(k):
                cj = c[j: j + m]
                bad |= cj > 3
                key = (key << np.uint64(2)) | (cj & 3).astype(np.uint64)
            ok = ~bad
            keys.append(key[ok])
            poss.append(np.flatnonzero(ok).astype(np.int64))
            cis.append(np.full(int(ok.sum()), ci, np.int32))
        if keys:
            key = np.concatenate(keys)
            pos = np.concatenate(poss)
            ci = np.concatenate(cis)
            order = np.lexsort((pos, ci, key))
            self._key = key[order]
            self._pos = pos[order]
            self._ci = ci[order]
        else:
            self._key = np.zeros(0, np.uint64)
            self._pos = np.zeros(0, np.int64)
            self._ci = np.zeros(0, np.int32)

    def find(self, s: str):
        """First (contig, position) whose substring equals s, or None."""
        k = self.K
        if len(s) < k:
            for ci, (_, g) in enumerate(self.genomes):
                p = g.find(s)
                if p >= 0:
                    return ci, p
            return None
        q = np.uint64(0)
        tbl = {"A": 0, "C": 1, "G": 2, "T": 3}
        for ch in s[:k]:
            v = tbl.get(ch)
            if v is None:
                return None  # index holds only ACGT k-mers
            q = (q << np.uint64(2)) | np.uint64(v)
        i = int(np.searchsorted(self._key, q, side="left"))
        while i < len(self._key) and self._key[i] == q:
            ci = int(self._ci[i])
            p = int(self._pos[i])
            g = self.genomes[ci][1]
            if g[p: p + len(s)] == s:
                return ci, p
            i += 1
        return None


def _parse_header(header: str):
    """'>cluster:..._type:_SNP_event:A/C' -> (kind, event)."""
    t = header.split("_type:_", 1)
    if len(t) < 2:
        return None, None
    rest = t[1]
    kind, _, ev = rest.partition("_event:")
    return kind, ev


def _right_len(header: str) -> int:
    for tok in header.split("_"):
        if tok.startswith("right:"):
            try:
                return int(tok.split(":")[1])
            except ValueError:
                return 0
    return 0


def convert(snp_path: str, ref_path: str, out_path: str, log=print) -> dict:
    ref, contigs = load_fasta(ref_path)
    genomes = [(c, ref[c]) for c in contigs]
    index = _KmerIndex(genomes)

    placed = 0
    dropped = 0
    rows: list[tuple[str, int, str, str, str]] = []

    def place(dna: str, rlen: int, kind: str, ev: str) -> bool:
        nonlocal placed
        if rlen <= 0 or rlen >= len(dna):
            return False
        right = dna[-rlen:]
        left = dna[:-rlen]
        hit = index.find(right)
        if hit is not None:
            ci, p = hit
            chrom, g = genomes[ci]
            if kind == "SNP":
                if p == 0 or not left:
                    return False
                refb = g[p - 1]
                altb = left[-1]
                if refb == altb:
                    return False
                rows.append((chrom, p, refb, altb, "SNP"))  # 1-based = p
                placed += 1
                return True
            if kind == "INDEL" and "/" in ev:
                ins0, _, ins1 = ev.partition("/")
                ins = ins0 or ins1
                if not ins:
                    return False
                ln = len(ins)
                if p - ln >= 1 and g[p - ln: p] == ins:
                    # genome carries the sequence -> deletion in the sample:
                    # anchor at g[p-ln-1]; REF = anchor+ins, ALT = anchor
                    a = g[p - ln - 1]
                    rows.append((chrom, p - ln, a + ins, a, "INDEL"))
                elif p >= 1:
                    # insertion in the sample between g[p-1] and g[p]
                    a = g[p - 1]
                    rows.append((chrom, p, a, a + ins, "INDEL"))
                else:
                    return False
                placed += 1
                return True
            return False
        return False

    def place_rc(dna: str, rlen: int, kind: str, ev: str) -> bool:
        """Reverse-complement placement: RC(dna) = RC(R) + RC(L), so the
        genome-anchored context precedes the variant."""
        nonlocal placed
        if rlen <= 0 or rlen >= len(dna):
            return False
        rcd = revcomp(dna)
        ctx = rcd[:rlen]  # RC of the right context
        hit = index.find(ctx)
        if hit is not None:
            ci, q = hit
            chrom, g = genomes[ci]
            vpos = q + rlen  # 0-based genome position of the variant base
            if kind == "SNP":
                if vpos >= len(g):
                    return False
                refb = g[vpos]
                altb = rcd[rlen]
                if refb == altb:
                    return False
                rows.append((chrom, vpos + 1, refb, altb, "SNP"))
                placed += 1
                return True
            if kind == "INDEL" and "/" in ev:
                ins0, _, ins1 = ev.partition("/")
                ins = revcomp(ins0 or ins1)
                if not ins or vpos < 1:
                    return False
                ln = len(ins)
                a = g[vpos - 1]
                if g[vpos: vpos + ln] == ins:
                    rows.append((chrom, vpos, a + ins, a, "INDEL"))
                else:
                    rows.append((chrom, vpos, a, a + ins, "INDEL"))
                placed += 1
                return True
            return False
        return False

    with open(snp_path) as f:
        header = None
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                header = line
            elif header is not None:
                kind, ev = _parse_header(header)
                rlen = _right_len(header)
                ok = False
                if kind:
                    ok = place(line, rlen, kind, ev) or \
                        place_rc(line, rlen, kind, ev)
                if not ok:
                    dropped += 1
                header = None

    # dedupe identical rows (pairs of records describe the same event twice)
    uniq = sorted(set(rows), key=lambda r: (r[0], r[1], r[2], r[3]))
    with open(out_path, "w") as out:
        out.write("##fileformat=VCFv4.1\n")
        for c in contigs:
            out.write(f"##contig=<ID={c}>\n")
        out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  "SAMPLE\n")
        for chrom, pos, refb, altb, vt in uniq:
            out.write(f"{chrom}\t{pos}\t.\t{refb}\t{altb}\t100\tPASS\t"
                      f"VT={vt}\tGT\t1|1\n")
    log(f"placed {placed} records ({len(uniq)} unique variants), "
        f"dropped {dropped}")
    return {"placed": placed, "unique": len(uniq), "dropped": dropped}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 3:
        print("usage: python -m ebwt2indel_torch.tools.context2vcf calls.snp "
              "ref.fasta out.vcf")
        return 1
    convert(argv[0], argv[1], argv[2])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
