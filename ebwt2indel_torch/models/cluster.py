"""Positional clustering over the LCP flag vectors (counterpart of
``ebwt2indel_tpu/models/cluster.py``; reference run_one_dataset,
ebwt2InDel.cpp:1609-1655).

The reference opens a cluster while ``LCP_threshold[2i] and not
LCP_minima[i]`` holds and closes it where that fails. Quirks kept:

* a run still open at the last position i = n-1 is never closed, hence never
  analyzed nor histogrammed;
* the histogram records closed clusters of any length
  (CLUST_SIZES[len] += len for len <= 200), while only clusters with
  len >= 2*mcov_out are analyzed, in position order.

``find_clusters_device`` reads the dense route's (n,) uint8 flags and
``find_clusters_device_packed`` the bit-packed route's words.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import bits
from . import traverse

MAX_CLUST_LEN = 200  # histogram cap (ebwt2InDel.cpp:1388)
_LOW32 = 0xFFFFFFFF


@dataclasses.dataclass
class Clusters:
    begins: np.ndarray | torch.Tensor  # (B,) cluster start (inclusive)
    ends: np.ndarray | torch.Tensor  # (B,) cluster end (exclusive)
    n_clusters: int  # number of analyzed clusters (len >= 2*mcov_out)
    clust_size_sum: int  # total length over all closed clusters
    n_closed: int  # number of closed clusters
    hist: np.ndarray  # (201,) int64 — CLUST_SIZES


def cluster_mask(thr_K: np.ndarray, minima: np.ndarray) -> np.ndarray:
    return (thr_K != 0) & (minima == 0)


def find_clusters(thr_K: np.ndarray, minima: np.ndarray,
                  mcov_out: int) -> Clusters:
    return find_clusters_from_mask(cluster_mask(thr_K, minima), mcov_out)


def find_clusters_from_mask(mask: np.ndarray, mcov_out: int) -> Clusters:
    """Host (numpy) cluster detection."""
    n = mask.shape[0]
    if n == 0:
        return Clusters(
            begins=np.zeros(0, np.int64), ends=np.zeros(0, np.int64),
            n_clusters=0, clust_size_sum=0, n_closed=0,
            hist=np.zeros(MAX_CLUST_LEN + 1, np.int64),
        )
    m = mask.astype(bool)
    edges = np.flatnonzero(m[1:] != m[:-1]) + 1
    if m[0]:
        starts = np.concatenate([[0], edges[1::2]])
        stops = edges[0::2]
    else:
        starts = edges[0::2]
        stops = edges[1::2]
    # a run reaching the end is never closed by the reference scan — drop it
    starts = starts[: len(stops)]
    lens = stops - starts

    small = lens[lens <= MAX_CLUST_LEN]
    hist = np.bincount(small, weights=small,
                       minlength=MAX_CLUST_LEN + 1).astype(np.int64)
    hist = hist[: MAX_CLUST_LEN + 1]

    analyzed = lens >= 2 * mcov_out
    return Clusters(
        begins=starts[analyzed].astype(np.int64),
        ends=stops[analyzed].astype(np.int64),
        n_clusters=int(analyzed.sum()),
        clust_size_sum=int(lens.sum()),
        n_closed=int(len(lens)),
        hist=hist,
    )


def find_clusters_device(thr_K: torch.Tensor, minima: torch.Tensor,
                         mcov_out: int) -> Clusters:
    """Cluster detection on the flags' device: begins/ends stay there
    (int64, trimmed to the analyzed clusters); only the scalar stats and the
    histogram come to the host."""
    mask = (thr_K != 0) & (minima == 0)
    prev = torch.zeros_like(mask)
    prev[1:] = mask[:-1]
    nxt = torch.zeros_like(mask)
    nxt[:-1] = mask[1:]
    is_start = mask & ~prev
    end_at = mask & ~nxt
    end_at[-1:] = False  # a run reaching n-1 never closes (cluster.py:95)
    ends = torch.nonzero(end_at).flatten() + 1
    return _runs_to_clusters(torch.nonzero(is_start).flatten(), ends,
                             mcov_out)


def _runs_to_clusters(starts: torch.Tensor, ends: torch.Tensor,
                      mcov_out: int) -> Clusters:
    """Clusters from the run starts and (exclusive) ends in position order
    (runs_to_clusters, cluster.py:108): runs are disjoint, so the k-th
    start pairs with the k-th end, and an unclosed trailing start has no
    end and drops out."""
    starts = starts[: ends.shape[0]]
    lens = ends - starts

    small = lens[lens <= MAX_CLUST_LEN]
    hist = torch.zeros(MAX_CLUST_LEN + 1, dtype=torch.int64,
                       device=lens.device).index_add_(0, small, small)
    analyzed = lens >= 2 * mcov_out
    begins = starts[analyzed]
    return Clusters(
        begins=begins,
        ends=ends[analyzed],
        n_clusters=int(begins.shape[0]),
        clust_size_sum=int(lens.sum()),
        n_closed=int(ends.shape[0]),
        hist=hist.cpu().numpy(),
    )


def _run_bits_packed(thrK_w: torch.Tensor, min_w: torch.Tensor, lo: int,
                     hi: int, n: int):
    """Run-start and run-end bits of words [lo, hi) of the cluster mask
    thr_K & ~minima (_mask_and_counts_packed, cluster.py:258), as int64
    words in [0, 2^32): start bit p = mask[p] & ~mask[p-1], end bit
    p = mask[p-1] & ~mask[p], the run's exclusive end. Bit 31 of word lo-1
    carries mask[32*lo - 1] in. The end bit at position n is cleared: a
    run reaching n-1 never closes (cluster.py:269-274)."""
    a = max(lo - 1, 0)
    mw = (thrK_w[a:hi] & ~min_w[a:hi]).to(torch.int64) & _LOW32
    if lo == 0:
        mw = torch.cat([mw.new_zeros(1), mw])
    shifted = ((mw[1:] << 1) & _LOW32) | (mw[:-1] >> 31)
    mw = mw[1:]
    start = mw & ~shifted
    end = ~mw & shifted
    if 32 * lo <= n < 32 * hi:
        end[n // 32 - lo] &= ~(1 << (n & 31))
    return start, end


def find_clusters_device_packed(thrK_w: torch.Tensor, min_w: torch.Tensor,
                                *, n: int, mcov_out: int,
                                slice_len: int | None = None) -> Clusters:
    """``find_clusters_device`` over the bit-packed route's thr_K and minima
    words (find_clusters_device_packed, cluster.py:341): slice by slice
    (``slice_len`` positions, a multiple of 32, ``traverse.LEAN_SLICE`` by
    default), the start and end bits are unpacked and their positions taken
    with ``torch.nonzero``; then the runs pair up as in the dense route. No
    n-sized vector is made; each slice syncs once per ``nonzero``."""
    L = traverse._slice_len(slice_len)
    n_words = -(-n // 32)  # every mark lies at a position < n
    starts, ends = [], []
    for lo in range(0, n_words, L // 32):
        hi = min(lo + L // 32, n_words)
        s, e = _run_bits_packed(thrK_w, min_w, lo, hi, n)
        for out, w in ((starts, s), (ends, e)):
            out.append(torch.nonzero(bits.unpack_bits(w, 32 * (hi - lo)))
                       .flatten() + 32 * lo)
    return _runs_to_clusters(torch.cat(starts), torch.cat(ends), mcov_out)
