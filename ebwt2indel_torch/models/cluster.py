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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MAX_CLUST_LEN = 200  # histogram cap (ebwt2InDel.cpp:1388)


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
    # runs are disjoint, so the k-th start pairs with the k-th end; an
    # unclosed trailing start has no end and drops out
    starts = torch.nonzero(is_start).flatten()[: ends.shape[0]]
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
