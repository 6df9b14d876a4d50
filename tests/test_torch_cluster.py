"""The port's cluster detection (ebwt2indel_torch/models/cluster.py) against
the JAX package's device path (find_clusters_device) and the numpy
find_clusters, on the same flag vectors. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ebwt2indel_tpu.models import cluster as jcluster
from ebwt2indel_torch.models import cluster


def _flags(rng, n, p_run):
    """Runs of set thr_K bits with sparse minima inside them."""
    thr = np.zeros(n, np.uint8)
    i = 0
    while i < n:
        ln = int(rng.integers(1, 40))
        if rng.random() < p_run:
            thr[i:i + ln] = 1
        i += ln + int(rng.integers(1, 5))
    minima = ((rng.random(n) < 0.03) & (thr == 1)).astype(np.uint8)
    return thr, minima


def _check(thr, minima, mcov_out):
    got = cluster.find_clusters_device(torch.from_numpy(thr),
                                       torch.from_numpy(minima), mcov_out)
    want = jcluster.find_clusters_device(jnp.asarray(thr),
                                         jnp.asarray(minima), mcov_out)
    host = cluster.find_clusters(thr, minima, mcov_out)
    jhost = jcluster.find_clusters(thr, minima, mcov_out)
    for other in (want, host, jhost):
        np.testing.assert_array_equal(got.begins.numpy(),
                                      np.asarray(other.begins))
        np.testing.assert_array_equal(got.ends.numpy(), np.asarray(other.ends))
        assert got.n_clusters == other.n_clusters
        assert got.clust_size_sum == other.clust_size_sum
        assert got.n_closed == other.n_closed
        np.testing.assert_array_equal(got.hist, np.asarray(other.hist))
    return got


@pytest.mark.parametrize("seed,n,mcov_out", [(1, 5000, 3), (2, 20000, 2),
                                             (3, 777, 5)])
def test_find_clusters_device_matches_jax(seed, n, mcov_out):
    rng = np.random.default_rng(seed)
    thr, minima = _flags(rng, n, 0.6)
    got = _check(thr, minima, mcov_out)
    assert got.n_clusters > 0


def test_runs_at_both_ends_and_long_runs():
    thr = np.ones(600, np.uint8)  # one run from 0 that reaches n-1
    minima = np.zeros(600, np.uint8)
    got = _check(thr, minima, 3)
    assert got.n_closed == 0  # a run reaching n-1 never closes
    minima[250] = 1  # closes [0, 250) (longer than the 200 cap); the run
    got = _check(thr, minima, 3)  # [251, 600) still never closes
    assert got.n_closed == 1 and got.hist.sum() == 0
    thr[598] = 0  # [251, 598) closes, [599, 600) does not
    got = _check(thr, minima, 3)
    assert got.begins.tolist() == [0, 251] and got.ends.tolist() == [250, 598]
    thr[:] = 0
    thr[[0, 2, 3, 599]] = 1
    got = _check(thr, np.zeros(600, np.uint8), 1)
    # [0, 1) and [2, 4) close; only runs of length >= 2*mcov_out are analyzed
    assert got.n_closed == 2 and got.begins.tolist() == [2]
    assert got.hist[1] == 1 and got.hist[2] == 2
