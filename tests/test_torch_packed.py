"""The port's bit-packed route (ebwt2indel_torch: ``packed=True`` of the
traversals and pipelines) against the JAX package's packed route, forced at
small n as tests/test_coords.py:179-180 forces it, and against the port's own
dense route, on the CPU. Everything compared is integer or bytes, so the
tolerance is 0.

One read set serves all three modes: its eBWT is mode 1's input and mode 3's
merged eBWT (the same reads in the same order), and its two halves are mode
2's two eBWTs, so every run has the same n (not a multiple of 32). Small
slices make the port's passes cross many slice boundaries."""

import numpy as np
import pytest
import torch

from ebwt2indel_tpu.models import call as jcall
from ebwt2indel_tpu.models import cluster as jcluster
from ebwt2indel_tpu.models import fm_index as jfm
from ebwt2indel_tpu.models import pipeline as jpipeline
from ebwt2indel_tpu.models import traverse as jtraverse
from ebwt2indel_tpu.ops import bits as jbits
from ebwt2indel_tpu.tools import ebwt as jebwt
from ebwt2indel_tpu.tools import simulate as jsim
from ebwt2indel_tpu.utils.config import Config
from ebwt2indel_torch.models import call, cluster, pipeline, traverse
from ebwt2indel_torch.models.fm_index import FMIndex
from ebwt2indel_torch.ops import bits, packing

# the pipelines' defaults (Config), so that the JAX runs' captured
# traversals and clusters are comparable with the port's own calls
_CFG = Config().resolved()
K, K_RIGHT, MCOV = _CFG.K, _CFG.k_right, _CFG.mcov_out
# slices of 96 and 1024 positions cross hundreds and tens of boundaries;
# None is the module's LEAN_SLICE, one slice at this n
SLICES = [96, 1024, None]
_QUIET = {"log": lambda *a, **k: None}
_STATS = ("leaves", "nodes", "lcp_values", "n_min")


@pytest.fixture(scope="module", autouse=True)
def _jax_packed_route():
    """The JAX package's packed route at any n, as tests/test_coords.py
    forces it, with a small queue chunk (its results do not depend on it)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtraverse, "_LEAN_N", 0)
        mp.setenv("EBWT_FORCE_HUGE_DIF", "1")
        mp.setattr(jtraverse, "CHUNK", 4096)
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_packed")
    rng = np.random.default_rng(0xB16)
    genome = jsim.random_genome(rng, 3000)
    hap2, _ = jsim.plant_variants(rng, genome, snp_rate=0.004,
                                  indel_rate=0.001)
    reads1 = jsim.sample_reads(rng, genome, 8, 80)
    reads2 = jsim.sample_reads(rng, hap2, 8, 80)
    bwt, da = jebwt.ebwt_and_da_of_two(reads1, reads2)
    (d / "m.ebwt").write_text(bwt)
    (d / "m.da").write_text(da)
    (d / "a.ebwt").write_text(jebwt.ebwt_of_reads(reads1))
    (d / "b.ebwt").write_text(jebwt.ebwt_of_reads(reads2))
    n = len(bwt)
    assert n % 32 and n % 128  # the packed tails are partial
    jf = {k: jfm.FMIndex.from_file(str(d / f"{k}.ebwt")) for k in "mab"}
    tf = {k: FMIndex.from_numpy(np.asarray(f.blocks),
                                np.asarray(f.block_counts), np.asarray(f.F),
                                f.n, f.term, device="cpu")
          for k, f in jf.items()}
    return {"dir": d, "n": n, "jf": jf, "tf": tf, "port": {}}


def _navigate(idx, mode, **kw):
    if mode == 1:
        return traverse.navigate_one_bwt(idx["m"], K, K_RIGHT, **kw)
    return traverse.navigate_two_bwts(idx["a"], idx["b"], K, K_RIGHT, **kw)


def _port(data, mode, slice_len="dense"):
    """The port's traversal, once per mode and route (the results are only
    read): the dense route, or the packed one at ``slice_len``."""
    key = (mode, slice_len)
    if key not in data["port"]:
        kw = ({"packed": False} if slice_len == "dense"
              else {"packed": True, "slice_len": slice_len})
        data["port"][key] = _navigate(data["tf"], mode, **kw)
    return data["port"][key]


def _run(pkg, mode, d, out, **kw):
    """Mode ``mode`` of a package's pipeline on the data set; returns its
    stats and the .snp bytes."""
    if mode == 1:
        cfg = Config(input1=str(d / "m.ebwt"), output=str(d / out))
        run = pkg.run_one_dataset
    elif mode == 2:
        cfg = Config(input1=str(d / "a.ebwt"), input2=str(d / "b.ebwt"),
                     output=str(d / out))
        run = pkg.run_two_datasets
    else:
        cfg = Config(input1=str(d / "m.ebwt"), input_da=str(d / "m.da"),
                     output=str(d / out))
        run = pkg.run_two_datasets_da
    return run(cfg, **_QUIET, **kw), (d / out).read_bytes()


@pytest.fixture(scope="module")
def jax_runs(data):
    """Each mode of the JAX pipeline once, on its packed route, with what
    its traversal, anchor table, cluster extraction and DA counts returned,
    captured as numpy on the way (its cluster extraction donates the flag
    words, and one run compiles what a separate call would compile again)."""
    fns = ((jtraverse, "navigate_one_bwt", "res"),
           (jtraverse, "navigate_two_bwts", "res"),
           (jcall, "right_anchor_table_packed", "anchor"),
           (jcluster, "find_clusters_device_packed", "clusters"),
           (jbits, "bv_counts", "da_counts"))
    runs = {}

    def capture(fn, key, got):
        def wrapped(*a, **k):
            r = fn(*a, **k)
            got[key] = r
            if key == "res":
                got[key] = {lane: _words(getattr(r, lane))
                            for lane in _lanes(2) if getattr(r, lane)
                            is not None}
                got[key]["stats"], got[key]["packed"] = r.stats, r.packed
            elif key == "anchor":
                got[key] = tuple(np.array(x) for x in r)
            elif key == "da_counts":
                got[key] = np.array(r)
            return r
        return wrapped

    for mode in (1, 2, 3):
        got = runs[mode] = {}
        with pytest.MonkeyPatch.context() as mp:
            for mod, name, key in fns:
                mp.setattr(mod, name, capture(getattr(mod, name), key, got))
            got["stats"], got["snp"] = _run(jpipeline, mode, data["dir"],
                                            f"jax{mode}.snp")
        assert got["res"]["packed"]
    return runs


def _lanes(mode):
    return ("thr_K", "thr_R", "minima") + (("da",) if mode == 2 else ())


def _words(x) -> np.ndarray:
    """A copy: a JAX CPU array's buffer may be donated and reused later."""
    return np.array(x).view(np.int32)


@pytest.mark.parametrize("L", [1, 31, 32, 33, 4096 + 5])
def test_pack_bits_matches_jax_and_unpacks(L):
    rng = np.random.default_rng(L)
    b = (rng.random(L) < 0.5).astype(np.uint8)
    w = bits.pack_bits(torch.from_numpy(b))
    assert w.dtype == torch.int32 and w.shape == (-(-L // 32),)
    padded = np.zeros(32 * w.shape[0], np.uint8)
    padded[:L] = b
    np.testing.assert_array_equal(
        w.numpy(), _words(jtraverse._pack_bits_u32(padded)))
    np.testing.assert_array_equal(bits.unpack_bits(w, L).numpy(), b)
    np.testing.assert_array_equal(
        bits.unpack_bits(w.to(torch.int64) & 0xFFFFFFFF, L).numpy(), b)


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("slice_len", SLICES)
def test_traversal_words_match_jax_and_dense(data, jax_runs, mode,
                                             slice_len):
    """thr_K, thr_R, minima (and mode 2's DA) words equal JAX's over its
    4 * ceil(n / 128) words; the port's one extra block is zero; unpacked,
    they are the dense route's flags."""
    n = data["n"]
    got = _port(data, mode, slice_len)
    dense = _port(data, mode)
    want = jax_runs[mode]["res"]
    assert got.packed and not dense.packed
    W = 4 * -(-n // 128)
    for lane in _lanes(mode):
        w = getattr(got, lane)
        assert w.dtype == torch.int32 and w.shape == (4 * (n // 128 + 1),)
        np.testing.assert_array_equal(w.numpy()[:W], want[lane][:W],
                                      err_msg=lane)
        assert not w.numpy()[W:].any()
        assert torch.equal(bits.unpack_bits(w, n), getattr(dense, lane)), lane
    for k in _STATS + (("da_values",) if mode == 2 else ()):
        assert got.stats[k] == want["stats"][k] == dense.stats[k], k


def test_fills_packed_frees_each_delta_vector():
    """The fills of ``_fills_packed`` are the prefix sums > 0, slice by
    slice, and the delta list is emptied as each fill is packed."""
    rng = np.random.default_rng(5)
    n = 1000
    lo = rng.integers(0, n, 60)
    hi = np.minimum(lo + rng.integers(1, 90, 60), n)
    dif = torch.zeros(n + 1, dtype=torch.int32)
    traverse._add_bounds(dif, torch.from_numpy(lo), torch.from_numpy(hi))
    want = np.zeros(n, np.uint8)
    for a, b in zip(lo, hi):
        want[a:b] = 1
    difs = [dif, dif.clone()]
    fills = traverse._fills_packed(difs, n, slice_len=64)
    assert difs == [] and len(fills) == 2
    for f in fills:
        np.testing.assert_array_equal(bits.unpack_bits(f, n).numpy(), want)
        assert not bits.unpack_bits(f, f.shape[0] * 32).numpy()[n:].any()


def test_slice_len_must_be_a_multiple_of_32(data):
    with pytest.raises(ValueError, match="multiple of 32"):
        traverse.navigate_one_bwt(data["tf"]["m"], K, K_RIGHT, packed=True,
                                  slice_len=100)


@pytest.mark.parametrize("mode", [1, 2])
def test_anchor_and_first_thr_match_jax_and_dense(data, jax_runs, mode):
    """(words, T) equal JAX's right_anchor_table_packed, and the anchors of
    random ranges and of the clusters equal JAX's and the dense table's."""
    n = data["n"]
    got = _port(data, mode, 96)
    dense = _port(data, mode)
    words, T = call._anchor_from_words(got.thr_R, n)
    jwords, jT = jax_runs[mode]["anchor"]
    nb = -(-n // 128)
    np.testing.assert_array_equal(words.numpy()[:4 * nb], _words(jwords))
    assert T.dtype == torch.int64 and T.shape == (n // 128 + 2,)
    np.testing.assert_array_equal(T.numpy()[:nb + 1], np.asarray(jT))
    assert T[-1] == n

    rng = np.random.default_rng(mode)
    cl = cluster.find_clusters_device(dense.thr_K, dense.minima, MCOV)
    begins = np.concatenate([rng.integers(0, n, 400), cl.begins.numpy(),
                             [0, 127, 128, n - 1]])
    ends = np.minimum(begins + np.concatenate(
        [rng.integers(1, 400, 400), (cl.ends - cl.begins).numpy(),
         [1, 1, 129, 1]]), n)
    tb, te = torch.from_numpy(begins), torch.from_numpy(ends)
    pos, found = call.first_thr_position_device((words, T), tb, te)
    dpos, dfound = call.first_thr_position_device(
        call.next_set_table(dense.thr_R), tb, te)
    jpos, jfound = jcall.first_thr_position_device(
        (jwords, jT), begins.astype(np.int32), ends.astype(np.int32))
    assert found.any() and not found.all()
    for p, f in ((dpos, dfound), (np.asarray(jpos), np.asarray(jfound))):
        np.testing.assert_array_equal(pos.numpy(), np.asarray(p))
        np.testing.assert_array_equal(found.numpy(), np.asarray(f))


@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("slice_len", SLICES)
def test_clusters_match_jax_and_dense(data, jax_runs, mode, slice_len):
    n = data["n"]
    got_res = _port(data, mode, slice_len)
    dense = _port(data, mode)
    got = cluster.find_clusters_device_packed(
        got_res.thr_K, got_res.minima, n=n, mcov_out=MCOV,
        slice_len=slice_len)
    want = jax_runs[mode]["clusters"]
    dcl = cluster.find_clusters_device(dense.thr_K, dense.minima, MCOV)
    assert got.n_clusters > 0
    for ref in (want, dcl):
        np.testing.assert_array_equal(got.begins.numpy(),
                                      np.asarray(ref.begins))
        np.testing.assert_array_equal(got.ends.numpy(), np.asarray(ref.ends))
        np.testing.assert_array_equal(got.hist, np.asarray(ref.hist))
        for k in ("n_clusters", "clust_size_sum", "n_closed"):
            assert getattr(got, k) == getattr(ref, k), k
    assert got.begins.dtype == got.ends.dtype == torch.int64


def test_run_reaching_the_end_never_closes():
    """The end bit at position n is cleared, wherever n falls in its word,
    and a run closed just before n still counts (cluster.py:269-274)."""
    for n in (40, 64, 127, 128, 129):
        for tail in (0, 1):  # the last position in the mask, or not
            m = np.zeros(n, np.uint8)
            m[3:9] = m[20:n - 1 + tail] = 1
            w = bits.pack_bits(torch.from_numpy(m))
            words = torch.zeros(4 * (n // 128 + 1), dtype=torch.int32)
            words[:w.shape[0]] = w
            for L in (32, 64, None):
                got = cluster.find_clusters_device_packed(
                    words, torch.zeros_like(words), n=n, mcov_out=1,
                    slice_len=L)
                want = cluster.find_clusters(m, np.zeros(n, np.uint8), 1)
                assert got.begins.tolist() == want.begins.tolist(), (n, L)
                assert got.ends.tolist() == want.ends.tolist(), (n, L)
                assert got.n_closed == want.n_closed == 2 - tail


def test_bv_counts_matches_jax(data, jax_runs):
    """Mode 2's packed DA words with bv_counts rank like the dense DA's
    bv_build structure, and the counts equal JAX's."""
    n = data["n"]
    got = _port(data, 2, 1024)
    dense = _port(data, 2)
    counts = bits.bv_counts(got.da)
    nb = -(-n // 128)
    np.testing.assert_array_equal(counts.numpy()[:nb],
                                  jax_runs[2]["da_counts"])
    dw, dc = bits.bv_build(dense.da)
    assert torch.equal(got.da, dw) and torch.equal(counts, dc)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_snp_matches_jax_and_dense(data, jax_runs, mode, monkeypatch):
    """The .snp of the port's packed route equals the JAX package's packed
    route and the port's dense route, with the stats equal."""
    d = data["dir"]
    jst, want = jax_runs[mode]["stats"], jax_runs[mode]["snp"]
    monkeypatch.setattr(traverse, "LEAN_SLICE", 96)
    pst, got = _run(pipeline, mode, d, f"packed{mode}.snp", device="cpu",
                    packed=True)
    dst, dense = _run(pipeline, mode, d, f"dense{mode}.snp", device="cpu",
                      packed=False)
    assert got == want == dense and got
    keys = ("events", "cluster_nr", "n_clusters") + _STATS
    for k in keys + (("da_values",) if mode == 2 else ()):
        assert pst[k] == jst[k] == dst[k], k


def test_lean_n_chooses_the_route(monkeypatch):
    """packed=None takes the packed route from LEAN_N positions on (over
    the merged n in mode 2); a tiny index is enough to see the choice."""
    fm = FMIndex.from_packed(
        packing.pack_bytes(np.frombuffer(b"ACG#TTGCA#AC#", np.uint8)),
        device="cpu")
    n = fm.n
    for lean_n, one, two in ((n, True, True), (n + 1, False, True),
                             (2 * n + 1, False, False)):
        monkeypatch.setattr(traverse, "LEAN_N", lean_n)
        assert traverse.navigate_one_bwt(fm, 2, 3).packed is one
        assert traverse.navigate_two_bwts(fm, fm, 2, 3).packed is two
