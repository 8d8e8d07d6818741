"""Disaggregated prefill's page transport against the JAX package's: on the
same pool contents (seeded numpy), the port's ``export_row_pages`` equals
the JAX one bit for bit (fp32, and int8 with its scale planes, with
prefix-aliased leading pages in the row), a page blob staged by either
package loads in the other, an import writes only the row's own pages,
and a blob of another page size or quantization is refused."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.ops import kv_cache as TKV
from penroz_tpu_torch.utils import checkpoint as tckpt

SPECS = [(2, 8), (3, 4)]
BATCH, MAX_LEN, PAGE, EXTRA = 3, 16, 4, 4
PLANES = ("k", "v")
SCALES = ("k_scale", "v_scale")


@pytest.fixture(autouse=True)
def _page_env(monkeypatch, tmp_path):
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", str(PAGE))
    shm = str(tmp_path / "shm")
    monkeypatch.setattr(jckpt, "SHM_PATH", shm)
    monkeypatch.setattr(tckpt, "SHM_PATH", shm)


def _pools(int8: bool, seed: int = 0):
    """One pair of pools (JAX, port) with the same seeded contents and a
    static table; int8 pools get seeded scales too."""
    rng = np.random.default_rng(seed)
    j = JKV.create_kv_state(SPECS, BATCH, MAX_LEN, quantized=int8,
                            paged=True, extra_pool_pages=EXTRA)
    t = TKV.create_kv_state(SPECS, BATCH, MAX_LEN, quantized=int8,
                            paged=True, extra_pool_pages=EXTRA, device="cpu")
    j = j.with_static_table().with_lengths(np.zeros(BATCH, np.int32))
    t.with_static_table().with_lengths(np.zeros(BATCH, np.int32))
    names = PLANES + (SCALES if int8 else ())
    for name in names:
        jl, tl = [], []
        for a in getattr(t, name):
            if a.dtype == torch.int8:
                arr = rng.integers(-127, 128, a.shape).astype(np.int8)
            else:
                arr = rng.standard_normal(a.shape).astype(np.float32)
            jl.append(jnp.asarray(arr))
            tl.append(torch.from_numpy(arr.copy()))
        setattr(j, name, jl)
        setattr(t, name, tl)
    return j, t, names


def _same_pools(j, t, names):
    for name in names:
        for a, b in zip(getattr(j, name), getattr(t, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("length", [1, 4, 11, 16])
def test_export_row_pages_matches_jax_bit_for_bit(int8, length):
    j, t, names = _pools(int8)
    base = BATCH * (MAX_LEN // PAGE)
    prefix = [base + 2, base]             # aliased cache pages, out of order
    j = j.with_row_prefix(1, prefix)
    t.with_row_prefix(1, prefix)
    jb = j.export_row_pages(1, length)
    tb = t.export_row_pages(1, length)
    for key in ("page_size", "pages", "length", "quantized"):
        assert tb[key] == jb[key], key
    assert tb["pages"] == -(-length // PAGE)
    for name in names:
        assert len(tb[name]) == len(jb[name]) == len(SPECS)
        for a, b in zip(jb[name], tb[name]):
            assert b.device.type == "cpu"
            assert str(b.dtype).split(".")[-1] == str(a.dtype)
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the gather follows the table: the aliased pages lead, in position order
    k0 = t.k[0].numpy()
    np.testing.assert_array_equal(tb["k"][0].numpy()[:, :PAGE],
                                  k0[:, prefix[0] * PAGE:(prefix[0] + 1)
                                     * PAGE])
    dev = t.export_row_pages(1, length, device=True)
    for name in names:
        for a, b in zip(dev[name], tb[name]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_page_blobs_cross_between_packages(int8):
    j, t, names = _pools(int8, seed=1)
    jb = j.export_row_pages(2, 9)
    jb["first_token"] = 7
    jckpt.save_page_blob("from-jax", jb)
    got = tckpt.load_page_blob("from-jax")
    assert got["first_token"] == 7 and got["pages"] == 3
    for name in names:
        for a, b in zip(jb[name], got[name]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    tb = t.export_row_pages(2, 9)
    tb["first_token"] = 7
    tckpt.save_page_blob("from-torch", tb)
    back = jckpt.load_page_blob("from-torch")
    assert back["first_token"] == 7 and bool(back["quantized"]) == int8
    for name in names:
        for a, b in zip(back[name], tb[name]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tckpt.page_blob_nbytes(tb) == jckpt.page_blob_nbytes(jb) > 0
    assert tckpt.delete_page_blob("from-jax")
    assert jckpt.delete_page_blob("from-torch")
    with pytest.raises(KeyError):
        tckpt.load_page_blob("from-jax")


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_import_writes_only_the_rows_own_pages(int8):
    """An import into a row that held a prefix alias restores the row's
    table first: the blob lands in the row's own static pages, the cache
    pages it aliased and every other row stay as they were, and the pools
    equal the JAX import's."""
    j, t, names = _pools(int8, seed=2)
    src_j, src_t, _ = _pools(int8, seed=3)
    blob = src_t.export_row_pages(0, 10)
    jblob = src_j.export_row_pages(0, 10)
    base = BATCH * (MAX_LEN // PAGE)
    j = j.with_row_prefix(2, [base + 1, base + 3])
    t.with_row_prefix(2, [base + 1, base + 3])
    before = {name: [a.clone() for a in getattr(t, name)] for name in names}
    t.import_row_pages(2, blob)
    j = j.import_row_pages(2, jblob)
    _same_pools(j, t, names)
    S = MAX_LEN // PAGE
    np.testing.assert_array_equal(t.table[2], np.arange(2 * S, 3 * S))
    own = np.arange(2 * S * PAGE, 2 * S * PAGE + 3 * PAGE)
    for name in names:
        for old, new, plane in zip(before[name], getattr(t, name),
                                   blob[name]):
            assert torch.equal(new[:, own], plane)
            keep = np.setdiff1d(np.arange(new.shape[1]), own)
            assert torch.equal(new[:, keep], old[:, keep])
    # a blob staged on the host transport imports the same way
    tckpt.save_page_blob("staged", blob)
    _, t2, _ = _pools(int8, seed=2)
    t2.import_row_pages(2, tckpt.load_page_blob("staged"))
    for name in names:
        for a, b in zip(getattr(t, name), getattr(t2, name)):
            assert torch.equal(a, b)


def test_mismatched_blob_is_refused():
    _, t, _ = _pools(False)
    _, q, _ = _pools(True)
    blob = t.export_row_pages(0, 8)
    with pytest.raises(ValueError, match="quantization"):
        q.import_row_pages(0, blob)
    with pytest.raises(ValueError, match="quantization"):
        t.import_row_pages(0, q.export_row_pages(0, 8))
    with pytest.raises(ValueError, match="page_size"):
        t.import_row_pages(0, dict(blob, page_size=8))
    with pytest.raises(ValueError, match="pages_per_seq"):
        t.import_row_pages(0, dict(blob, pages=MAX_LEN // PAGE + 1))
    with pytest.raises(ValueError, match="pages_per_seq"):
        t.export_row_pages(0, MAX_LEN + 1)
