"""CPU tests of what surrounds the CUDA kernel: the twin's rank step, the
plan tables' compaction, the per-bucket kernel choice, the scorer
resolution per backend, the rerank dots and the compile-cache path."""
import jax.numpy as jnp
import numpy as np
import pytest

from document_search_engine_tpu.index.csr import LANES
from document_search_engine_tpu.ops import fused_cuda
from document_search_engine_tpu.ops.packed import rank_candidates
from document_search_engine_tpu.ops.plan import compact_rows, plan_tables
from document_search_engine_tpu.ops.schedule import compact_rows_per_query
from test_packed import make_aligned


def _rank_reference(d_key, ci, doc_base, k, n_docs):
    """Per row: integer score per doc, ranked (score desc, doc asc),
    matching docs only, (-1, -1) padding."""
    nq = d_key.shape[0]
    vals = np.full((nq, k), -1, np.int64)
    gids = np.full((nq, k), -1, np.int64)
    for q in range(nq):
        real = d_key[q] < n_docs
        docs, inv = np.unique(d_key[q][real], return_inverse=True)
        score = np.zeros(len(docs), np.int64)
        np.add.at(score, inv, ci[q][real])
        keep = score > 0
        docs, score = docs[keep], score[keep]
        order = np.lexsort((docs, -score))[:k]
        vals[q, : len(order)] = score[order]
        gids[q, : len(order)] = docs[order] + doc_base
    return vals, gids


@pytest.mark.parametrize("k", [5, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_candidates_matches_lexsort(seed, k):
    """The twin's rank step (sort by doc, run-sums, top_k) equals a
    numpy lexsort ranking on inputs full of score ties: few distinct
    contribution values, docs repeated across up to S slots, padding
    keys and zero contributions mixed in."""
    rng = np.random.default_rng(seed)
    nq, c, s, n_docs = 6, 512, 4, 300
    d_key = np.full((nq, c), n_docs, np.int32)
    ci = np.zeros((nq, c), np.int32)
    for q in range(nq):
        pos = 0
        for _slot in range(s):
            n = int(rng.integers(0, 100))
            docs = rng.choice(n_docs, size=n, replace=False)
            d_key[q, pos : pos + n] = docs
            ci[q, pos : pos + n] = rng.integers(0, 4, n)
            pos += n
        perm = rng.permutation(c)
        d_key[q], ci[q] = d_key[q][perm], ci[q][perm]
    vals, gids = rank_candidates(
        jnp.asarray(d_key), jnp.asarray(ci), jnp.int32(1000), s, k, n_docs
    )
    ref_v, ref_g = _rank_reference(d_key, ci, 1000, k, n_docs)
    np.testing.assert_array_equal(np.asarray(vals), ref_v)
    np.testing.assert_array_equal(np.asarray(gids), ref_g)


@pytest.mark.parametrize("block", [128, 512, 4096])
def test_plan_compaction_invariants(block):
    """dstrow is the exclusive running sum of each block's granule rows;
    skipped blocks hold nothing; a plan row's compacted rows equal the
    planner's per-query need; rem covers every real posting once."""
    rng = np.random.default_rng(block)
    n_terms, n_docs = 25, 6000
    lens = rng.integers(0, 3000, n_terms)
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    post_doc = np.concatenate(
        [np.sort(rng.choice(n_docs, size=n, replace=False)) for n in lens]
    ).astype(np.int32)
    post_val = rng.random(len(post_doc), dtype=np.float32)
    _d2, _v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    nq, s = 16, 5
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = rng.random((nq, s)).astype(np.float32)
    coeff[rng.random((nq, s)) < 0.3] = 0.0
    q_lens = (indptr[rows + 1] - indptr[rows]) * (coeff > 0)
    nb = int((-(-q_lens // block)).sum(1).max()) + 3  # spare blocks
    sr, rm, _ab, dst = (
        x[:, 0, :]
        for x in plan_tables(row_start, indptr, rows, coeff, nb, block)
    )
    crows = compact_rows(rm, block)
    assert (crows[sr < 0] == 0).all() and (rm[sr < 0] == 0).all()
    np.testing.assert_array_equal(dst[:, 0], 0)
    np.testing.assert_array_equal(dst[:, 1:], np.cumsum(crows, 1)[:, :-1])
    np.testing.assert_array_equal(
        crows.sum(1), compact_rows_per_query(q_lens, block)
    )
    np.testing.assert_array_equal(
        np.clip(rm, 0, block).sum(1), q_lens.sum(1)
    )
    assert (crows * LANES >= np.clip(rm, 0, block)).all()


@pytest.mark.parametrize(
    "r_c, k, takes, cap",
    [
        (1, 10, True, 1024),
        (8, 10, True, 1024),
        (128, 128, True, 16384),
        (256, 10, False, None),
        (64, 129, False, None),
    ],
)
def test_kernel_choice_by_rows(r_c, k, takes, cap):
    """A bucket runs the kernel only when its compacted buffer fits the
    kernel's shared memory and k <= 128; the kernel instantiation is the
    bucket's buffer, at least MIN_CAP_ROWS rows."""
    assert fused_cuda.kernel_takes(r_c, k) is takes
    if cap is not None:
        assert fused_cuda.kernel_cap(r_c) == cap


@pytest.mark.parametrize(
    "scorer, platform, want",
    [
        (None, "gpu", "fused"),
        (None, "cpu", "xla"),
        ("xla", "gpu", "xla"),
        ("fused", "cpu", ValueError),
        ("xla_rank", "gpu", ValueError),
    ],
)
def test_resolve_scorer(scorer, platform, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            fused_cuda.resolve_scorer(scorer, platform)
    else:
        assert fused_cuda.resolve_scorer(scorer, platform) == want


@pytest.mark.parametrize("sharded", [False, True])
def test_forced_kernel_on_cpu_raises(sharded):
    """Forcing the CUDA kernel on the CPU backend is an error, not an
    interpreted or silent fallback."""
    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    eng = (
        DistributedSearchEngine(mesh=make_mesh(2))
        if sharded
        else SearchEngine()
    )
    eng.build(["alpha beta", "beta gamma", "gamma delta"])
    assert eng.scorer_mode == "xla"
    eng.scorer = "fused"
    with pytest.raises(ValueError, match="CUDA"):
        eng.search(["beta"], k=2)


def test_rerank_dots_extreme_cells():
    """int8 x int8 -> int32 dots stay exact at the largest cells the
    embeddings hold (+-EMB_CLIP everywhere, dim 256)."""
    from document_search_engine_tpu.ops.rerank import EMB_CLIP, rerank_dots

    rng = np.random.default_rng(4)
    q = (rng.choice([-1, 1], (3, 256)) * EMB_CLIP).astype(np.int8)
    c = (rng.choice([-1, 1], (3, 7, 256)) * EMB_CLIP).astype(np.int8)
    c[0, 0] = q[0]  # the largest possible dot
    got = np.asarray(rerank_dots(jnp.asarray(q), jnp.asarray(c)))
    want = np.einsum("qe,qke->qk", q.astype(np.int64), c.astype(np.int64))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 256 * EMB_CLIP**2


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_cache_dir_choice(monkeypatch, tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR wins when set; otherwise the one fixed
    path inside the checkout."""
    import os

    from document_search_engine_tpu.utils import cache

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert cache.cache_dir() == os.path.join(root, ".jax_cache")
    else:
        path = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
        assert cache.cache_dir() == path


def test_cache_stays_off_on_cpu(monkeypatch):
    import jax

    from document_search_engine_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    cache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize(
    "mode, r_c, k, kernel",
    [
        ("xla", 8, 10, False),
        ("fused", 256, 10, False),
        ("fused", 8, 200, False),
        ("fused", 8, 10, True),
    ],
)
def test_score_bucket_routing(monkeypatch, mode, r_c, k, kernel):
    """score_bucket hands a bucket to the CUDA kernel only in fused mode
    when kernel_takes(r_c, k), offsetting its local doc ids by the doc
    base; every other bucket gets the XLA twin's result unchanged."""
    from document_search_engine_tpu.ops.packed import search_packed_tables

    rng = np.random.default_rng(5)
    n_terms, n_docs = 6, 400
    lens = rng.integers(1, 300, n_terms)
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    post_doc = np.concatenate(
        [np.sort(rng.choice(n_docs, size=n, replace=False)) for n in lens]
    ).astype(np.int32)
    post_val = rng.random(len(post_doc), dtype=np.float32)
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    rows = rng.integers(0, n_terms, (4, 2)).astype(np.int32)
    coeff = np.ones((4, 2), np.float32)
    tables = tuple(
        jnp.asarray(x)
        for x in plan_tables(row_start, indptr, rows, coeff, 4, 512)
    )
    calls = []

    def fake_kernel(*args, **kw):
        calls.append(kw)
        v = jnp.full((4, kw["k"]), 7, jnp.int32)
        return v, jnp.full((4, kw["k"]), 3, jnp.int32)

    monkeypatch.setattr(fused_cuda, "fused_search_cuda", fake_kernel)
    statics = dict(n_blocks=4, block=512, s=2, k=k, n_docs=n_docs, r_c=r_c)
    v, g = fused_cuda.score_bucket(
        mode, jnp.asarray(d2), jnp.asarray(v2), tables, jnp.int32(100),
        scale=65536.0, clip=1000.0, **statics,
    )
    if kernel:
        assert len(calls) == 1 and calls[0]["r_c"] == r_c
        np.testing.assert_array_equal(np.asarray(g), 103)
        return
    assert not calls
    tv, tg = search_packed_tables(
        jnp.asarray(d2), jnp.asarray(v2), *tables[:3], jnp.float32(65536.0),
        jnp.float32(1000.0), jnp.int32(100), n_blocks=4, block=512, s=2,
        k=k, n_docs=n_docs,
    )
    np.testing.assert_array_equal(np.asarray(v), np.asarray(tv))
    np.testing.assert_array_equal(np.asarray(g), np.asarray(tg))
