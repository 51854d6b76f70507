"""Hybrid dense rerank (BASELINE.json:11): device int8 embedding build
vs host reference (bit-identical), exact integer dots, deterministic
ordering, and end-to-end engine behavior."""
import jax.numpy as jnp
import numpy as np

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import SearchEngine
from document_search_engine_tpu.ops.rerank import (
    EMB_CLIP,
    device_doc_embeddings_int,
    doc_embeddings_int,
    query_embeddings_int,
    rerank_dots,
    rerank_dots_ref,
    rerank_order_int,
    term_projection,
)


def test_device_embeddings_match_host():
    """Device jit scatter-add over the aligned planes == host np.add.at
    reference, bit for bit (integer sums are order-free)."""
    from document_search_engine_tpu.index.builder import (
        _host_planes,
        aligned_geometry,
    )

    rng = np.random.default_rng(3)
    n_terms, n_docs, dim = 30, 200, 64
    term_hash = np.sort(
        rng.integers(1, 2**63, n_terms).astype(np.uint64)
    )
    lens = rng.integers(0, 40, n_terms)
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    nnz = int(indptr[-1])
    post_doc = np.concatenate(
        [
            np.sort(rng.choice(n_docs, size=l, replace=False))
            for l in lens
        ]
    ).astype(np.int32)
    post_val = rng.random(nnz, dtype=np.float32) * 2.3
    ref_emb, ref_ssq = doc_embeddings_int(
        term_hash, indptr, post_doc, post_val, n_docs, dim
    )
    row_start, x_rows = aligned_geometry(indptr, 1)
    d2, v2, _ = _host_planes(
        post_doc, post_val, np.ones(nnz, np.int32), indptr, row_start,
        x_rows, n_docs,
    )
    col, sign = term_projection(term_hash, dim)
    got_emb, got_ssq = device_doc_embeddings_int(
        jnp.asarray(d2), jnp.asarray(v2),
        jnp.asarray(row_start.astype(np.int32)),
        jnp.asarray(col), jnp.asarray(sign), n_docs=n_docs, dim=dim,
    )
    np.testing.assert_array_equal(np.asarray(got_emb), ref_emb)
    np.testing.assert_array_equal(np.asarray(got_ssq), ref_ssq)


def test_dots_exact_integers():
    """The int8 x int8 -> int32 dots and the f32 HIGHEST-precision
    reference must agree EXACTLY with numpy's int64 dots."""
    rng = np.random.default_rng(0)
    q = rng.integers(-EMB_CLIP, EMB_CLIP + 1, (4, 128)).astype(np.int8)
    c = rng.integers(-EMB_CLIP, EMB_CLIP + 1, (4, 16, 128)).astype(np.int8)
    got = np.asarray(rerank_dots(jnp.asarray(q), jnp.asarray(c)))
    assert got.dtype == np.int32
    ref = np.asarray(rerank_dots_ref(jnp.asarray(q), jnp.asarray(c)))
    np.testing.assert_array_equal(got, ref)
    exact = np.einsum(
        "qe,qke->qk", q.astype(np.int64), c.astype(np.int64)
    )
    np.testing.assert_array_equal(got, exact)


def test_rerank_order_ranking_rules():
    # cosines: candidates 0,1 tie (identical dot/norms); 2 lower; 3 dead
    dots = np.array([[90, 90, 10, 50]], np.int32)
    ssq_q = np.array([100], np.int64)
    ssq_d = np.array([[100, 100, 100, 100]], np.int32)
    lex = np.array([[5, 7, 9, -1]], np.int64)
    gids = np.array([[30, 20, 10, 40]], np.int64)
    ids, ri, lx = rerank_order_int(dots, ssq_q, ssq_d, lex, gids, k=4)
    # equal rerank: higher lexical wins -> gid 20 before 30; dead sinks
    assert list(ids[0]) == [20, 30, 10, -1]
    assert lx[0, 0] == 7 and lx[0, 1] == 5
    assert ri[0, 3] == -1


def test_query_embeddings_deterministic():
    slot_h = np.array([[11, 222, 3333, 0]], np.uint64)
    coeff = np.array([[1.5, 0.3, 2.0, 0.0]], np.float32)
    q1, s1 = query_embeddings_int(slot_h, coeff, 64)
    q2, s2 = query_embeddings_int(slot_h, coeff, 64)
    np.testing.assert_array_equal(q1, q2)
    assert np.abs(q1).max() == EMB_CLIP
    assert s1[0] == (q1[0].astype(np.int64) ** 2).sum()


def test_rerank_with_empty_vocabulary_segment():
    """Regression: a segment whose docs tokenize to nothing (empty
    vocabulary) crashed the device embedding build's term gather; such
    segments must embed as zero vectors and rerank must still work."""
    docs = synth_corpus(n_docs=30, vocab_size=200, mean_len=20, seed=19)
    queries = synth_queries(docs, n_queries=3, seed=20)
    eng = SearchEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")))
    eng.build(docs)
    eng.add_docs(["", "!!! ???"])  # empty-vocab segment
    ids, ri, lx = eng.search_rerank(queries, k=5, candidates=16)
    assert ids.shape == (3, 5)
    assert (ids[0] >= 0).any()


def test_engine_search_rerank_end_to_end():
    docs = synth_corpus(n_docs=80, vocab_size=400, mean_len=30, seed=17)
    queries = synth_queries(docs, n_queries=6, seed=18)
    eng = SearchEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")))
    eng.build(docs)
    ids, ri, lx = eng.search_rerank(queries, k=10, candidates=32)
    assert ids.shape == (6, 10)
    # reranked set is drawn from the lexical candidate pool
    pool_ids, _ = eng.search(queries, k=32)
    for row in range(6):
        got = set(i for i in ids[row].tolist() if i >= 0)
        pool = set(i for i in pool_ids[row].tolist() if i >= 0)
        assert got <= pool
    # deterministic across calls (cache warm + cold)
    ids2, ri2, _ = eng.search_rerank(queries, k=10, candidates=32)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(ri, ri2)
    # incremental update invalidates embeddings without breaking rerank
    eng.add_docs(docs[:3])
    ids3, _, _ = eng.search_rerank(queries, k=10, candidates=32)
    assert ids3.shape == (6, 10)
    # host-build engine produces the identical rerank (device == host
    # embeddings bitwise; ordering is host f64 either way)
    eng2 = SearchEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")))
    eng2.device_build = False
    eng2.build(docs)
    eng2.add_docs(docs[:3])
    ids4, ri4, _ = eng2.search_rerank(queries, k=10, candidates=32)
    np.testing.assert_array_equal(ids4, ids3)


def test_search_rerank_single_frontend_pass():
    """search_rerank runs ONE frontend analysis per call (round-3
    VERDICT #6: candidate gen + rerank each analyzed the batch), for
    both engines, with results unchanged."""
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    docs = synth_corpus(n_docs=60, vocab_size=300, mean_len=25, seed=23)
    queries = synth_queries(docs, n_queries=5, seed=24)

    def counted(frontend):
        calls = {"rows": 0, "analyze": 0}
        orig_rows = frontend.analyze_rows
        orig_an = frontend.analyze

        def rows(q, stats):
            calls["rows"] += 1
            return orig_rows(q, stats)

        def an(q, stats):
            calls["analyze"] += 1
            return orig_an(q, stats)

        frontend.analyze_rows = rows
        frontend.analyze = an
        return calls

    eng = SearchEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")))
    eng.build(docs)
    ref = eng.search_rerank(queries, k=8, candidates=16)
    calls = counted(eng.frontend)
    got = eng.search_rerank(queries, k=8, candidates=16)
    assert calls["rows"] == 1 and calls["analyze"] == 0
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)

    deng = DistributedSearchEngine(
        IndexConfig(scoring=ScoringConfig(kind="bm25")),
        mesh=make_mesh(2),
    )
    deng.build(docs)
    dref = deng.search_rerank(queries, k=8, candidates=16)
    dcalls = counted(deng.frontend)
    dgot = deng.search_rerank(queries, k=8, candidates=16)
    assert dcalls["rows"] == 1 and dcalls["analyze"] == 0
    for a, b in zip(dref, dgot):
        np.testing.assert_array_equal(a, b)
    # sharded == single engine (the existing bit-parity contract)
    for a, b in zip(ref, dref):
        np.testing.assert_array_equal(a, b)
