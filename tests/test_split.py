"""Doc-range splitting of heavy queries (ops/schedule.py split_pieces +
the scorers' dlim mask): pieces are doc-DISJOINT ranges of one query,
each ranked in a smaller buffer, merged by (score desc, gid asc) —
every doc's integer score is complete within exactly one piece, so the
merged ranking must equal the unsplit ranking bit for bit (the same
argument as the doc-sharded segment merge). On the CPU the pieces run
through the XLA twin; splitting needs a single block family."""
import numpy as np
import jax.numpy as jnp

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.index import builder as B
from document_search_engine_tpu.ops.packed import search_packed_tables
from document_search_engine_tpu.ops.plan import (
    expand_plan_tables,
    plan_tables,
)
from document_search_engine_tpu.ops.schedule import block_plan
from test_packed import make_aligned

SPLIT_FAMILIES = ((None, 512),)


def _csr(rng, n_terms, n_docs, max_len):
    lens = rng.integers(1, max_len, n_terms)
    indptr = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    parts = [
        np.sort(rng.choice(n_docs, size=l, replace=False).astype(np.int32))
        for l in lens
    ]
    doc = np.concatenate(parts)
    val = rng.random(len(doc), dtype=np.float32) * 0.9 + 0.05
    return indptr.astype(np.int32), doc, val


def test_doc_quantile_twins():
    """host_row_doc_quantiles == device_row_doc_quantiles == per-row
    searchsorted, including empty rows."""
    rng = np.random.default_rng(3)
    n_terms, n_docs, p = 30, 977, 8
    lens = rng.integers(0, 300, n_terms)
    indptr = np.zeros(n_terms + 1, np.int32)
    np.cumsum(lens, out=indptr[1:])
    parts = [
        np.sort(rng.choice(n_docs, size=l, replace=False).astype(np.int32))
        for l in lens
    ]
    post_doc = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    offs = B.host_row_doc_quantiles(indptr, post_doc, p, n_docs)
    bounds = B.quantile_doc_bounds(p, n_docs)
    for t in range(n_terms):
        row = post_doc[indptr[t] : indptr[t + 1]]
        np.testing.assert_array_equal(
            offs[t], np.searchsorted(row, bounds), f"row {t}"
        )
    post_val = rng.random(len(post_doc), dtype=np.float32)
    d2, _v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    offs_d = B.device_row_doc_quantiles(
        jnp.asarray(d2), jnp.asarray(indptr),
        jnp.asarray(row_start.astype(np.int32)), p, n_docs,
    )
    np.testing.assert_array_equal(np.asarray(offs_d), offs)


def test_doc_quantile_device_zero_length_row():
    """A zero-length row whose aligned start aliases a NEIGHBOR row's
    records (the global-row tables of the sharded engine contain one
    such row for every term a shard lacks): the device binary search
    must return all-zero offsets, not the neighbor's counts (regression:
    the unclamped search probed flat[start] and could emit 1)."""
    n_docs, p = 1000, 8
    indptr = np.array([0, 0, 4], np.int32)  # row 0 empty
    post_doc = np.array([1, 5, 7, 900], np.int32)
    row_start = np.array([0, 0], np.int32)  # empty row shares start 0
    flat = np.full(256, n_docs, np.int32)
    flat[:4] = post_doc
    offs_h = B.host_row_doc_quantiles(indptr, post_doc, p, n_docs)
    offs_d = np.asarray(
        B.device_row_doc_quantiles(
            jnp.asarray(flat.reshape(2, 128)), jnp.asarray(indptr),
            jnp.asarray(row_start), p, n_docs,
        )
    )
    np.testing.assert_array_equal(offs_d, offs_h)
    assert (offs_d[0] == 0).all()


def test_split_pieces_match_unsplit_kernel_and_twin():
    """The device plan expansion (offs gather) == the host piece plan;
    merged piece top-ks of the twin == its unsplit ranking."""
    rng = np.random.default_rng(13)
    n_terms, n_docs, p = 25, 3000, 8
    indptr, post_doc, post_val = _csr(rng, n_terms, n_docs, 2000)
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    offs = B.host_row_doc_quantiles(indptr, post_doc, p, n_docs)
    bounds = B.quantile_doc_bounds(p, n_docs)
    nq, s, block, k = 4, 4, 512, 10
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = rng.random((nq, s)).astype(np.float32) * 1.5
    coeff[1, 2] = 0.0
    scale = float(np.float32(2.0**16))
    clip = float(np.float32(65075262.0))
    nb = block_plan(indptr, rows, coeff > 0, block=block)
    sr, rm, ab, dst = plan_tables(row_start, indptr, rows, coeff, nb, block)
    ref = search_packed_tables(
        jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(sr),
        jnp.asarray(rm), jnp.asarray(ab), jnp.float32(scale),
        jnp.float32(clip), jnp.int32(0), n_blocks=nb, block=block,
        s=s, k=k, n_docs=n_docs,
    )
    rv, rd = np.asarray(ref[0]), np.asarray(ref[1])
    m = 4
    rows_p = np.repeat(rows, m, axis=0)
    coeff_p = np.repeat(coeff, m, axis=0)
    cols = np.tile(
        np.stack(
            [np.arange(0, p, p // m), np.arange(p // m, p + 1, p // m)],
            axis=1,
        ),
        (nq, 1),
    )
    lo = offs[rows_p, cols[:, 0:1]]
    hi = offs[rows_p, cols[:, 1:2]]
    sr2, rm2, ab2, dst2 = plan_tables(
        row_start, indptr, rows_p, coeff_p, nb, block, lo=lo, hi=hi
    )
    dlim = (
        np.stack([bounds[cols[:, 0]], bounds[cols[:, 1]]], axis=1)
        .astype(np.int32)
        .reshape(nq * m, 1, 2)
    )
    tw = search_packed_tables(
        jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(sr2),
        jnp.asarray(rm2), jnp.asarray(ab2), jnp.float32(scale),
        jnp.float32(clip), jnp.int32(0), n_blocks=nb, block=block,
        s=s, k=k, n_docs=n_docs, dlim=jnp.asarray(dlim),
    )
    pv, pd = np.asarray(tw[0]), np.asarray(tw[1])
    e = expand_plan_tables(
        jnp.asarray(row_start.astype(np.int32)), jnp.asarray(indptr),
        jnp.asarray(rows_p), jnp.asarray(coeff_p.view(np.int32)),
        nb, block, offs_dev=jnp.asarray(offs), cols=jnp.asarray(cols),
    )
    for a, b_, name in zip((sr2, rm2, ab2, dst2), e, "sr rm ab dst".split()):
        np.testing.assert_array_equal(a, np.asarray(b_), name)
    for q in range(nq):
        vs = pv[q * m : (q + 1) * m].ravel()
        ds = pd[q * m : (q + 1) * m].ravel()
        order = np.lexsort((ds, -vs.astype(np.int64)))[:k]
        mv, md = vs[order], ds[order]
        md = np.where(mv > 0, md, -1)
        mv = np.where(mv > 0, mv, -1)
        np.testing.assert_array_equal(mv, rv[q], f"q{q} vals")
        np.testing.assert_array_equal(
            md, np.where(rv[q] > 0, rd[q], -1), f"q{q} docs"
        )


def test_split_engine_matches_oracle_multisegment():
    """The full serving path with split_rows forced low (every real
    query splits) must stay bit-identical to the oracle AND to the
    unsplit engine — across incremental segments, deletes, and the
    preplan-seeded layout path (both scorings)."""
    from document_search_engine_tpu.corpus.synth import (
        synth_corpus,
        synth_queries,
    )
    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.oracle.oracle import OracleEngine

    docs = synth_corpus(n_docs=700, vocab_size=250, mean_len=35, seed=51)
    queries = synth_queries(docs, n_queries=16, terms_per_query=4, seed=52)
    for kind in ("bm25", "tfidf"):
        cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
        orc = OracleEngine(cfg)
        orc.build(docs[:500])
        orc.add_docs(docs[500:])
        orc.delete_docs(list(range(40, 80)))
        oid, osc = orc.search(queries, k=10)

        eng = SearchEngine(cfg)
        eng.block_families = SPLIT_FAMILIES
        eng.auto_compact_segments = None  # keep 2 segments alive
        eng.split_rows = 2
        eng.build(docs[:500])
        eng.add_docs(docs[500:])
        eng.delete_docs(list(range(40, 80)))
        eng.preplan([queries], k=10)  # seeded layout path, same key
        ids, sc = eng.search(queries, k=10)
        np.testing.assert_array_equal(np.asarray(ids), np.asarray(oid), kind)
        np.testing.assert_array_equal(np.asarray(sc), np.asarray(osc), kind)
        assert eng.plan_cache.hits >= 1, "preplan seeding missed"


def test_split_mixed_population_thresholds():
    """Mixed split/unsplit populations in the same batch (realistic
    thresholds leave light queries whole): bit-identity vs the unsplit
    engine across several thresholds."""
    from document_search_engine_tpu.corpus.synth import (
        synth_corpus,
        synth_queries,
    )
    from document_search_engine_tpu.engine.engine import SearchEngine

    docs = synth_corpus(n_docs=900, vocab_size=300, mean_len=45, seed=81)
    queries = synth_queries(docs, n_queries=24, terms_per_query=5, seed=82)
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    base = SearchEngine(cfg)
    base.block_families = SPLIT_FAMILIES
    base.build(docs)
    bid, bsc = base.search(queries, k=10)
    for thr in (4, 16):
        eng = SearchEngine(cfg)
        eng.block_families = SPLIT_FAMILIES
        eng.split_rows = thr
        eng.build(docs)
        ids, sc = eng.search(queries, k=10)
        np.testing.assert_array_equal(
            np.asarray(ids), np.asarray(bid), f"thr={thr}"
        )
        np.testing.assert_array_equal(
            np.asarray(sc), np.asarray(bsc), f"thr={thr}"
        )


def test_split_with_empty_vocab_segment():
    """A term-less segment (T = 0, no quantile table) inside a
    split-enabled engine: it takes the unsplit plan but must still
    contribute aligned default quantile columns to the batch staging."""
    from document_search_engine_tpu.corpus.synth import (
        synth_corpus,
        synth_queries,
    )
    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.oracle.oracle import OracleEngine

    docs = synth_corpus(n_docs=300, vocab_size=150, mean_len=25, seed=91)
    queries = synth_queries(docs, n_queries=8, terms_per_query=3, seed=92)
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    orc = OracleEngine(cfg)
    orc.build(docs)
    orc.add_docs(["", "  ", ""])
    eng = SearchEngine(cfg)
    eng.block_families = SPLIT_FAMILIES
    eng.split_rows = 2
    eng.auto_compact_segments = None
    eng.build(docs)
    eng.add_docs(["", "  ", ""])
    oid, osc = orc.search(queries, k=10)
    ids, sc = eng.search(queries, k=10)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(oid))
    np.testing.assert_array_equal(np.asarray(sc), np.asarray(osc))
