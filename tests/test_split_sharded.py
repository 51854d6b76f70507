"""Doc-range splitting inside the SPMD engine: the piece structure is
fleet-uniform (replicated plan), while every shard's record ranges and
doc limits come from its OWN resident quantile table — each (shard,
piece) covers a disjoint local doc range, so the all-gather merge over
shards plus the host merge over pieces must equal the unsplit ranking
bit for bit (the same argument as the segment/shard merges)."""
import numpy as np
import pytest

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import SearchEngine
from document_search_engine_tpu.index import builder as B
from document_search_engine_tpu.oracle import OracleEngine
from document_search_engine_tpu.parallel.dist import DistributedSearchEngine
from document_search_engine_tpu.parallel.mesh import make_mesh

SPLIT_FAMILIES = ((None, 512),)  # splitting needs one block family

@pytest.fixture(scope="module")
def corpus():
    docs = synth_corpus(n_docs=120, vocab_size=400, mean_len=40, seed=61)
    queries = synth_queries(docs, n_queries=10, terms_per_query=4, seed=62)
    queries += ["", "zzzunknown"]
    return docs, queries


def test_sharded_quantile_tables_match_host(corpus):
    """The ONE-SPMD-job per-shard quantile tables (global row space,
    per-shard local thresholds) == host_row_doc_quantiles over each
    shard's local CSR scattered to global rows — including the all-zero
    rows of terms the shard lacks."""
    docs, _ = corpus
    dist = DistributedSearchEngine(mesh=make_mesh(4))
    # host-side build so each shard RETAINS flat host postings for the
    # reference below (the device build keeps planes in HBM only); the
    # SPMD quantile job reads the same resident planes either way
    dist.device_build = False
    dist.build(docs)
    idx = dist.index
    offs_h, offs_d, n_loc_d = dist._doc_quantiles()
    p = B.SPLIT_QUANTILES
    assert offs_h.shape == (idx.n_shards, idx.t_pad, p + 1)
    for i, h in enumerate(idx.hosts):
        ref = np.zeros((idx.t_pad, p + 1), np.int32)
        if h.n_terms:
            loc = B.host_row_doc_quantiles(
                h.indptr, h.post_doc, p, h.n_docs
            )
            gmap = np.searchsorted(idx.stats.vocab, h.term_hash)
            ref[gmap] = loc
        np.testing.assert_array_equal(offs_h[i], ref, f"shard {i}")
    # cached by identity: a second call returns the same objects
    again = dist._doc_quantiles()
    assert again[0] is offs_h and again[1] is offs_d


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_split_invariance(corpus, n_shards):
    """split_rows forced low (every real query splits): the SPMD engine
    must stay bit-identical to the unsplit SPMD engine, the split single
    engine, and the oracle — for every shard count."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    orc = OracleEngine(cfg)
    orc.build(docs)
    oid, osc = orc.search(queries, k=10)

    base = DistributedSearchEngine(cfg, mesh=make_mesh(n_shards))
    base.block_families = SPLIT_FAMILIES
    base.build(docs)
    bid, bsc = base.search(queries, k=10)
    np.testing.assert_array_equal(bid, oid)
    np.testing.assert_array_equal(bsc, osc)

    dist = DistributedSearchEngine(cfg, mesh=make_mesh(n_shards))
    dist.block_families = SPLIT_FAMILIES
    dist.split_rows = 2
    dist.build(docs)
    d_ids, d_scores = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, oid)
    np.testing.assert_array_equal(d_scores, osc)


def test_sharded_split_mixed_thresholds_and_stream(corpus):
    """Realistic thresholds (mixed split/unsplit populations in one
    batch) through search_stream with a preplan-seeded layout; also
    pins the default two-family twin plan, which never splits
    (_split_active needs one block family), against the split one."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="tfidf"))
    single = SearchEngine(cfg)
    single.build(docs)
    r_ids, r_scores = single.search(queries, k=10)
    for thr in (4, 16):
        dist = DistributedSearchEngine(cfg, mesh=make_mesh(2))
        dist.block_families = SPLIT_FAMILIES
        dist.split_rows = thr
        dist.build(docs)
        dist.preplan([queries], k=10)
        outs = list(dist.search_stream([queries[:6], queries[6:]], k=10))
        d_ids = np.concatenate([o[0] for o in outs])
        d_scores = np.concatenate([o[1] for o in outs])
        np.testing.assert_array_equal(d_ids, r_ids, f"thr={thr}")
        np.testing.assert_array_equal(d_scores, r_scores, f"thr={thr}")
        assert dist.plan_cache.hits >= 1, "preplan seeding missed"


def test_sharded_split_incremental_updates(corpus):
    """add_docs/delete_docs swap the plane objects: the quantile cache
    must invalidate and the split engine must stay bit-identical to the
    (unsplit) single engine through the updates."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    single = SearchEngine(cfg)
    single.build(docs[:90])
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(2))
    dist.block_families = SPLIT_FAMILIES
    dist.split_rows = 2
    dist.build(docs[:90])
    # populate the quantile cache, then mutate the index
    dist.search(queries[:2], k=5)
    single.add_docs(docs[90:])
    dist.add_docs(docs[90:])
    single.delete_docs(list(range(10, 30)))
    dist.delete_docs(list(range(10, 30)))
    r_ids, r_scores = single.search(queries, k=10)
    d_ids, d_scores = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_scores, r_scores)
