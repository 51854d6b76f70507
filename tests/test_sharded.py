"""Sharding invariance (SURVEY.md §4 "multi-chip without a cluster"):
on an 8-virtual-device CPU mesh, the sharded engine must return rankings
bit-identical to the single-device engine and the oracle, for every shard
count — the fixed-point scoring spec (DESIGN.md §2) makes this exact."""
import numpy as np
import pytest

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import SearchEngine
from document_search_engine_tpu.oracle import OracleEngine
from document_search_engine_tpu.parallel.dist import DistributedSearchEngine
from document_search_engine_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def corpus():
    docs = synth_corpus(n_docs=90, vocab_size=600, mean_len=35, seed=11)
    queries = synth_queries(docs, n_queries=9, terms_per_query=5, seed=12)
    queries += ["", "zzzunknown"]
    return docs, queries


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_count_invariance(corpus, kind, n_shards):
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    ref = SearchEngine(cfg)
    ref.build(docs)
    r_ids, r_scores = ref.search(queries, k=10)

    dist = DistributedSearchEngine(cfg, mesh=make_mesh(n_shards))
    dist.build(docs)
    d_ids, d_scores = dist.search(queries, k=10)

    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_scores, r_scores)


def test_sharded_matches_oracle(corpus):
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    ora = OracleEngine(cfg)
    ora.build(docs)
    o_ids, o_scores = ora.search(queries, k=10)
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.build(docs)
    d_ids, d_scores = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, o_ids)
    np.testing.assert_array_equal(d_scores, o_scores)


@pytest.mark.parametrize("families", [((None, 4096),), ((None, 256),)])
@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_fused_kernel_invariance(corpus, families, n_shards):
    """The GPU serving plan inside shard_map — one block family of the
    kernel's 4096 (FUSED_FAMILIES), and a fine one — executed end to end
    through the XLA twin on the virtual CPU mesh, bit-identical to the
    single engine's default plan."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    ref = SearchEngine(cfg)
    ref.build(docs)
    r_ids, r_scores = ref.search(queries, k=10)

    dist = DistributedSearchEngine(cfg, mesh=make_mesh(n_shards))
    dist.block_families = families
    dist.build(docs)
    d_ids, d_scores = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_scores, r_scores)


def test_sharded_k_beyond_lane_width(corpus):
    """k > 128 exceeds the CUDA kernel's cap: the sharded step serves it
    through the XLA twin and stays bit-identical to the single engine."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    ref = SearchEngine(cfg)
    ref.build(docs)
    r_ids, r_scores = ref.search(queries, k=200)
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.block_families = ((None, 4096),)  # the kernel's plan
    dist.build(docs)
    d_ids, d_scores = dist.search(queries, k=200)
    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_scores, r_scores)


def test_more_shards_than_docs():
    docs = ["only one", "and two", "then three"]
    dist = DistributedSearchEngine(mesh=make_mesh(8))
    dist.build(docs)
    ids, scores = dist.search(["two", "three one"], k=3)
    assert ids[0, 0] == 1
    assert set(ids[1, :2].tolist()) == {0, 2}


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_sharded_incremental_matches_single(corpus, kind):
    """Sharded add/delete must stay bit-identical to the single-device
    engine (and hence the oracle) through incremental updates."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    single = SearchEngine(cfg)
    single.build(docs[:70])
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.build(docs[:70])

    ids_s = single.add_docs(docs[70:])
    ids_d = dist.add_docs(docs[70:])
    assert ids_s == ids_d
    r_ids, r_sc = single.search(queries, k=10)
    d_ids, d_sc = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_sc, r_sc)

    single.delete_docs([0, 35, 71, 89])
    dist.delete_docs([0, 35, 71, 89])
    r_ids, r_sc = single.search(queries, k=10)
    d_ids, d_sc = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_sc, r_sc)


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_sharded_delete_then_add_matches_single(corpus, kind):
    """Regression: add_docs after delete_docs must not resurrect
    tombstoned docs' df counts when rebuilding the last shard."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    single = SearchEngine(cfg)
    single.build(docs[:70])
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.build(docs[:70])
    # delete docs in several shards INCLUDING the last, then add
    single.delete_docs([2, 40, 65, 69])
    dist.delete_docs([2, 40, 65, 69])
    single.add_docs(docs[70:])
    dist.add_docs(docs[70:])
    r_ids, r_sc = single.search(queries, k=10)
    d_ids, d_sc = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_sc, r_sc)


def test_sharded_checkpoint_elastic_reshard(corpus, tmp_path):
    """Save on a 4-shard mesh, reload on 2 and 8 shards: results must be
    bit-identical (elastic resharding re-partitions contiguous doc
    ranges, carries tombstones, and recounts alive df)."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.build(docs)
    dist.delete_docs([1, 30, 88])
    ref_ids, ref_sc = dist.search(queries, k=10)
    path = str(tmp_path / "sharded_idx")
    dist.save(path)
    for n in (2, 4, 8):
        re = DistributedSearchEngine.load(path, mesh=make_mesh(n))
        ids, sc = re.search(queries, k=10)
        np.testing.assert_array_equal(ids, ref_ids, err_msg=f"{n} shards")
        np.testing.assert_array_equal(sc, ref_sc, err_msg=f"{n} shards")


def test_sharded_incremental_is_o_delta(corpus, monkeypatch):
    """Incremental updates must NOT re-assemble the whole sharded index:
    delete refreshes vals on device (postings stay resident), and an add
    that fits the padded shapes updates only the last shard's slabs.
    Results remain bit-identical to a from-scratch single engine."""
    import document_search_engine_tpu.parallel.dist as dist_mod

    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.build(docs[:80])
    pd_before = dist.index.post_doc

    def boom(*a, **kw):
        raise AssertionError("assemble_sharded called on O(delta) path")

    monkeypatch.setattr(dist_mod, "assemble_sharded", boom)
    dist.delete_docs([3, 41])
    # postings planes untouched by delete — same device arrays
    assert dist.index.post_doc is pd_before
    # an add whose terms already exist and whose postings fit the
    # aligned margin takes the in-place last-shard path
    dist.add_docs([docs[0]])
    ref = SearchEngine(cfg)
    ref.build(docs[:80])
    ref.delete_docs([3, 41])
    ref.add_docs([docs[0]])
    r_ids, r_sc = ref.search(queries, k=10)
    d_ids, d_sc = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_sc, r_sc)


def test_sharded_device_build_matches_host(corpus, tmp_path):
    """The jit device-side sharded build must produce identical results
    to the host build, survive incremental updates and a checkpoint
    round-trip (device-built shards re-derive host CSR on load)."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    dev = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    host = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dev.device_build, host.device_build = True, False
    dev.build(docs)
    host.build(docs)
    di, ds = dev.search(queries, k=10)
    hi, hs = host.search(queries, k=10)
    np.testing.assert_array_equal(di, hi)
    np.testing.assert_array_equal(ds, hs)
    dev.delete_docs([5, 60])
    host.delete_docs([5, 60])
    dev.add_docs(docs[:2])
    host.add_docs(docs[:2])
    di, ds = dev.search(queries, k=10)
    hi, hs = host.search(queries, k=10)
    np.testing.assert_array_equal(di, hi)
    np.testing.assert_array_equal(ds, hs)
    path = str(tmp_path / "dev_sharded")
    dev.save(path)
    re = DistributedSearchEngine.load(path, mesh=make_mesh(2))
    ri, rs = re.search(queries, k=10)
    np.testing.assert_array_equal(ri, di)
    np.testing.assert_array_equal(rs, ds)


def test_spmd_build_df_psum_matches_host_merge(corpus):
    """The one-SPMD-job build computes corpus-global df with
    jax.lax.psum over the docs axis (SURVEY.md §3b); it must equal the
    host vocab-union merge exactly."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.build(docs)  # device_build default -> build_sharded_spmd
    idx = dist.index
    assert idx.df_psum is not None
    tg = len(idx.stats.vocab)
    np.testing.assert_array_equal(idx.df_psum[:tg], idx.stats.df)
    assert (idx.df_psum[tg:] == 0).all()  # vocab padding rows count 0


def test_spmd_build_is_one_job(corpus, monkeypatch):
    """The sharded device build must not fall back to per-shard jit
    build jobs (round-2 VERDICT: build_sharded packed shards
    sequentially in a host loop)."""
    import document_search_engine_tpu.index.builder as builder_mod

    docs, _ = corpus

    def boom(*a, **kw):
        raise AssertionError("per-shard build_segment_device called")

    monkeypatch.setattr(builder_mod, "build_segment_device", boom)
    dist = DistributedSearchEngine(mesh=make_mesh(4))
    dist.build(docs)
    assert dist.index.df_psum is not None


@pytest.mark.parametrize("kind", ["tfidf", "bm25"])
def test_sharded_compact_drops_tombstones(corpus, kind):
    """DistributedSearchEngine.compact (round-2 VERDICT #5): postings of
    tombstoned docs are physically dropped on every shard, global ids
    stay stable, results bit-identical before/after."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    dist.build(docs)
    dead = [0, 17, 44, 70, 89]
    dist.delete_docs(dead)
    ref_ids, ref_sc = dist.search(queries, k=10)
    nnz_before = sum(int(h.indptr[-1]) for h in dist.index.hosts)
    dist.compact()
    nnz_after = sum(int(h.indptr[-1]) for h in dist.index.hosts)
    assert nnz_after < nnz_before  # tombstoned postings actually gone
    ids, sc = dist.search(queries, k=10)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(sc, ref_sc)
    assert not set(ids.ravel().tolist()) & set(dead)
    # compacted index keeps working through further updates
    dist.add_docs(docs[:3])
    single = SearchEngine(cfg)
    single.build(docs)
    single.delete_docs(dead)
    single.compact()
    single.add_docs(docs[:3])
    r_ids, r_sc = single.search(queries, k=10)
    d_ids, d_sc = dist.search(queries, k=10)
    np.testing.assert_array_equal(d_ids, r_ids)
    np.testing.assert_array_equal(d_sc, r_sc)


def test_sharded_build_streaming_equals_bulk(corpus):
    """Streaming sharded build == bulk sharded build, bit for bit."""
    from document_search_engine_tpu.corpus.loader import stream_batches

    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    bulk = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    bulk.build(docs)
    stream = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    stream.build_streaming(stream_batches(docs, batch_size=16))
    b_ids, b_sc = bulk.search(queries, k=10)
    s_ids, s_sc = stream.search(queries, k=10)
    np.testing.assert_array_equal(s_ids, b_ids)
    np.testing.assert_array_equal(s_sc, b_sc)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_rerank_matches_single(corpus, n_shards):
    """DistributedSearchEngine.search_rerank: candidates dotted by their
    owning shard, integer psum over the docs axis — results must be
    bit-identical to the single engine's rerank (exact-integer scheme)."""
    docs, queries = corpus
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    single = SearchEngine(cfg)
    single.build(docs)
    s_ids, s_ri, s_lex = single.search_rerank(queries, k=8, candidates=24)
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(n_shards))
    dist.build(docs)
    d_ids, d_ri, d_lex = dist.search_rerank(queries, k=8, candidates=24)
    np.testing.assert_array_equal(d_ids, s_ids)
    np.testing.assert_array_equal(d_ri, s_ri)
    np.testing.assert_array_equal(d_lex, s_lex)
    # still exact after an incremental update (embeddings re-derive)
    single.delete_docs([4, 61])
    dist.delete_docs([4, 61])
    s_ids, s_ri, s_lex = single.search_rerank(queries, k=8, candidates=24)
    d_ids, d_ri, d_lex = dist.search_rerank(queries, k=8, candidates=24)
    np.testing.assert_array_equal(d_ids, s_ids)
    np.testing.assert_array_equal(d_ri, s_ri)


def test_sharded_checkpoint_empty_engine(tmp_path):
    """Regression: saving a never-built engine and reloading on any mesh
    must round-trip to an empty engine, not crash in resharding."""
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    dist = DistributedSearchEngine(cfg, mesh=make_mesh(4))
    path = str(tmp_path / "empty_idx")
    dist.save(path)
    re = DistributedSearchEngine.load(path, mesh=make_mesh(2))
    assert re.index is None
    ids, sc = re.search(["anything"], k=5)
    assert (ids == -1).all() and (sc == -1).all()
