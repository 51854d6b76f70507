"""Oracle sanity: the frozen CPU reference behaves like a search engine.

These tests pin oracle behavior; the engine parity gate (test_parity.py)
then pins the device engine to the oracle bit-for-bit (BASELINE.json:5).
"""
import numpy as np

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.oracle import OracleEngine, spec


def test_idf_tables():
    t = spec.idf_table("tfidf", 100, 100)
    assert t.dtype == np.float32
    assert t[0] == 0.0
    assert t[100] == np.float32(0.0)  # ln(100/100)
    assert np.all(np.diff(t[1:]) <= 0)  # idf decreasing in df
    b = spec.idf_table("bm25", 100, 100)
    assert np.all(b[1:] > 0)
    assert np.all(np.diff(b[1:]) <= 0)


def test_quantize_determinism_and_clip():
    c = np.array([0.5, 1e9, 0.0, 1e-12], dtype=np.float32)
    q = spec.quantize_contrib(c, 25, 32)
    assert q.dtype == np.int32
    assert q[0] == 2**24
    assert q[1] == int(spec.quant_clip_max(32))
    assert q[2] == 0
    # no-overflow invariant: S_max * clip < 2^31
    assert 32 * int(spec.quant_clip_max(32)) < 2**31


def test_exact_match_ranks_first():
    docs = [
        "apple banana cherry",
        "apple apple apple banana",
        "dog cat mouse",
        "banana split dessert",
    ]
    for kind in ("tfidf", "bm25"):
        eng = OracleEngine(IndexConfig(scoring=ScoringConfig(kind=kind)))
        eng.build(docs)
        ids, scores = eng.search(["dog cat mouse"], k=2)
        assert ids[0, 0] == 2, kind
        assert scores[0, 0] > scores[0, 1]


def test_tie_break_by_doc_id():
    docs = ["same text here", "same text here", "other words entirely"]
    eng = OracleEngine()
    eng.build(docs)
    ids, scores = eng.search(["same text"], k=3)
    assert list(ids[0][:2]) == [0, 1]
    assert scores[0, 0] == scores[0, 1]


def test_delete_and_df_update():
    docs = ["red fish", "red dog", "blue fish"]
    eng = OracleEngine()
    eng.build(docs)
    ids, _ = eng.search(["red"], k=3)
    assert set(ids[0][:2].tolist()) == {0, 1}
    eng.delete_docs([0])
    ids, scores = eng.search(["red"], k=3)
    assert 0 not in ids[0].tolist()
    assert eng.df[eng.hasher("red")] == 1
    # doc 1 matches 'red', others score 0 or -1
    assert ids[0, 0] == 1


def test_delete_before_first_search():
    # Regression: deleting before any search left the dead doc's postings
    # iterable with no refreshed inv_norm -> KeyError (tfidf).
    for kind in ("tfidf", "bm25"):
        eng = OracleEngine(IndexConfig(scoring=ScoringConfig(kind=kind)))
        eng.build(["red fish", "red dog", "blue fish"])
        eng.delete_docs([0])
        ids, scores = eng.search(["red fish"], k=3)
        assert 0 not in ids[0].tolist(), kind
        assert ids[0, 0] >= 0


def test_empty_and_unknown_query():
    eng = OracleEngine()
    eng.build(["alpha beta", "gamma delta"])
    ids, scores = eng.search(["zzznotaterm", ""], k=2)
    # matching docs only (DESIGN.md §2): no match -> all slots empty
    assert list(ids[0]) == [-1, -1]
    assert list(scores[0]) == [-1, -1]
    assert list(ids[1]) == [-1, -1]


def test_synth_corpus_self_retrieval():
    docs = synth_corpus(n_docs=100, vocab_size=500, mean_len=30, seed=7)
    queries = synth_queries(docs, n_queries=10, terms_per_query=6, seed=9)
    for kind in ("tfidf", "bm25"):
        eng = OracleEngine(IndexConfig(scoring=ScoringConfig(kind=kind)))
        eng.build(docs)
        ids, scores = eng.search(queries, k=10)
        assert ids.shape == (10, 10)
        assert np.all(scores[:, 0] > 0)
        # scores non-increasing within each row (ignoring -1 padding)
        for r in range(10):
            s = scores[r][scores[r] >= 0]
            assert np.all(np.diff(s) <= 0)
