"""GPU chip tests: the hardware contracts the CPU suite cannot check.

Run on a machine with an NVIDIA GPU:
    JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/test_chip.py -q
Elsewhere they skip; the `gpu` fixture decides when a test runs, never
at import. chip_smoke.py runs the same checks at 20-Newsgroups scale.
"""
import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


def _bm25():
    from document_search_engine_tpu.config import IndexConfig, ScoringConfig

    return IndexConfig(scoring=ScoringConfig(kind="bm25"))


def test_topk_tie_stability_on_gpu(gpu):
    cs.check_topk_ties(rows=8)


def test_engine_oracle_parity_on_gpu(gpu):
    """Both scorers, both scorings, k > 128, split, add/delete/compact,
    save/load, rerank and the 1-device SPMD engine vs the oracle."""
    cs.check_oracle_parity(n_docs=700, vocab=3000, mean_len=40, nq=32)


def test_split_parity_on_gpu(gpu):
    """Doc-range splitting through the CUDA kernel's doc limits."""
    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.oracle import OracleEngine

    docs = cs.zipf_corpus(500, 800, 30, seed=101)
    queries = cs.sample_queries(docs, 12, 4, seed=102)
    ora = OracleEngine(_bm25())
    ora.build(docs)
    eng = SearchEngine(_bm25())
    eng.build(docs)
    eng.split_rows = 2
    cs.same("split_rows=2", eng.search(queries, k=10),
            ora.search(queries, k=10))


def test_exact_div_on_gpu(gpu):
    cs.check_exact_div(1 << 20)


def test_kernel_matches_twin_on_gpu(gpu):
    cs.check_kernel_vs_twin()


def test_rerank_on_gpu(gpu):
    """Hybrid rerank on the GPU: deterministic and drawn from the
    lexical candidate pool."""
    from document_search_engine_tpu.engine.engine import SearchEngine

    docs = cs.zipf_corpus(100, 500, 30, seed=91)
    queries = cs.sample_queries(docs, 5, 3, seed=92)
    eng = SearchEngine(_bm25())
    eng.build(docs)
    ids, ri, _ = eng.search_rerank(queries, k=10, candidates=32)
    ids2, ri2, _ = eng.search_rerank(queries, k=10, candidates=32)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(ri, ri2)
    pool_ids, _ = eng.search(queries, k=32)
    for row in range(len(queries)):
        got = {i for i in ids[row].tolist() if i >= 0}
        assert got <= {i for i in pool_ids[row].tolist() if i >= 0}


def test_sharded_step_on_gpu(gpu):
    """The SPMD step on every visible GPU (the CUDA kernel inside
    shard_map) == the single-process engine, search and rerank."""
    import jax

    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    docs = cs.zipf_corpus(90, 500, 30, seed=81)
    queries = cs.sample_queries(docs, 6, 3, seed=82)
    single = SearchEngine(_bm25())
    single.build(docs)
    dist = DistributedSearchEngine(_bm25(), mesh=make_mesh(len(jax.devices())))
    dist.build(docs)
    assert dist.scorer_mode == "fused"
    cs.same("sharded", dist.search(queries, k=10), single.search(queries, k=10))
    cs.same(
        "sharded rerank",
        dist.search_rerank(queries, k=8, candidates=24),
        single.search_rerank(queries, k=8, candidates=24),
    )
