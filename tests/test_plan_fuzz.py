"""Fuzz the production staging path: random CSR shapes and query mixes
through plan_tables -> search_packed_tables (the XLA twin of the CUDA
kernel, consuming the identical plan) must match the gather-path
reference bit-for-bit; and the pipelined search_stream must equal plain
search on both engines."""
import jax.numpy as jnp
import numpy as np
import pytest

from document_search_engine_tpu.config import IndexConfig, ScoringConfig
from document_search_engine_tpu.corpus.synth import synth_corpus, synth_queries
from document_search_engine_tpu.engine.engine import SearchEngine
from document_search_engine_tpu.ops.plan import plan_tables
from document_search_engine_tpu.ops.packed import (
    search_packed,
    search_packed_tables,
    total_cap,
)
from document_search_engine_tpu.ops.schedule import block_plan
from test_packed import make_aligned


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5, 6])
def test_plan_tables_fuzz(seed):
    rng = np.random.default_rng(seed)
    n_terms = int(rng.integers(5, 60))
    n_docs = int(rng.integers(50, 4000))
    max_len = int(rng.integers(2, min(n_docs, 1500)))
    lens = rng.integers(0, max_len, n_terms)  # includes empty rows
    indptr64 = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr64[1:])
    nnz = int(indptr64[-1])
    parts = [
        np.sort(rng.choice(n_docs, size=l, replace=False).astype(np.int32))
        for l in lens
    ]
    post_doc = (
        np.concatenate(parts) if parts else np.zeros(0, np.int32)
    )
    post_val = rng.random(nnz, dtype=np.float32) * 0.9 + 0.05
    indptr = indptr64.astype(np.int32)
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    nq = int(rng.integers(1, 9))
    s = int(rng.integers(1, 7))
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = rng.random((nq, s)).astype(np.float32) * 2.0
    coeff[rng.random((nq, s)) < 0.25] = 0.0  # missing slots
    block = int(rng.choice([256, 512, 1024, 2048]))
    k = int(rng.choice([1, 3, 10, 25]))
    scale, clip = jnp.float32(2.0**16), jnp.float32(65075262)
    found = coeff > 0
    nb = block_plan(indptr, rows, found, block=block)
    # gather-path reference
    c = total_cap(indptr, rows, found)
    pd = np.concatenate([post_doc, np.full(block, n_docs, np.int32)])
    pv = np.concatenate([post_val, np.zeros(block, np.float32)])
    ref = search_packed(
        jnp.asarray(indptr), jnp.asarray(pd), jnp.asarray(pv),
        jnp.asarray(rows), jnp.asarray(coeff), scale, clip,
        jnp.int32(0), c_total=c, k=k, n_docs=n_docs,
    )
    sr, rm, ab, dst = plan_tables(row_start, indptr, rows, coeff, nb, block)
    # device-side expansion must equal the host planner bit-for-bit
    from document_search_engine_tpu.ops.plan import expand_plan_tables

    sr_d, rm_d, ab_d, dst_d = expand_plan_tables(
        jnp.asarray(row_start.astype(np.int32)), jnp.asarray(indptr),
        jnp.asarray(rows), jnp.asarray(coeff.view(np.int32)), nb, block,
    )
    np.testing.assert_array_equal(np.asarray(sr_d), sr, f"srcrow {seed}")
    np.testing.assert_array_equal(np.asarray(rm_d), rm, f"rem {seed}")
    np.testing.assert_array_equal(np.asarray(ab_d), ab, f"abits {seed}")
    np.testing.assert_array_equal(np.asarray(dst_d), dst, f"dstrow {seed}")
    got = search_packed_tables(
        jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(sr),
        jnp.asarray(rm), jnp.asarray(ab), scale, clip, jnp.int32(0),
        n_blocks=nb, block=block, s=s, k=k, n_docs=n_docs,
    )
    np.testing.assert_array_equal(
        np.asarray(got[0]), np.asarray(ref[0]), f"vals seed={seed}"
    )
    np.testing.assert_array_equal(
        np.asarray(got[1]), np.asarray(ref[1]), f"gids seed={seed}"
    )


def test_search_stream_equals_search():
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    docs = synth_corpus(n_docs=90, vocab_size=400, mean_len=25, seed=71)
    queries = synth_queries(docs, n_queries=11, seed=72) + ["", "zzz"]
    batches = [queries[0:4], queries[4:5], [], queries[5:]]
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    for eng in (
        SearchEngine(cfg),
        DistributedSearchEngine(cfg, mesh=make_mesh(4)),
    ):
        eng.build(docs)
        ref_i, ref_s = eng.search(queries, k=10)
        got = list(eng.search_stream(batches, k=10, depth=2))
        gi = np.concatenate([g[0] for g in got])
        gs = np.concatenate([g[1] for g in got])
        np.testing.assert_array_equal(gi, ref_i, type(eng).__name__)
        np.testing.assert_array_equal(gs, ref_s, type(eng).__name__)


def test_search_stream_mutation_mid_stream():
    """Regression (review finding): the analysis-prefetch thread
    snapshots stats up to 2 batches ahead; mutating the engine while
    consuming the stream must re-analyze against the mutated state, not
    pair stale row indices with the new vocabulary."""
    from document_search_engine_tpu.parallel.dist import (
        DistributedSearchEngine,
    )
    from document_search_engine_tpu.parallel.mesh import make_mesh

    docs = synth_corpus(n_docs=80, vocab_size=300, mean_len=25, seed=77)
    queries = synth_queries(docs, n_queries=12, seed=78)
    batches = [queries[0:4], queries[4:8], queries[8:12]]
    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    for make in (
        lambda: SearchEngine(cfg),
        lambda: DistributedSearchEngine(cfg, mesh=make_mesh(4)),
    ):
        eng = make()
        eng.build(docs)
        gen = eng.search_stream(batches, k=5, depth=1)
        first = next(gen)  # batches 0-1 already prefetched at old stats
        # mutate: delete docs + force compact (new vocab, new stats)
        eng.delete_docs([1, 7, 30])
        eng.compact()
        rest = list(gen)
        # remaining batches must equal fresh searches on the MUTATED
        # engine (prefetched analysis must have been recomputed)
        want1 = eng.search(batches[1], k=5)
        want2 = eng.search(batches[2], k=5)
        np.testing.assert_array_equal(rest[0][0], want1[0])
        np.testing.assert_array_equal(rest[0][1], want1[1])
        np.testing.assert_array_equal(rest[1][0], want2[0])
        np.testing.assert_array_equal(rest[1][1], want2[1])
        # the pre-mutation batch reflected the pre-mutation engine
        fresh = make()
        fresh.build(docs)
        w0 = fresh.search(batches[0], k=5)
        np.testing.assert_array_equal(first[0], w0[0])
        np.testing.assert_array_equal(first[1], w0[1])
