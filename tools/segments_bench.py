"""Multi-segment serving curve (round-3 VERDICT #7: the segment
lifecycle thresholds — auto_compact_segments=16, dead_frac=0.5 — were
chosen without measurement).

Builds the SAME corpus as 1, 2, 4, 8, 16 streaming segments (one
segment per add, auto-compact disabled so the configuration survives),
then times the public serving loop at each count. Every (segment x
bucket) pair adds an unrolled sub-program to the fused batch step, so
this measures what segment fragmentation actually costs per query and
how the compiled-program size grows — the data the lifecycle defaults
should come from.

Run on the GPU: python tools/segments_bench.py
Env: SEG_DOCS (96000), SEG_VOCAB (30000), SEG_NQ (8192), SEG_ITERS
(16), SEG_COUNTS (1,2,4,8,16), SEG_KIND (bm25).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from document_search_engine_tpu.utils.cache import enable_persistent_cache


def log(msg):
    print(msg, flush=True)


def main():
    enable_persistent_cache()
    import jax

    from document_search_engine_tpu.config import IndexConfig, ScoringConfig
    from document_search_engine_tpu.corpus.synth import (
        synth_corpus,
        synth_queries,
    )
    from document_search_engine_tpu.engine.engine import SearchEngine

    n_docs = int(os.environ.get("SEG_DOCS", 96000))
    vocab = int(os.environ.get("SEG_VOCAB", 30000))
    nq = int(os.environ.get("SEG_NQ", 8192))
    iters = int(os.environ.get("SEG_ITERS", 16))
    counts = [
        int(c)
        for c in os.environ.get("SEG_COUNTS", "1,2,4,8,16").split(",")
    ]
    kind = os.environ.get("SEG_KIND", "bm25")
    k, depth = 10, 8

    log(f"platform: {jax.devices()[0].platform} x{len(jax.devices())}")
    t0 = time.perf_counter()
    docs = synth_corpus(
        n_docs=n_docs, vocab_size=vocab, mean_len=120, seed=11
    )
    queries = synth_queries(docs, n_queries=nq, terms_per_query=8, seed=12)
    log(f"corpus: {n_docs} docs vocab~{vocab} + {nq} queries "
        f"({time.perf_counter()-t0:.1f}s)")
    batches = [queries]  # one canonical batch shape, reused

    results = {}
    ref_ids = ref_sc = None
    for n_seg in counts:
        cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
        eng = SearchEngine(cfg)
        eng.auto_compact_segments = None  # keep the fragmentation
        eng.auto_compact_dead_frac = None
        chunk = -(-n_docs // n_seg)
        t0 = time.perf_counter()
        eng.build_streaming(
            docs[i : i + chunk] for i in range(0, n_docs, chunk)
        )
        t_build = time.perf_counter() - t0
        assert len(eng.segments) == n_seg, len(eng.segments)
        t0 = time.perf_counter()
        eng.preplan(batches, k=k)
        ids = sc = None
        for ids, sc in eng.search_stream(iter(batches), k=k, depth=depth):
            pass
        t_warm = time.perf_counter() - t0
        # fragmentation must not change results (global df refresh)
        if ref_ids is None:
            ref_ids, ref_sc = ids, sc
        else:
            assert np.array_equal(ids, ref_ids) and np.array_equal(
                sc, ref_sc
            ), f"{n_seg}-segment results diverged"
        best = 0.0
        for _p in range(2):
            t0 = time.perf_counter()
            n_out = 0
            for ids, _s in eng.search_stream(
                (batches[0] for _ in range(iters)), k=k, depth=depth
            ):
                n_out += len(ids)
            dt = time.perf_counter() - t0
            assert n_out == nq * iters
            best = max(best, nq * iters / dt)
        results[n_seg] = best
        log(
            f"segments={n_seg:>2}: {best:,.0f} q/s "
            f"(build {t_build:.1f}s, compile+warmup {t_warm:.1f}s, "
            f"plan cache: {eng.plan_cache.stats()})"
        )
        del eng

    base = results.get(counts[0], 1.0)
    log("curve: " + json.dumps(
        {str(n): round(q, 1) for n, q in results.items()}
    ))
    log("relative: " + ", ".join(
        f"{n}seg={results[n]/base*100:.0f}%" for n in counts
    ))


if __name__ == "__main__":
    main()
