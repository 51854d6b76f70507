"""Host-side serving-path profile at bench scale, no accelerator needed.

Every host-side millisecond in the serving loop that the
search_stream prefetch thread does not overlap adds to the public-API
number. This tool isolates that host cost: it monkeypatches
`_batch_step` to return a correctly-shaped dummy (and plans as the
GPU's fused scorer does), then
times `analyze -> _dispatch -> _collect` per 8192-query batch on the
CPU backend at the exact bench index/query shapes, plus a cProfile of
the dispatch to name the hotspots.

Run: JAX_PLATFORMS=cpu python tools/host_profile.py
Env: HP_DOCS (1M), HP_NQ (8192), HP_ITERS (16), HP_SPLIT ('' = off),
HP_PROFILE (1 = print cProfile top), BENCH_* geometry knobs reused.
"""
from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np


def log(msg):
    print(msg, flush=True)


def main():
    from document_search_engine_tpu.config import IndexConfig, ScoringConfig
    from document_search_engine_tpu.engine import engine as engine_mod

    import bench as B

    n_docs = int(os.environ.get("HP_DOCS", 1_000_000))
    vocab = int(os.environ.get("HP_VOCAB", 200_000))
    nq = int(os.environ.get("HP_NQ", 8192))
    tpq = int(os.environ.get("HP_TPQ", 8))
    iters = int(os.environ.get("HP_ITERS", 16))
    split = os.environ.get("HP_SPLIT", "")
    k = 10

    cfg = IndexConfig(scoring=ScoringConfig(kind="bm25"))
    t0 = time.perf_counter()
    eng, df_by_row, tokens_by_row = B.build_synth_engine(
        n_docs, vocab, 60, cfg, seed=1
    )
    from document_search_engine_tpu.ops import fused_cuda

    # plan exactly as the GPU default does; the step itself is stubbed
    fused_cuda.resolve_scorer = lambda scorer, platform: "fused"
    if split:
        eng.split_rows = int(split)
    log(f"[build {time.perf_counter()-t0:.1f}s]")

    rng = np.random.default_rng(7)
    eligible = np.where((df_by_row >= 64) & (df_by_row <= 32768))[0]
    rows = rng.choice(eligible, size=(nq, tpq))
    batch = [" ".join(tokens_by_row[r] for r in qr) for qr in rows]

    real_step = engine_mod._batch_step

    def fake_step(*a, **kw):
        return np.ones((kw["n_real"], 2 * kw["k"]), np.int32)

    # --- phase 1: analysis (the native frontend; analyze_rows is the
    # production search/search_stream entry — it returns rows/found so
    # _dispatch skips the per-batch segment_rows searchsorted)
    best_an = min(
        _t(lambda: eng.frontend.analyze_rows(batch, eng.stats))
        for _ in range(iters)
    )
    pre = eng.frontend.analyze_rows(batch, eng.stats)

    # --- phase 2+3: plan/stage (dispatch) and assemble (collect),
    # device compute replaced by a shaped dummy
    engine_mod._batch_step = fake_step
    try:
        eng._dispatch(pre[0], pre[1], k, pre[2], pre[3])  # converge the plan cache first
        best_di = best_co = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fut = eng._dispatch(pre[0], pre[1], k, pre[2], pre[3])
            t1 = time.perf_counter()
            eng._collect(fut)
            t2 = time.perf_counter()
            best_di = min(best_di, t1 - t0)
            best_co = min(best_co, t2 - t1)
        if os.environ.get("HP_PROFILE", "1") == "1":
            pr = cProfile.Profile()
            pr.enable()
            for _ in range(4):
                eng._collect(eng._dispatch(pre[0], pre[1], k, pre[2], pre[3]))
            pr.disable()
            s = io.StringIO()
            pstats.Stats(pr, stream=s).sort_stats("cumulative").print_stats(
                24
            )
            log(s.getvalue())
    finally:
        engine_mod._batch_step = real_step

    tot = best_an + best_di + best_co
    log(
        f"host path per {nq}-query batch (best of {iters}):\n"
        f"  analyze  {best_an*1e3:7.2f} ms\n"
        f"  dispatch {best_di*1e3:7.2f} ms (plan + stage + H2D-create)\n"
        f"  collect  {best_co*1e3:7.2f} ms (D2H scatter + merge)\n"
        f"  TOTAL    {tot*1e3:7.2f} ms -> ceiling "
        f"{nq/tot:,.0f} q/s if device were free"
    )


def _t(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
