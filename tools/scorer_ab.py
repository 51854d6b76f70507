"""Kernel against twin on one GPU: does the CUDA fused kernel beat the
XLA twin, per bucket and end to end?

Builds chip_smoke.py's 1M-doc index (bm25, 8-term queries, batches of
16,384) once through SearchEngine.build, then in one process measures:

1. per bucket of one batch's kernel plan (FUSED_FAMILIES, compacted
   r_c), the device time of the kernel and of the twin on the SAME
   expanded plan tables;
2. the device step of a whole staged batch, each scorer with its own
   plan ("fused": kernel buckets + twin for the rest; "xla": the twin's
   DEFAULT_FAMILIES plan);
3. search_stream q/s over raw text, each scorer, in turns
   (fused, xla, xla, fused, ...), AB_REPS passes each.

Every time is the median of its repetitions with the spread (min, max).
Run: python tools/scorer_ab.py  (AB_REPS, default 5; AB_DOCS, 1000000)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def log(*a):
    print(*a, flush=True)


def timed(fn, reps):
    """(median, min, max) seconds of fn() over reps runs, each ending in
    a device sync."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(min(ts)), float(max(ts))


def capture_step(eng, queries, k):
    """The _batch_step arguments of one dispatch of `queries`."""
    from document_search_engine_tpu.engine import engine as engine_mod

    real = engine_mod._batch_step
    seen = {}

    def capture(*a, **kw):
        seen["a"], seen["kw"] = a, kw
        return real(*a, **kw)

    engine_mod._batch_step = capture
    try:
        eng.search(queries, k=k)
    finally:
        engine_mod._batch_step = real
    return real, seen["a"], seen["kw"]


def main() -> int:
    import chip_smoke as cs

    reps = int(os.environ.get("AB_REPS", 5))
    cs.MAIN["n_docs"] = int(os.environ.get("AB_DOCS", cs.MAIN["n_docs"]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    import jax
    import jax.numpy as jnp

    assert jax.devices()[0].platform == "gpu", jax.devices()
    from document_search_engine_tpu.config import IndexConfig, ScoringConfig
    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.ops.fused_cuda import (
        fused_search_cuda,
        kernel_takes,
    )
    from document_search_engine_tpu.ops.packed import search_packed_tables
    from document_search_engine_tpu.ops.plan import expand_plan_tables
    from document_search_engine_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    log(f"card: {card}")
    docs, batches = cs.main_corpus()
    k = cs.MAIN["k"]
    eng = SearchEngine(IndexConfig(scoring=ScoringConfig(kind="bm25")))
    t0 = time.perf_counter()
    eng.build(docs)
    log(f"build {time.perf_counter() - t0:.1f} s")
    del docs
    out = {"card": card, "reps": reps, "buckets": [], "step": {},
           "stream": {}}

    # 1. per bucket, same plan tables
    eng.scorer = "fused"
    step, args, kw = capture_step(eng, batches[0], k)
    (post_docs, post_vals, _bases, indptrs, row_starts, rows_cat,
     cbits_cat) = args[:7]
    off = 0
    for _n_docs, s, buckets in kw["plan"]:
        for n_blocks, block, bq, r_c in buckets:
            rows_b = rows_cat[off : off + bq]
            cbits_b = cbits_cat[off : off + bq]
            off += bq
            sr, rm, ab, dst = jax.jit(
                expand_plan_tables, static_argnums=(4, 5)
            )(row_starts[0], indptrs[0], rows_b, cbits_b, n_blocks, block)
            pd, pv = post_docs[0], post_vals[0]
            twin = jax.jit(
                lambda pd, pv, sr, rm, ab, nb=n_blocks, blk=block, s=s,
                nd=_n_docs: search_packed_tables(
                    pd, pv, sr, rm, ab, jnp.float32(kw["scale"]),
                    jnp.float32(kw["clip"]), jnp.int32(0), n_blocks=nb,
                    block=blk, s=s, k=k, n_docs=nd,
                )
            )
            row = {"bq": bq, "r_c": r_c, "n_blocks": n_blocks,
                   "block": block,
                   "twin_ms": [x * 1e3 for x in
                               timed(lambda: twin(pd, pv, sr, rm, ab),
                                     reps)]}
            if kernel_takes(r_c, k):
                kern = jax.jit(
                    lambda pd, pv, sr, rm, ab, dst, blk=block, rc=r_c,
                    nd=_n_docs: fused_search_cuda(
                        pd, pv, sr, rm, ab, dst, block=blk, k=k,
                        n_docs=nd, r_c=rc, scale=kw["scale"],
                        clip=kw["clip"],
                    )
                )
                row["kernel_ms"] = [
                    x * 1e3
                    for x in timed(
                        lambda: kern(pd, pv, sr, rm, ab, dst), reps
                    )
                ]
            out["buckets"].append(row)
            log(f"bucket bq={bq} r_c={r_c} n_blocks={n_blocks}: twin "
                f"{row['twin_ms'][0]:.3f} ms, kernel "
                f"{row.get('kernel_ms', ['(twin)'])[0]}")

    # 2. whole staged batch, each scorer with its own plan
    for mode in ("fused", "xla"):
        eng.scorer = mode
        step, args, kw = capture_step(eng, batches[0], k)
        med, lo, hi = timed(lambda: step(*args, **kw), reps)
        out["step"][mode] = {"ms": [med * 1e3, lo * 1e3, hi * 1e3],
                             "qps": len(batches[0]) / med}
        log(f"step {mode}: {med * 1e3:.2f} ms median "
            f"({lo * 1e3:.2f}..{hi * 1e3:.2f}) per batch of "
            f"{len(batches[0])} -> {len(batches[0]) / med:,.0f} q/s")

    # 3. end to end over raw text, in turns
    for mode in ("fused", "xla"):
        eng.scorer = mode
        eng.preplan(batches, k=k)
        for _ in eng.search_stream(iter(batches), k=k, depth=2):
            pass
    runs = {"fused": [], "xla": []}
    order = ["fused", "xla", "xla", "fused"] * ((reps + 1) // 2)
    for mode in order[: 2 * reps]:
        eng.scorer = mode
        t0 = time.perf_counter()
        for _ in eng.search_stream(iter(batches), k=k, depth=2):
            pass
        dt = time.perf_counter() - t0
        runs[mode].append(len(batches) * len(batches[0]) / dt)
        log(f"stream {mode}: {runs[mode][-1]:,.0f} q/s")
    for mode, qs in runs.items():
        out["stream"][mode] = {"median": float(np.median(qs)),
                               "min": min(qs), "max": max(qs), "runs": qs}
        log(f"stream {mode}: median {np.median(qs):,.0f} q/s "
            f"({min(qs):,.0f}..{max(qs):,.0f}, {len(qs)} passes)")
    log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
