"""Randomized differential fuzz: engine(s) vs the frozen CPU oracle
across CONFIG dimensions the fixed tests don't fully compose — scoring
kind x k x block families x split_rows x shard count x a random lifecycle
(add/delete/compact/save-load) — asserting bit-identical ids AND
integer scores after every step.

The committed suite fuzzes the lifecycle at fixed configs
(tests/test_engine_features.py) and pins each feature pair separately;
this tool samples the full cross-product through the XLA twin. Run it
opportunistically on the CPU:

    JAX_PLATFORMS=cpu python tools/fuzz_differential.py        # 20 trials
    FUZZ_TRIALS=100 FUZZ_SEED=7 python tools/fuzz_differential.py

Exits nonzero on the first mismatch with a full repro line.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get(
    "XLA_FLAGS", ""
):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np


def one_trial(seed: int) -> str:
    from document_search_engine_tpu.config import IndexConfig, ScoringConfig
    from document_search_engine_tpu.corpus.synth import (
        synth_corpus,
        synth_queries,
    )
    from document_search_engine_tpu.engine.engine import SearchEngine
    from document_search_engine_tpu.oracle import OracleEngine

    rng = np.random.default_rng(seed)
    n_docs = int(rng.integers(30, 260))
    vocab = int(rng.integers(80, 900))
    mean_len = int(rng.integers(8, 60))
    kind = rng.choice(["tfidf", "bm25"])
    k = int(rng.choice([1, 3, 10, 37, 100]))
    families = [None, ((None, 1024),), ((None, 4096),)][
        int(rng.integers(0, 3))
    ]
    split = rng.choice([None, 2, 4, 16])
    n_shards = int(rng.choice([0, 0, 1, 2, 4]))  # 0 = single engine
    desc = (
        f"seed={seed} docs={n_docs} vocab={vocab} len={mean_len} "
        f"kind={kind} k={k} families={families} split={split} "
        f"shards={n_shards}"
    )

    docs = synth_corpus(
        n_docs=n_docs, vocab_size=vocab, mean_len=mean_len, seed=seed
    )
    queries = synth_queries(
        docs, n_queries=int(rng.integers(3, 12)),
        terms_per_query=int(rng.integers(1, 7)), seed=seed + 1,
    ) + ["", "qqqmissing zz"]

    cfg = IndexConfig(scoring=ScoringConfig(kind=kind))
    orc = OracleEngine(cfg)
    if n_shards:
        from document_search_engine_tpu.parallel.dist import (
            DistributedSearchEngine,
        )
        from document_search_engine_tpu.parallel.mesh import make_mesh

        eng = DistributedSearchEngine(cfg, mesh=make_mesh(n_shards))
    else:
        eng = SearchEngine(cfg)
    eng.block_families = families
    if split is not None:
        eng.split_rows = int(split)

    n0 = max(2, n_docs - int(rng.integers(0, n_docs // 2)))
    orc.build(docs[:n0])
    eng.build(docs[:n0])

    def check(tag):
        oid, osc = orc.search(queries, k=k)
        gid, gsc = eng.search(queries, k=k)
        if not (np.array_equal(oid, gid) and np.array_equal(osc, gsc)):
            bad = np.nonzero(
                ~((oid == gid).all(1) & (osc == gsc).all(1))
            )[0][:3]
            raise AssertionError(
                f"{desc} [{tag}] mismatch rows {bad.tolist()}:\n"
                f"  oracle ids {oid[bad]}\n  engine ids {gid[bad]}\n"
                f"  oracle sc  {osc[bad]}\n  engine sc  {gsc[bad]}"
            )

    check("build")
    pending = list(docs[n0:])
    n_total = n0  # global ids are dense over every doc ever added
    alive = set(range(n0))
    for step in range(int(rng.integers(2, 6))):
        op = rng.choice(["add", "delete", "compact", "search"])
        if op == "add" and pending:
            take = int(rng.integers(1, min(8, len(pending)) + 1))
            orc.add_docs(pending[:take])
            eng.add_docs(pending[:take])
            alive |= set(range(n_total, n_total + take))
            n_total += take
            pending = pending[take:]
        elif op == "delete" and len(alive) > 2:
            dead = rng.choice(sorted(alive),
                              size=min(3, len(alive) - 1), replace=False)
            orc.delete_docs([int(d) for d in dead])
            eng.delete_docs([int(d) for d in dead])
            alive -= set(int(d) for d in dead)
        elif op == "compact":
            eng.compact()
        check(f"step{step}:{op}")
    return desc


def main():
    trials = int(os.environ.get("FUZZ_TRIALS", 20))
    base = int(os.environ.get("FUZZ_SEED", int(time.time()) % 100000))
    print(f"differential fuzz: {trials} trials, base seed {base}",
          flush=True)
    t0 = time.perf_counter()
    for i in range(trials):
        desc = one_trial(base + i * 101)
        print(f"  ok {i + 1}/{trials}: {desc} "
              f"[{time.perf_counter() - t0:.0f}s]", flush=True)
    print(f"ALL {trials} TRIALS PASSED in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
