"""Packed sort-based scorer must be bit-identical to the dense reference
path (score_exact + topk_ranked) on randomized CSR inputs."""
import jax.numpy as jnp
import numpy as np

from document_search_engine_tpu.ops.exact import row_cap, score_exact
from document_search_engine_tpu.ops.packed import search_packed, total_cap
from document_search_engine_tpu.ops.topk import topk_ranked


def make_csr(rng, n_terms, n_docs, density=0.1):
    rows, docs = np.nonzero(rng.random((n_terms, n_docs)) < density)
    vals = (rng.random(len(rows)) * 0.9 + 0.05).astype(np.float32)
    indptr = np.searchsorted(rows, np.arange(n_terms + 1)).astype(np.int32)
    return indptr, docs.astype(np.int32), vals


def test_packed_matches_dense_reference():
    rng = np.random.default_rng(3)
    n_terms, n_docs = 40, 200
    d_pad = 256
    indptr, post_doc, post_val = make_csr(rng, n_terms, n_docs)
    alive = np.ones(d_pad, bool)
    alive[n_docs:] = False
    alive[rng.integers(0, n_docs, 10)] = False  # some tombstones
    nq, s = 8, 6
    rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
    coeff = (rng.random((nq, s)).astype(np.float32) * 1.5)
    coeff[rng.random((nq, s)) < 0.2] = 0.0  # some missing slots
    scale, clip = jnp.float32(2.0**16), jnp.float32(65075262)

    found = coeff > 0
    cap = row_cap(indptr, rows[found])
    scores = score_exact(
        jnp.asarray(indptr), jnp.asarray(post_doc), jnp.asarray(post_val),
        jnp.asarray(rows), jnp.asarray(coeff), scale, clip,
        cap=cap, n_docs_pad=d_pad,
    )
    gid_cols = jnp.asarray(np.arange(d_pad, dtype=np.int32) + 1000)
    for k in (1, 5, 20, 300):
        ref_v, ref_g = topk_ranked(scores, jnp.asarray(alive), gid_cols, k=k)
        c = total_cap(indptr, rows, found)
        # tombstones are folded into post_val (builder zeroes dead docs)
        pv_masked = post_val * alive[post_doc]
        got_v, got_g = search_packed(
            jnp.asarray(indptr), jnp.asarray(post_doc), jnp.asarray(pv_masked),
            jnp.asarray(rows), jnp.asarray(coeff),
            scale, clip, jnp.int32(1000),
            c_total=c, k=k, n_docs=n_docs,
        )
        np.testing.assert_array_equal(np.asarray(got_v), np.asarray(ref_v))
        np.testing.assert_array_equal(np.asarray(got_g), np.asarray(ref_g))


def test_packed_duplicate_term_rows_and_empty():
    """Same row in several slots (duplicate query term hashes can't happen,
    but a row may repeat across queries) and fully-empty queries."""
    rng = np.random.default_rng(5)
    indptr, post_doc, post_val = make_csr(rng, 10, 50, density=0.3)
    alive = np.ones(64, bool)
    alive[50:] = False
    rows = np.array([[2, 2, 2], [0, 0, 0]], np.int32)
    coeff = np.array([[0.5, 0.25, 0.125], [0.0, 0.0, 0.0]], np.float32)
    scale, clip = jnp.float32(2.0**16), jnp.float32(65075262)
    c = total_cap(indptr, rows, coeff > 0)
    v, g = search_packed(
        jnp.asarray(indptr), jnp.asarray(post_doc),
        jnp.asarray(post_val * alive[post_doc]),
        jnp.asarray(rows), jnp.asarray(coeff),
        scale, clip, jnp.int32(0), c_total=c, k=5, n_docs=50,
    )
    v, g = np.asarray(v), np.asarray(g)
    assert (v[1] == -1).all() and (g[1] == -1).all()
    # row 2's docs each got 3 contributions; check one by hand
    cap = row_cap(indptr, rows[:1].ravel())
    scores = score_exact(
        jnp.asarray(indptr), jnp.asarray(post_doc), jnp.asarray(post_val),
        jnp.asarray(rows[:1]), jnp.asarray(coeff[:1]), scale, clip,
        cap=cap, n_docs_pad=64,
    )
    ref_v, ref_g = topk_ranked(
        scores,
        jnp.asarray(alive),
        jnp.asarray(np.arange(64, dtype=np.int32)),
        k=5,
    )
    np.testing.assert_array_equal(v[0], np.asarray(ref_v)[0])
    np.testing.assert_array_equal(g[0], np.asarray(ref_g)[0])


def make_aligned(indptr, post_doc, post_val, n_docs):
    """Aligned (X, 128) planes + row_start from contiguous CSR arrays
    (the builder's device layout)."""
    from document_search_engine_tpu.index.builder import (
        _host_planes,
        aligned_geometry,
    )

    row_start, x_rows = aligned_geometry(indptr, 1)
    tf = np.ones(int(indptr[-1]), np.int32)
    d2, v2, _ = _host_planes(
        post_doc, post_val, tf, indptr, row_start, x_rows, n_docs
    )
    return d2, v2, row_start.astype(np.int32)


def test_packed_ds_and_tables_match_packed():
    """The dynamic-slice (aligned-plane) variant and the plan-table XLA
    twin must equal the gather path exactly."""
    from document_search_engine_tpu.ops.plan import plan_tables
    from document_search_engine_tpu.ops.packed import (
        search_packed_ds,
        search_packed_tables,
    )
    from document_search_engine_tpu.ops.schedule import block_plan

    rng = np.random.default_rng(21)
    n_terms, n_docs = 25, 3000
    lens = rng.integers(1, 2500, n_terms)
    indptr64 = np.zeros(n_terms + 1, np.int64)
    np.cumsum(lens, out=indptr64[1:])
    nnz = int(indptr64[-1])
    parts = [
        np.sort(rng.choice(n_docs, size=l, replace=False).astype(np.int32))
        for l in lens
    ]
    post_doc = np.concatenate(parts)
    post_val = rng.random(nnz, dtype=np.float32) * 0.9 + 0.05
    indptr = indptr64.astype(np.int32)
    d2, v2, row_start = make_aligned(indptr, post_doc, post_val, n_docs)
    for blocksize in (512, 2048):
        nq, s = 5, 3
        rows = rng.integers(0, n_terms, (nq, s)).astype(np.int32)
        coeff = (rng.random((nq, s)).astype(np.float32) * 1.5)
        coeff[1, 1] = 0.0
        scale, clip = jnp.float32(2.0**16), jnp.float32(65075262)
        found = coeff > 0
        c = total_cap(indptr, rows, found)
        nnz_pad = nnz + blocksize
        pd = np.concatenate(
            [post_doc, np.full(nnz_pad - nnz, n_docs, np.int32)]
        )
        pv = np.concatenate([post_val, np.zeros(nnz_pad - nnz, np.float32)])
        ref = search_packed(
            jnp.asarray(indptr), jnp.asarray(pd), jnp.asarray(pv),
            jnp.asarray(rows), jnp.asarray(coeff), scale, clip,
            jnp.int32(100), c_total=c, k=15, n_docs=n_docs,
        )
        nb = block_plan(indptr, rows, found, block=blocksize)
        got = search_packed_ds(
            jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(indptr),
            jnp.asarray(row_start), jnp.asarray(rows), jnp.asarray(coeff),
            scale, clip, jnp.int32(100), n_blocks=nb, k=15,
            n_docs=n_docs, block=blocksize,
        )
        np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
        np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
        sr, rm, ab, _dst = plan_tables(
            row_start, indptr, rows, coeff, nb, blocksize
        )
        got_t = search_packed_tables(
            jnp.asarray(d2), jnp.asarray(v2), jnp.asarray(sr),
            jnp.asarray(rm), jnp.asarray(ab), scale, clip,
            jnp.int32(100), n_blocks=nb, block=blocksize, s=s, k=15,
            n_docs=n_docs,
        )
        np.testing.assert_array_equal(
            np.asarray(got_t[0]), np.asarray(ref[0])
        )
        np.testing.assert_array_equal(
            np.asarray(got_t[1]), np.asarray(ref[1])
        )
