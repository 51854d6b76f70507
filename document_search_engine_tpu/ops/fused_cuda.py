"""The fused search step as a CUDA kernel for Hopper, called through the
XLA FFI.

The kernel (native/fused_search.cu) serves one plan row per thread
block: it reads the row's CSR block ranges from the resident posting
planes, quantizes each posting to its int32 contribution, keeps only the
real postings (compacted at the plan's dstrow offsets) in shared memory,
sorts them by doc with CUB's block radix sort, sums each doc's run in
integers and selects the top k. It is bit-identical to the XLA twin
(ops/packed.py search_packed_tables) over the same plan tables.

A bucket goes to the kernel only when its compacted candidate buffer
(r_c rows of 128 records) fits the kernel's shared memory and k <= 128;
every other bucket runs the twin (`kernel_takes`). The choice is made in
Python per bucket, so it is testable without a GPU.

The shared library is built from the repository's source at first use
(or by `python -m document_search_engine_tpu.ops.fused_cuda`) with the
CUDA toolkit's nvcc, into `build/` at the repository root, under a name
keyed by the source's hash.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..index.csr import LANES

SCORERS = ("fused", "xla")
MAX_K = 128  # the kernel ranks at most 128 candidates per plan row
MIN_CAP_ROWS = 8  # smallest candidate buffer the kernel instantiates
# (doc, contribution) pairs of 128 rows = 16384 records = 128 KiB of
# shared memory, beside CUB's sort storage that aliases it
MAX_CAP_ROWS = 128

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SOURCE = os.path.join(_ROOT, "native", "fused_search.cu")
BUILD_DIR = os.path.join(_ROOT, "build")
TARGET = "dse_fused_search"
_library = None  # the loaded CDLL, kept alive once its target is registered


def resolve_scorer(scorer: str | None, platform: str) -> str:
    """The scorer a dispatch runs: the CUDA kernel ("fused") by default
    on a GPU, the XLA twin ("xla") elsewhere. Forcing the kernel on a
    backend without CUDA is an error — nothing falls back silently."""
    if scorer is None:
        return "fused" if platform == "gpu" else "xla"
    if scorer not in SCORERS:
        raise ValueError(f"unknown scorer {scorer!r}; expected {SCORERS}")
    if scorer == "fused" and platform != "gpu":
        raise ValueError(
            f"scorer 'fused' is a CUDA kernel; this backend is {platform!r}"
        )
    return scorer


def kernel_takes(r_c: int, k: int) -> bool:
    """Whether a bucket of r_c compacted rows (a power of two) runs the
    kernel; the rest runs the XLA twin."""
    return 1 <= k <= MAX_K and r_c <= MAX_CAP_ROWS


def kernel_cap(r_c: int) -> int:
    """Candidate slots of the kernel instantiation serving r_c rows."""
    return max(r_c, MIN_CAP_ROWS) * LANES


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libdse_cuda_{digest}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def build() -> str:
    """Compile the kernel library if this source has not been built yet;
    returns its path."""
    import jax.ffi

    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    part = out + ".part"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "--fmad=false", "-shared",
        "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
        "-o", part, SOURCE,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}"
        )
    os.replace(part, out)
    return out


def _register() -> None:
    global _library
    if _library is not None:
        return
    import jax.ffi

    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.DseFusedSearch), platform="CUDA"
    )
    _library = lib


def fused_search_cuda(
    post_doc,  # (X, 128) i32 aligned doc plane
    post_val,  # (X, 128) i32 aligned bitcast-f32 val plane
    srcrow,  # (nq, 1, NB) i32 plan tables (ops/plan.py)
    rem,
    abits,
    dstrow,
    *,
    block: int,
    k: int,
    n_docs: int,  # local sentinel doc id (> every real doc)
    r_c: int,  # compacted rows every plan row of the bucket fits in
    scale: float,
    clip: float,
    dlim=None,  # (nq, 1, 2) i32 [d_lo, d_hi) doc limits (splitting)
):
    """(vals, docs_local) (nq, k) int32, ranked (score desc, doc asc);
    exhausted slots are (-1, -1). Same contract as the twin's output
    before the doc-base offset."""
    import jax
    import jax.numpy as jnp

    assert kernel_takes(r_c, k), (r_c, k)
    _register()
    nq = srcrow.shape[0]
    out = jax.ShapeDtypeStruct((nq, k), jnp.int32)
    return jax.ffi.ffi_call(TARGET, (out, out))(
        post_doc, post_val, srcrow, rem, abits, dstrow,
        jnp.zeros((1,), jnp.int32) if dlim is None else dlim,
        block=np.int64(block),
        cap=np.int64(kernel_cap(r_c)),
        k=np.int64(k),
        n_docs=np.int64(n_docs),
        has_dlim=np.int64(dlim is not None),
        scale=np.float32(scale),
        clip=np.float32(clip),
    )


def score_bucket(
    mode: str,  # "fused" | "xla" (resolve_scorer)
    post_doc,
    post_val,
    tables,  # (srcrow, rem, abits, dstrow) of the bucket (ops/plan.py)
    doc_base,  # i32 scalar: global id of local doc 0
    *,
    n_blocks: int,
    block: int,
    s: int,
    k: int,
    n_docs: int,
    r_c: int,
    scale: float,
    clip: float,
    dlim=None,
):
    """(vals, gids) (bq, k) int32 of one plan bucket, ranked (score desc,
    gid asc): the CUDA kernel when mode is "fused" and the bucket fits
    it, the bit-identical XLA twin otherwise."""
    import jax.numpy as jnp

    from .packed import search_packed_tables

    sr, rm, ab, dst = tables
    if mode == "fused" and kernel_takes(r_c, k):
        v, dloc = fused_search_cuda(
            post_doc, post_val, sr, rm, ab, dst, block=block, k=k,
            n_docs=n_docs, r_c=r_c, scale=scale, clip=clip, dlim=dlim,
        )
        return v, jnp.where(v > 0, dloc + doc_base, -1)
    return search_packed_tables(
        post_doc, post_val, sr, rm, ab, jnp.float32(scale),
        jnp.float32(clip), doc_base, n_blocks=n_blocks, block=block, s=s,
        k=k, n_docs=n_docs, dlim=dlim,
    )


if __name__ == "__main__":
    print(build())
