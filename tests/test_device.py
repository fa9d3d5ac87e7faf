"""Device profile, memory budgets derived from it, the compile cache
location and the native library's build key."""

import os

import numpy as np
import pytest

from gsearch_tpu.utils import device_profile
from gsearch_tpu.utils.device import host_memory_bytes

pytestmark = pytest.mark.smoke


def test_device_profile_on_cpu():
    prof = device_profile()
    assert prof.platform == "cpu"
    assert prof.accelerated is False
    assert prof.count == 8  # tests/conftest.py's virtual mesh
    # the CPU reports no bytes_limit: the host's physical memory stands in
    assert prof.bytes_limit == host_memory_bytes() > 0
    assert prof.budget(0.5) == int(0.5 * prof.bytes_limit)
    assert device_profile() is prof  # read once


def test_budgets_follow_the_profile(monkeypatch):
    """Every memory limit is a share of the profile's bytes_limit, and an
    explicit override still wins."""
    import gsearch_tpu.index.hnsw as hnsw_mod
    from gsearch_tpu import pipeline
    from gsearch_tpu.index.hnsw import HnswIndex
    from gsearch_tpu.ops.mxu import MxuSearcher

    limit = device_profile().bytes_limit
    assert MxuSearcher.compact_bytes() == int(0.5 * limit)
    assert hnsw_mod._rerank_device_bytes() == int(0.8125 * limit)
    idx = HnswIndex(sketch_size=64, sig_dtype=np.uint32)
    assert idx._coarse_bytes() == int(0.40625 * limit)
    want = min(pipeline.FLAT_AUTO_CAP, int(0.75 * limit) // (4 * 12000))
    assert pipeline.flat_auto_limit(12000) == want

    monkeypatch.setattr(MxuSearcher, "COMPACT_FRACTION", 0.25)
    monkeypatch.setattr(hnsw_mod, "_RERANK_DEVICE_BYTES", 456)
    monkeypatch.setattr(HnswIndex, "COARSE_BYTES", 789)
    assert MxuSearcher.compact_bytes() == int(0.25 * limit)
    assert hnsw_mod._rerank_device_bytes() == 456
    assert idx._coarse_bytes() == 789


def test_rerank_chunk_bounds_the_gather():
    """Query chunks keep the gathered [Qc, C, L] u32 rows inside the
    rerank working-set budget, and never drop below 8 queries."""
    from gsearch_tpu.ops.mxu import RERANK_WORKSET_FRACTION, rerank_chunk

    budget = device_profile().budget(RERANK_WORKSET_FRACTION)
    assert rerank_chunk(16, 80, 12288) == 16  # small batch: one dispatch
    lanes = budget // (4 * 80 * 64)  # 64 queries of 80 candidates fill it
    chunk = rerank_chunk(1 << 20, 80, lanes)
    assert chunk * 80 * lanes * 4 <= budget < 2 * chunk * 80 * lanes * 4
    assert rerank_chunk(1 << 20, 1 << 20, 1 << 20) == 8


def test_compile_cache_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins; without it the cache is a fixed
    directory inside the checkout."""
    from gsearch_tpu.utils import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(cache.__file__)))
    assert cache.cache_dir() == os.path.join(os.path.dirname(repo), ".jax_cache")


def test_native_build_key():
    """The library's file name changes with the source, the flags and the
    host CPU, so a build for another machine is never picked up."""
    from gsearch_tpu.io import native

    k = native.build_key(b"src", "-O3", "cpu A")
    assert k == native.build_key(b"src", "-O3", "cpu A")
    assert k != native.build_key(b"src2", "-O3", "cpu A")
    assert k != native.build_key(b"src", "-O2", "cpu A")
    assert k != native.build_key(b"src", "-O3", "cpu B")
    path = native.lib_path()
    assert path.startswith(os.path.join(native.NATIVE_DIR, "build"))
    with open(os.path.join(native.NATIVE_DIR, "fastaparse.cpp"), "rb") as f:
        assert os.path.basename(path) == f"libfastaparse-{native.build_key(f.read())}.so"
