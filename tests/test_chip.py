"""Checks that only mean something on the GPU (marked `chip`; the `chip`
fixture skips them elsewhere).  Run on the card:

    GSEARCH_TEST_CHIP=1 python -m pytest tests -m chip
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.chip


def test_profile_takes_the_accelerated_paths(chip):
    """On the GPU every device check takes the accelerator branch."""
    from gsearch_tpu import pipeline
    from gsearch_tpu.ops.mxu import MxuSearcher

    assert chip.platform == "gpu" and chip.accelerated
    assert chip.bytes_limit > 16e9  # a real card's share, not a default
    assert MxuSearcher.compact_bytes() == int(0.5 * chip.bytes_limit)
    assert pipeline.flat_auto_limit(12000) == 262_144


def test_int8_gemm_scores_exact(chip, rng):
    """The int8 sign-expansion GEMM on the tensor cores matches an int32
    product exactly."""
    from gsearch_tpu.ops.mxu import _sign_scores, expand_signs

    sigs = rng.integers(0, 1 << 30, size=(4096, 1200)).astype(np.uint32)
    q_exp = expand_signs(jnp.asarray(sigs[:64]), m=4)
    db_exp = expand_signs(jnp.asarray(sigs), m=4)
    got = np.asarray(jax.jit(_sign_scores)(q_exp, db_exp))
    ref = np.asarray(q_exp, np.int64) @ np.asarray(db_exp, np.int64).T
    np.testing.assert_array_equal(got, ref.astype(np.float32))


def test_flat_search_matches_oracle_on_card(chip, rng):
    """The accelerated flat path (GEMM candidates + exact rerank) returns
    the oracle's top-1 ids and bit-equal distances."""
    from gsearch_tpu.index.flat import FlatIndex
    from gsearch_tpu.ops.distance import brute_force_knn

    n, s = 8192, 1200
    db = rng.integers(0, 1 << 30, size=(n, s)).astype(np.uint32)
    q = db[:32].copy()
    q[:, :300] = rng.integers(0, 1 << 30, size=(32, 300), dtype=np.uint32)
    idx = FlatIndex(s, np.uint32)
    idx.insert(db)
    d, i = idx.search(q, 10)
    d_ref, i_ref = brute_force_knn(jnp.asarray(q), jnp.asarray(db), 10)
    np.testing.assert_array_equal(i[:, 0], np.asarray(i_ref)[:, 0])
    np.testing.assert_array_equal(d[:, 0], np.asarray(d_ref)[:, 0])
