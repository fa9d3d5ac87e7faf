import jax.numpy as jnp
import numpy as np
import pytest

from gsearch_tpu.ops.distance import (
    brute_force_knn,
    gather_eqcount,
    hamming_frac_xla,
)

pytestmark = pytest.mark.smoke


def _oracle(q, db):
    out = np.empty((q.shape[0], db.shape[0]), dtype=np.float32)
    for i in range(q.shape[0]):
        for j in range(db.shape[0]):
            out[i, j] = 1.0 - (q[i] == db[j]).mean()
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.uint32, np.uint16])
def test_xla_matches_oracle(rng, dtype):
    s = 100
    if dtype == np.float32:
        q = rng.integers(0, 8, size=(5, s)).astype(dtype)
        db = rng.integers(0, 8, size=(17, s)).astype(dtype)
    else:
        q = rng.integers(0, 8, size=(5, s)).astype(dtype)
        db = rng.integers(0, 8, size=(17, s)).astype(dtype)
    d = np.asarray(hamming_frac_xla(jnp.asarray(q), jnp.asarray(db)))
    np.testing.assert_allclose(d, _oracle(q, db), atol=1e-6)


def test_chunked_xla_large_n(rng):
    s = 64
    q = rng.integers(0, 4, size=(3, s)).astype(np.uint32)
    db = rng.integers(0, 4, size=(5000, s)).astype(np.uint32)
    d = np.asarray(hamming_frac_xla(jnp.asarray(q), jnp.asarray(db), chunk=1024))
    d_small = np.asarray(hamming_frac_xla(jnp.asarray(q), jnp.asarray(db), chunk=10_000))
    np.testing.assert_allclose(d, d_small, atol=1e-6)


def test_brute_force_knn(rng):
    s, n, k = 128, 200, 10
    db = rng.integers(0, 1 << 30, size=(n, s)).astype(np.uint32)
    q = db[5:8].copy()  # queries identical to db rows 5,6,7
    dist, ids = brute_force_knn(jnp.asarray(q), jnp.asarray(db), k)
    dist, ids = np.asarray(dist), np.asarray(ids)
    assert ids[0, 0] == 5 and ids[1, 0] == 6 and ids[2, 0] == 7
    np.testing.assert_allclose(dist[:, 0], 0.0, atol=1e-6)
    assert (np.diff(dist, axis=1) >= -1e-6).all()  # sorted ascending


def _gather(db, q, ids, s_true, parts=1):
    return np.asarray(gather_eqcount(jnp.asarray(db), jnp.asarray(q),
                                     jnp.asarray(ids), s_true=s_true,
                                     parts=parts))


def test_gather_pallas_interpret_2d_and_3d(rng):
    """gather_eqcount: [Qc, R] candidate distances match a numpy gather
    oracle, for both the 2-D db and the pre-shaped [N, 8, Sp/8] form (the
    layout big resident matrices are stored in)."""
    s_true, sp = 900, 1024  # column-padded to the 8*128 tile
    qc, r, n = 8, 16, 64
    db = np.zeros((n, sp), np.uint32)
    db[:, :s_true] = rng.integers(0, 4, size=(n, s_true)).astype(np.uint32)
    q = np.ones((qc, sp), np.uint32)  # col pads 1 vs db's 0
    q[:, :s_true] = rng.integers(0, 4, size=(qc, s_true)).astype(np.uint32)
    ids = rng.integers(0, n, size=(qc, r)).astype(np.int32)

    want = np.empty((qc, r), np.float32)
    for i in range(qc):
        eq = (db[ids[i], :s_true] == q[i, :s_true]).sum(1)
        want[i] = (s_true - eq) / np.float32(s_true)

    d2 = _gather(db, q, ids, s_true)
    np.testing.assert_allclose(d2, want, atol=1e-6)
    d3 = _gather(db.reshape(n, 8, sp // 8), q, ids, s_true)
    np.testing.assert_array_equal(d3, d2)


def test_gather_pallas_halves_mode(rng):
    """parts=2 counts equal 16-bit halves of u32 lanes (the compact
    rerank representation, ops/mxu.py): matches a numpy half-unpack oracle."""
    s_true, sp = 1800, 1024  # 1800 hashed slots packed into 900 (+pad) lanes
    qc, r, n = 8, 16, 64
    halves_db = rng.integers(0, 4, size=(n, 2 * sp)).astype(np.uint32)
    halves_q = rng.integers(0, 4, size=(qc, 2 * sp)).astype(np.uint32)
    halves_db[:, s_true:] = 0  # db col pads 0
    halves_q[:, s_true:] = 1  # query col pads 1
    db = halves_db[:, 0::2] | (halves_db[:, 1::2] << 16)
    q = halves_q[:, 0::2] | (halves_q[:, 1::2] << 16)
    ids = rng.integers(0, n, size=(qc, r)).astype(np.int32)

    want = np.empty((qc, r), np.float32)
    for i in range(qc):
        eq = (halves_db[ids[i], :s_true] == halves_q[i, :s_true]).sum(1)
        want[i] = (s_true - eq) / np.float32(s_true)

    d = _gather(db, q, ids, s_true, parts=2)
    np.testing.assert_allclose(d, want, atol=1e-6)


def test_gather_pallas_quarters_mode(rng):
    """parts=4 counts equal 8-bit quarters of u32 lanes (the full-width
    packed8 rerank tier): matches a numpy byte-unpack oracle."""
    s_true, sp = 3900, 1024  # 3900 hashed slots packed into 975 (+pad) lanes
    qc, r, n = 8, 16, 64
    q_db = rng.integers(0, 4, size=(n, 4 * sp)).astype(np.uint32)
    q_q = rng.integers(0, 4, size=(qc, 4 * sp)).astype(np.uint32)
    q_db[:, s_true:] = 0  # db col pads 0
    q_q[:, s_true:] = 1   # query col pads 1
    db = (q_db[:, 0::4] | (q_db[:, 1::4] << 8)
          | (q_db[:, 2::4] << 16) | (q_db[:, 3::4] << 24))
    q = (q_q[:, 0::4] | (q_q[:, 1::4] << 8)
         | (q_q[:, 2::4] << 16) | (q_q[:, 3::4] << 24))
    ids = rng.integers(0, n, size=(qc, r)).astype(np.int32)

    want = np.empty((qc, r), np.float32)
    for i in range(qc):
        eq = (q_db[ids[i], :s_true] == q_q[i, :s_true]).sum(1)
        want[i] = (s_true - eq) / np.float32(s_true)

    d = _gather(db, q, ids, s_true, parts=4)
    np.testing.assert_allclose(d, want, atol=1e-6)


def test_gather_pallas_eighths_mode(rng):
    """parts=8 counts equal 4-bit nibbles of u32 lanes (the full-width
    packed4 rerank tier at 1M x 12000): matches a numpy nibble-unpack
    oracle."""
    s_true, sp = 7800, 1024  # 7800 hashed slots packed into 975 (+pad) lanes
    qc, r, n = 8, 16, 64
    n_db = rng.integers(0, 3, size=(n, 8 * sp)).astype(np.uint32)
    n_q = rng.integers(0, 3, size=(qc, 8 * sp)).astype(np.uint32)
    n_db[:, s_true:] = 0  # db col pads 0
    n_q[:, s_true:] = 1   # query col pads 1
    db = n_db[:, 0::8]
    q = n_q[:, 0::8]
    for b in range(1, 8):
        db = db | (n_db[:, b::8] << np.uint32(4 * b))
        q = q | (n_q[:, b::8] << np.uint32(4 * b))
    ids = rng.integers(0, n, size=(qc, r)).astype(np.int32)

    want = np.empty((qc, r), np.float32)
    for i in range(qc):
        eq = (n_db[ids[i], :s_true] == n_q[i, :s_true]).sum(1)
        want[i] = (s_true - eq) / np.float32(s_true)

    d = _gather(db, q, ids, s_true, parts=8)
    np.testing.assert_allclose(d, want, atol=1e-6)


def test_pack_hash4_roundtrip(rng):
    """_pack_hash4 packs mix32 nibbles eight to a lane; equal u32 slots
    produce equal nibbles, unequal slots collide at ~2^-4."""
    from gsearch_tpu.ops.mxu import _pack_hash4

    r, s, spad = 16, 3000, 8192
    rows = rng.integers(0, 1 << 30, size=(r, s)).astype(np.uint32)
    p = np.asarray(_pack_hash4(jnp.asarray(rows), spad=spad, pad_val=0))
    assert p.shape == (r, 8, spad // 64)
    # identical rows -> identical packing; db pad nibble 0 vs query pad 1
    p2 = np.asarray(_pack_hash4(jnp.asarray(rows), spad=spad, pad_val=1))
    flat0, flat1 = p.reshape(r, -1), p2.reshape(r, -1)
    n_live_lanes = s // 8  # fully-live lanes agree regardless of pad_val
    np.testing.assert_array_equal(flat0[:, :n_live_lanes],
                                  flat1[:, :n_live_lanes])
    assert (flat0[:, n_live_lanes + 1 :] != flat1[:, n_live_lanes + 1 :]).all()


@pytest.mark.parametrize("c,lanes", [(13, 300), (16, 512), (40, 1500)])
def test_gather_eqcount_padding_and_shapes(rng, c, lanes):
    """Any candidate and lane count: shapes are [Qc, C], equal counts are
    exact, distances are the oracle's bits, out-of-range ids are clamped."""
    qc, n = 3, 40
    db = rng.integers(0, 3, size=(n, lanes)).astype(np.uint32)
    q = rng.integers(0, 3, size=(qc, lanes)).astype(np.uint32)
    ids = rng.integers(0, n, size=(qc, c)).astype(np.int32)
    ids[0, 0] = n + 5  # clamped to row n - 1
    d = _gather(db, q, ids, s_true=lanes)
    assert d.shape == (qc, c) and d.dtype == np.float32
    rows = db[np.clip(ids, 0, n - 1)]
    np.testing.assert_array_equal(np.rint((1.0 - d.astype(np.float64)) * lanes),
                                  (rows == q[:, None, :]).sum(-1))
    ref = np.asarray(hamming_frac_xla(jnp.asarray(q), jnp.asarray(db)))
    np.testing.assert_array_equal(d, np.take_along_axis(ref, np.clip(ids, 0, n - 1), 1))


def test_gather_eqcount_errors():
    """Bad field counts and lane mismatches are refused."""
    db = jnp.zeros((4, 8), jnp.uint32)
    ids = jnp.zeros((2, 3), jnp.int32)
    with pytest.raises(ValueError, match="parts"):
        gather_eqcount(db, jnp.zeros((2, 8), jnp.uint32), ids, s_true=8, parts=3)
    with pytest.raises(ValueError, match="lanes"):
        gather_eqcount(db, jnp.zeros((2, 16), jnp.uint32), ids, s_true=8)
