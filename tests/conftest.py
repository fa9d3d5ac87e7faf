"""Test harness: an 8-device virtual CPU mesh, set before JAX initialises.

Multi-device sharding tests run on virtual CPU devices (the analog of the
reference ecosystem's 'multi-node without a cluster' testing).  Tests
marked `chip` need the GPU and skip elsewhere; run them on the card with
`GSEARCH_TEST_CHIP=1 python -m pytest tests -m chip`.
"""

import os

if os.environ.get("GSEARCH_TEST_CHIP") != "1":
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import numpy as np
import pytest

from gsearch_tpu.utils import enable_compilation_cache

enable_compilation_cache()


@pytest.fixture()
def chip():
    """The GPU profile; skips the test when no GPU is present."""
    from gsearch_tpu.utils import device_profile

    prof = device_profile()
    if not prof.accelerated:
        pytest.skip(f"needs the GPU (platform is {prof.platform})")
    return prof


@pytest.fixture()
def rng():
    # function-scoped: each test gets the same stream whether it runs solo
    # or in the full suite (a shared session stream made statistical
    # thresholds depend on which tests ran before)
    return np.random.default_rng(42)


def random_dna(rng, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n))


def mutate_dna(rng, seq: bytes, rate: float) -> bytes:
    """Point-mutate a fraction `rate` of positions."""
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    n_mut = int(len(arr) * rate)
    pos = rng.choice(len(arr), size=n_mut, replace=False)
    arr[pos] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n_mut)
    return arr.tobytes()


def exact_canonical_kmer_set(seq: bytes, k: int) -> set:
    """Brute-force canonical k-mer set (oracle)."""
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    s = seq.decode()
    out = set()
    for i in range(len(s) - k + 1):
        km = s[i : i + k]
        if any(c not in "ACGT" for c in km):
            continue
        rc = "".join(comp[c] for c in reversed(km))
        out.add(min(km, rc))
    return out


def exact_jaccard(a: set, b: set) -> float:
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)
