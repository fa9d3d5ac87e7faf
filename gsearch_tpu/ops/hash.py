"""32-bit hash mixers and uniform/exponential draws, as JAX device ops.

Design note: accelerators have no fast 64-bit integer datapath, so the framework
never materializes u64 on device.  Wide k-mers (DNA k in 17..32, AA k in
7..12) are carried as (hi, lo) uint32 lane pairs and hashed by cross-mixing
the two lanes.  This replaces the reference's 64-bit FxHash/murmur-style
hashing inside kmerutils/probminhash (reference call sites:
src/dna/dnasketch.rs:164-169, src/bin/hypermash.rs:149-166).

All mixers are bijective-per-lane finalizers (lowbias32), so hash quality is
adequate for sketching statistics; none of this is cryptographic.
"""

from __future__ import annotations

import jax.numpy as jnp

_U = jnp.uint32


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def mix32(x: jnp.ndarray, seed: int | jnp.ndarray = 0) -> jnp.ndarray:
    """lowbias32 finalizer of (x ^ seed); uint32 -> uint32, bijective in x."""
    x = _u32(x) ^ _u32(seed)
    x = x ^ (x >> 16)
    x = x * _U(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def mix2(hi: jnp.ndarray, lo: jnp.ndarray, seed: int | jnp.ndarray = 0) -> jnp.ndarray:
    """Mix a (hi, lo) uint32 pair (a logical u64) into one uint32."""
    a = mix32(lo, _u32(seed) ^ _U(0x9E3779B9))
    b = mix32(_u32(hi) ^ a, seed)
    return mix32(a ^ b, _u32(seed) ^ _U(0x85EBCA6B))


def uniform01(h: jnp.ndarray) -> jnp.ndarray:
    """uint32 hash bits -> f32 uniform in [0, 1) (24-bit mantissa path)."""
    return (h >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def exp_from_bits(h: jnp.ndarray) -> jnp.ndarray:
    """uint32 hash bits -> f32 Exp(1) draw; uses (0, 1] to avoid log(0)."""
    u = ((h >> 8).astype(jnp.float32) + jnp.float32(1.0)) * jnp.float32(1.0 / (1 << 24))
    return -jnp.log(u)
