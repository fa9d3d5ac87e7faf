"""Device profile: what the accelerator is and how much memory it offers.

Read once from `jax.devices()`.  Every path that depends on the device
(kernel choice, dispatch sizes, memory budgets) reads this profile instead
of testing the backend by name, so one place decides what the program
assumes about the hardware.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import jax


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    platform: str      # jax.devices()[0].platform: "gpu" or "cpu"
    kind: str          # device_kind, e.g. "NVIDIA H100 80GB HBM3"
    count: int         # len(jax.devices())
    bytes_limit: int   # memory one device gives this process

    @property
    def accelerated(self) -> bool:
        """True on the GPU: the int8 candidate GEMM, the coarse graph tier
        and the fused rerank kernel pay off there; on the CPU the plain
        compare sweeps are faster and are the test oracles."""
        return self.platform == "gpu"

    def budget(self, fraction: float) -> int:
        """`fraction` of one device's memory, in bytes."""
        return int(fraction * self.bytes_limit)


def host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


@functools.lru_cache(maxsize=None)
def device_profile() -> DeviceProfile:
    devs = jax.devices()
    dev = devs[0]
    stats = dev.memory_stats() or {}
    limit = stats.get("bytes_limit") or host_memory_bytes()
    return DeviceProfile(platform=dev.platform, kind=dev.device_kind,
                         count=len(devs), bytes_limit=int(limit))
