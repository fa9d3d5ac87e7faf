"""Configuration structures + JSON persistence.

Equivalent in capability to the reference's parameter layer
(reference: src/utils/parameters.rs:14-272 and kmerutils::sketcharg re-export
at parameters.rs:11).  A built database carries a `parameters.json` that
`add`/`request`/`ann` reload so algorithm/kmer/sketch-size coherence with the
stored index is guaranteed (reference: src/bin/gsearch.rs:714-742) — no
algorithm flags are accepted at request time, by design.

The JSON schema intentionally mirrors the reference's serde layout:
  {"hnsw": {"capacity":..,"ef":..,"max_nb_conn":..,"scale_modification":..},
   "sketch": {"kmer_size":..,"sketch_size":..,"algo":..,"data_t":..},
   "block_flag": bool}
"""

from __future__ import annotations

import dataclasses
import json
import os
from enum import Enum


class SketchAlgo(str, Enum):
    """Sketching algorithms, one per reference mode
    (reference: src/dna/dnasketch.rs:493-644, CLI names at
    src/bin/gsearch.rs:181-196)."""

    PROB3A = "PROB3A"       # ProbMinHash — weighted (probability) Jaccard
    SUPER = "SUPER"         # SuperMinHash, f32 signatures
    SUPER2 = "SUPER2"       # SuperMinHash, integer signatures
    HLL = "HLL"             # SetSketch ("HyperLogLog-like"), u16 registers
    OPTDENS = "OPTDENS"     # one-permutation hashing + optimal densification
    REVOPTDENS = "REVOPTDENS"  # + reverse-optimal densification

    @classmethod
    def from_name(cls, name: str) -> "SketchAlgo":
        try:
            return cls(name.upper())
        except ValueError:
            raise ValueError(
                f"unknown sketching algorithm '{name}'; expected one of "
                f"{[a.value.lower() for a in cls]}"
            )


class DataType(str, Enum):
    DNA = "DNA"
    AA = "AA"


@dataclasses.dataclass
class SeqSketcherParams:
    """Sketching parameters (reference: kmerutils::sketcharg::SeqSketcherParams
    as used at src/bin/gsearch.rs:241-266).

    Limits match the reference: DNA kmer_size <= 32 with k=15 unsupported by
    the reference's compressed-kmer types (we accept it but warn), AA
    kmer_size <= 12, sketch_size <= 65535 (README.md:676)."""

    kmer_size: int
    sketch_size: int
    algo: SketchAlgo
    data_t: DataType

    def __post_init__(self):
        if isinstance(self.algo, str):
            self.algo = SketchAlgo.from_name(self.algo)
        if isinstance(self.data_t, str):
            self.data_t = DataType(self.data_t.upper())
        kmax = 32 if self.data_t == DataType.DNA else 12
        if not (1 <= self.kmer_size <= kmax):
            raise ValueError(
                f"kmer_size {self.kmer_size} out of range [1,{kmax}] for {self.data_t.value}"
            )
        if not (1 <= self.sketch_size <= 65535):
            raise ValueError("sketch_size must be in [1, 65535]")

    def to_json(self) -> dict:
        return {
            "kmer_size": self.kmer_size,
            "sketch_size": self.sketch_size,
            "algo": self.algo.value,
            "data_t": self.data_t.value,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SeqSketcherParams":
        return cls(
            kmer_size=int(d["kmer_size"]),
            sketch_size=int(d["sketch_size"]),
            algo=SketchAlgo.from_name(d["algo"]),
            data_t=DataType(d["data_t"].upper()),
        )


@dataclasses.dataclass
class HnswParams:
    """ANN-graph parameters (reference: src/utils/parameters.rs:33-60).

    max_nb_conn is clamped to 255 as in the reference
    (src/bin/gsearch.rs:268); scale_modification in [0.2, 1.0] controls the
    level-assignment scale — small values collapse the hierarchy toward a
    flat "HubNSW" (README.md:118, arXiv 2412.01940)."""

    capacity: int = 1_500_000
    ef: int = 1600
    max_nb_conn: int = 128
    scale_modification: float = 1.0

    def __post_init__(self):
        if self.max_nb_conn > 255:
            self.max_nb_conn = 255
        if not (0.2 <= self.scale_modification <= 1.0):
            raise ValueError("scale_modification (scale_modify_f) must be in [0.2, 1.0]")

    def to_json(self) -> dict:
        return {
            "capacity": self.capacity,
            "ef": self.ef,
            "max_nb_conn": self.max_nb_conn,
            "scale_modification": self.scale_modification,
        }

    @classmethod
    def from_json(cls, d: dict) -> "HnswParams":
        return cls(
            capacity=int(d["capacity"]),
            ef=int(d["ef"]),
            max_nb_conn=int(d["max_nb_conn"]),
            scale_modification=float(d["scale_modification"]),
        )


@dataclasses.dataclass
class ProcessingParams:
    """Bundle persisted as parameters.json
    (reference: src/utils/parameters.rs:139-218)."""

    hnsw: HnswParams
    sketch: SeqSketcherParams
    block_flag: bool = True  # True: whole genome sketched as one block

    FILENAME = "parameters.json"

    def dump_json(self, dirpath: str) -> str:
        path = os.path.join(dirpath, self.FILENAME)
        with open(path, "w") as f:
            json.dump(
                {
                    "hnsw": self.hnsw.to_json(),
                    "sketch": self.sketch.to_json(),
                    "block_flag": self.block_flag,
                },
                f,
            )
        return path

    @classmethod
    def reload_json(cls, dirpath: str) -> "ProcessingParams":
        path = os.path.join(dirpath, cls.FILENAME)
        with open(path) as f:
            d = json.load(f)
        return cls(
            hnsw=HnswParams.from_json(d["hnsw"]),
            sketch=SeqSketcherParams.from_json(d["sketch"]),
            block_flag=bool(d["block_flag"]),
        )


@dataclasses.dataclass
class ComputingParams:
    """Runtime-only knobs, never persisted
    (reference: src/utils/parameters.rs:227-272).

    nb_files_par maps to --pio (files read into RAM per IO group);
    nb_threads maps to --nbthreads (host parse workers here — device compute
    does not need a thread count).  mesh_devices is the multi-device extra:
    shard sketching and search over a jax device mesh (0 = off, -1 = all
    devices) — the first-class replacement for the reference's bash-level
    N-piece sharding (scripts/multiple_build.sh, multiple_search.sh)."""

    nb_files_par: int = 0
    nb_threads: int = 0
    adding_mode: bool = False
    add_dir: str = ""
    mesh_devices: int = 0

    @property
    def parallel_io(self) -> bool:
        return self.nb_files_par > 0


@dataclasses.dataclass
class RequestParams:
    """(reference: src/utils/parameters.rs:109-131)"""

    hnsw_dir: str
    req_dir: str
    nb_answers: int


@dataclasses.dataclass
class AnnParameters:
    """(reference: src/utils/parameters.rs:65-103)"""

    hnsw_dir: str = ""
    ask_stats: bool = False
    embed: bool = False


@dataclasses.dataclass
class FilterParams:
    """Sequence-size filter (reference: src/utils/parameters.rs:14-29);
    the main pipelines construct it with 0 => no-op
    (reference: src/bin/gsearch.rs:744)."""

    min_seq_size: int = 0

    def filter(self, seq_len: int) -> bool:
        """True => drop the sequence."""
        return seq_len < self.min_seq_size
