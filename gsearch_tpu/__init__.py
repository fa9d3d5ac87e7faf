"""gsearch_tpu — a JAX genome sketch-and-search framework for the GPU.

A brand-new JAX/XLA/Pallas implementation of the capabilities of
jean-pierreBoth/gsearch (Rust/CPU): sketch microbial genomes (DNA or protein
FASTA) into MinHash-family signatures, index them in an ANN structure, and
answer genome-similarity queries as Jaccard -> ANI/AAI.

Architecture (accelerator-first, not a translation):
  - host (Python / C++): FASTA ingest, 2-bit/5-bit packing, orchestration,
    JSON persistence (same five-file database layout in spirit as the
    reference: parameters.json / seqdict.json / processing_state.json plus
    index arrays).
  - device (JAX/XLA/Pallas): k-mer extraction, hashing, all sketching
    algorithms expressed as one unified "dart race" (per-slot min over
    hashed arrival processes, computed by batched sort + segment lookup —
    no pointer chasing, no hash tables), fused Hamming-fraction distance
    kernels, batched top-k search, and jax.sharding for multi-chip scale.

Reference capability map: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"
