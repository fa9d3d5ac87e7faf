#!/bin/bash
# Build one database per shard folder (role of the reference's
# scripts/multiple_build.sh). Shards build sequentially here — a single
# device serializes them anyway; across hosts, run one invocation per
# host.
#
# Usage: multiple_build.sh <shards_dir> <out_dir> [tohnsw args...]
#   e.g. multiple_build.sh shards/ dbs/ -k 16 -s 12000 -n 128 --algo optdens --block
set -euo pipefail
SHARDS=$1; OUT=$2; shift 2
mkdir -p "$OUT"
for d in "$SHARDS"/shard_*; do
    name=$(basename "$d")
    echo "== building $name =="
    python -m gsearch_tpu tohnsw -d "$d" "$@" -o "$OUT/$name"
done
echo "built $(ls -d "$SHARDS"/shard_* | wc -l) shard databases under $OUT"
