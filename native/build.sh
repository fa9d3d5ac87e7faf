#!/bin/sh
# Build the native host library.  Usage: build.sh [OUTPUT]
# CXXFLAGS defaults to "-O3 -march=native"; the loader (gsearch_tpu/io/
# native.py) names OUTPUT after a hash of the source, these flags and the
# host CPU, so a library built for another CPU is never loaded.
set -e
cd "$(dirname "$0")"
OUT="${1:-libfastaparse.so}"
mkdir -p "$(dirname "$OUT")"
g++ ${CXXFLAGS:--O3 -march=native} -shared -fPIC -o "$OUT.tmp$$" fastaparse.cpp
mv -f "$OUT.tmp$$" "$OUT"
echo "built $OUT"
