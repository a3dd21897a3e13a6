"""Host-health microbenchmark: is THIS machine fit for host-side numbers?

Port of the JAX package's root ``tools/bench_host.py`` (numpy only), so
the host of the card can be read beside the native decoder's rates:

    python -m multimodal_alzheimer_tpu_torch.tools.bench_host

Round-to-round CI VMs differ wildly (round 2 measured memcpy at 201 MB/s —
~50x below a normal server — which silently broke loader throughput,
ballooned compile times, and made 8-device CPU collectives trip XLA's
hardcoded 40 s rendezvous window). Run this before trusting any host-side
measurement or chasing a "regression" that is really the VM.

Prints one JSON line: memcpy/convert bandwidth, gzip inflate rate, core
count. Reference points: healthy server >= 5000 MB/s memcpy; the round-2
VM: 201 MB/s.
"""

from __future__ import annotations

import gzip
import json
import os
import time

import numpy as np


def bench_memcpy(mb: int = 114) -> tuple:
    """(steady_mb_s, fresh_alloc_mb_s): copies into pre-touched pages vs
    freshly allocated ones. On para-virtualized VMs page allocation can be
    orders of magnitude slower than the copy itself (round-2 VM: 4000 vs
    5 MB/s) — code that reuses buffers behaves completely differently
    from code that allocates per batch."""
    a = np.empty(mb * 1_000_000 // 4, np.float32)
    a[:] = 1.5
    dst = np.empty_like(a)
    dst[:] = 0
    t0 = time.perf_counter()
    np.copyto(dst, a)
    steady = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    a.copy()
    fresh = mb / (time.perf_counter() - t0)
    return steady, fresh


def bench_convert(mb: int = 32) -> float:
    a = np.empty(mb * 1_000_000 // 4, np.float32)
    a[:] = 1.5
    t0 = time.perf_counter()
    (a.view(np.uint32) >> 16).astype(np.uint16)
    return mb / (time.perf_counter() - t0)


def bench_gzip(mb: int = 16) -> float:
    rng = np.random.default_rng(0)
    raw = rng.normal(900, 400, mb * 1_000_000 // 4).astype(np.float32)
    blob = gzip.compress(raw.tobytes(), 1)
    t0 = time.perf_counter()
    gzip.decompress(blob)
    return mb / (time.perf_counter() - t0)


def main() -> dict:
    steady, fresh = bench_memcpy()
    out = {
        "memcpy_steady_mb_s": round(steady, 1),
        "memcpy_fresh_alloc_mb_s": round(fresh, 1),
        "convert_mb_s": round(bench_convert(), 1),
        "gzip_inflate_mb_s": round(bench_gzip(), 1),
        "cpu_count": os.cpu_count(),
    }
    out["healthy"] = steady >= 2000 and fresh >= 500
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
