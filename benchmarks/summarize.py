#!/usr/bin/env python
"""Summarize run_all JSONL output as markdown tables.

Usage: python benchmarks/summarize.py results.jsonl
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "-"
    f = sys.stdin if path == "-" else open(path)
    rows = [json.loads(ln) for ln in f if ln.strip()]

    bench = [r for r in rows if "gnnz_per_s" in r and "error" not in r]
    enc = [r for r in rows if r.get("op") == "encode+decode"]
    errs = [r for r in rows if "error" in r]

    if bench:
        print("## SpMV throughput\n")
        print("| matrix | alg | kernel | Gnnz/s | GB/s | roofline | err |")
        print("|---|---|---|---|---|---|---|")
        for r in bench:
            print(
                f"| {r['matrix']} | {r['alg']} | {r['kernel']} "
                f"| {r['gnnz_per_s']} | {r.get('eff_gb_s', '—')} "
                f"| {r.get('roofline_frac', '—')} "
                f"| {r.get('rel_err', 0):.1e} |"
            )
        print()

    if enc:
        print("## Encode / decode\n")
        print("| matrix | alg | op | ms | MB/s | bit-exact |")
        print("|---|---|---|---|---|---|")
        for r in enc:
            print(
                f"| {r['matrix']} | {r['alg']} | {r['op']} "
                f"| {r.get('encode_ms', '—')} | {r.get('encode_mb_s', '—')} "
                f"| {r.get('decode_bit_exact', r.get('decode_index_exact', '—'))} |"
            )
        print()

    if errs:
        print("## Errors\n")
        for r in errs:
            print(f"- {r.get('matrix')} {r.get('alg')} "
                  f"{r.get('kernel', r.get('op'))}: {r['error']}")

    # Best-per-matrix digest.
    best = defaultdict(lambda: (0.0, None))
    for r in bench:
        key = (r["matrix"], r["alg"])
        if r["gnnz_per_s"] > best[key][0]:
            best[key] = (r["gnnz_per_s"], r["kernel"])
    if best:
        print("\n## Best kernel per (matrix, alg)\n")
        for (m, a), (g, k) in sorted(best.items()):
            print(f"- {m} {a}: {g} Gnnz/s ({k})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
