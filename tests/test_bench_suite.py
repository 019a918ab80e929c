"""Smoke test for the full benchmark suite driver (small subset, CPU)."""

import json
import subprocess
import sys
import os

import pytest


def test_run_all_quick(tmp_path):
    out = tmp_path / "results.jsonl"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env["PYTHONPATH"] = root
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(root, "benchmarks", "run_all.py"),
            "--quick",
            "--skip-synth",
            "--kernels",
            "xla",
            "--matrices",
            "ibm32,pdp08-pg4",
            "--out",
            str(out),
        ],
        capture_output=True,
        text=True,
        env=env,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-500:]
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    kinds = {(r["matrix"], r.get("alg"), r.get("op", r.get("kernel"))) for r in recs}
    # encode+decode and SpMV records for both matrices and algorithms.
    assert ("ibm32", "CSR", "encode+decode") in kinds
    assert ("ibm32", "TJDS", "xla") in kinds
    assert ("pdp08-pg4", "CSR", "xla") in kinds
    assert all(r.get("decode_bit_exact", True) for r in recs)
    assert all("error" not in r for r in recs), recs
