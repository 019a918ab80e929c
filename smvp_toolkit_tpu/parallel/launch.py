"""Multi-host launch helper.

One process per host, each driving every card of its host; this module
wraps the boilerplate: initialize the process group, build the global
mesh, load + shard the matrix, run the benchmark, and report
per-host/aggregate numbers. On a single host one process and no
coordinator is the whole setup (also the CPU simulation via
``--xla_force_host_platform_device_count``, which is how CI runs it):

    python -m smvp_toolkit_tpu.parallel.launch matrix.mtx --alg csr -n 100

Several hosts run the same command with ``--coordinator host:port
--num-processes N --process-id I``.
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="smvp-dist", description="data-parallel SpMV benchmark runner"
    )
    ap.add_argument("file", help="input .mtx file (or synth:N:NNZ)")
    ap.add_argument("--alg", choices=["csr", "tjds"], default="csr")
    ap.add_argument("-n", "--iter", type=int, default=100)
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (multi-host manual)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    from smvp_toolkit_tpu.parallel.mesh import distributed_init

    distributed_init(args.coordinator, args.num_processes, args.process_id)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from smvp_toolkit_tpu.formats.csr import csr_encode
    from smvp_toolkit_tpu.formats.tjds import tjds_encode
    from smvp_toolkit_tpu.io.mtx import read_mtx
    from smvp_toolkit_tpu.parallel.spmv_dist import shard_and_bench
    from smvp_toolkit_tpu.utils.logging import log
    from smvp_toolkit_tpu.utils.synth import synth_banded

    n_dev = len(jax.devices())
    is_lead = jax.process_index() == 0
    if is_lead:
        log("START", f"{jax.process_count()} process(es), {n_dev} device(s)")

    if args.file.startswith("synth:"):
        from smvp_toolkit_tpu.utils.synth import parse_synth_spec

        coo = parse_synth_spec(args.file)
    else:
        coo = read_mtx(args.file)
    coo = coo.pad(512)

    x = jnp.ones((coo.shape[1],), jnp.float32)
    alg = args.alg.upper()
    encoded = csr_encode(coo) if alg == "CSR" else tjds_encode(coo)
    stats, y = shard_and_bench(alg, encoded, x, n_dev, iterations=args.iter)

    if is_lead:
        nnzs = stats.nnz_per_s(coo.nnz)
        log(
            "DATA",
            f"{args.alg.upper()} sharded over {n_dev} devices: "
            f"avg {stats.avg_ms:.4f} ms  ({nnzs/1e9:.3f} Gnnz/s aggregate)",
        )
    # Every process prints its checksum: multi-process tests assert the
    # replicated y agrees across the process group.
    log(
        "DATA",
        f"y checksum [process {jax.process_index()}]: {float(y.sum()):.6g}",
    )
    if is_lead:
        log("STOP", "done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
