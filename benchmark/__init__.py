"""Benchmark of metropolismontecarlo_tpu_torch on one NVIDIA GPU.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of BENCHMARK.json once: it builds the cell's configuration
(configs/<config>.json) under its traffic (traffic/<traffic>.json) from
the seed, times whole blocks of the port's own block entry for the given
seconds, checks what the timed blocks produced against the plain
reference (reference/), and prints one JSON line of results.  Each
per-layer metric has its reader in metrics/<metric>.py; each cell's
limits are in limits/<cell>.json.  The harness imports only the port's
public entry points, never jax or the JAX package.
"""
