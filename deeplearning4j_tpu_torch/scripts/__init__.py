"""The repository's drivers on the port (counterparts of the repo-level
`scripts/`): the serving load test, the kill-and-resume fault drill and
the online and multi-tenant drills. Each runs as

    python -m deeplearning4j_tpu_torch.scripts.<name> [--device cuda|cpu]

and writes its JSON ledger under `build/drivers/` (or `--out`); the
committed `BENCH_*.json` files are the TPU package's records and no
driver here writes one."""
