"""Runnable end-to-end examples on the port (counterparts of the
repository's `examples/`), one per major workflow. Each runs as

    python -m deeplearning4j_tpu_torch.examples.<name> [--device cuda|cpu]

on the card by default; `--device cpu` runs the plain PyTorch path.
Each example's sizes are module-level constants (epochs, steps, data
size), so a caller can shorten a run without editing its code."""
