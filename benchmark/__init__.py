"""The benchmark of blackstar_tpu_torch: cells, reference and harness (see README.md)."""
