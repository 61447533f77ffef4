"""The benchmark of witch_tpu_torch (see README.md)."""
