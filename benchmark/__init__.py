"""The benchmark of gsplat_tpu_torch (see README.md)."""
