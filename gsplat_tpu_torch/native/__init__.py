"""Native (C++) host IO with numpy fallbacks (a copy of gsplat_tpu/native)."""
