"""Learning-rate schedules (port of gsplat_tpu/core/schedule.py).

get_expon_lr_func (reference utils/general_utils.py:29-62): the
log-linear interpolation with an optional sin-eased delay. The step is a
host number here; the rate comes back as a Python float.
"""

from __future__ import annotations

import math


def expon_lr(step: float, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """Log-lerp from lr_init to lr_final over max_steps; 0 if disabled or
    before step 0. Evaluated in float32, as the JAX version is."""
    import numpy as np

    f32 = np.float32
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = f32(step)
    if step < 0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
            f32(0.5 * math.pi) * np.clip(step / f32(lr_delay_steps), f32(0),
                                         f32(1)))
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0), f32(1))
    log_lerp = np.exp(f32(math.log(lr_init)) * (f32(1) - t)
                      + f32(math.log(lr_final)) * t)
    return float(f32(delay_rate * log_lerp))
