"""95th percentile, over the window's accepted steps, of the time from one
step's completion to the next, rejected attempts and initializations
included: CUDA events recorded on the stream after each step."""

import numpy as np


def read(ctx):
    if len(ctx.step_ms) < 20:
        return None
    return float(np.percentile(ctx.step_ms, 95))
