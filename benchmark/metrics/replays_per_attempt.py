"""CUDA-graph replays per attempted step: the program's ``pnmol.step.replay``
spans inside its ``pnmol.step`` spans, over the window's attempts. 1 where
each attempt replays one captured graph, 0 where it runs op by op. None
without the program's spans, or where the program has no graphed attempt
(no ``graph_replays`` counter on its ``white_attempt_step``)."""

import sys

from harness import spans

REPLAY = spans.STEP + ".replay"


def _graphs(program="pnmol_tpu_torch.solvers.white"):
    """Whether the loaded program counts graph replays."""
    step = getattr(sys.modules.get(program), "white_attempt_step", None)
    return hasattr(step, "graph_replays")


def read(ctx):
    steps = spans.steps(ctx)
    if steps is None or not _graphs():
        return None
    replays = spans.named(ctx.trace, lambda name: name == REPLAY)
    return len(spans.inside(replays, spans.merged(steps))) / ctx.attempts
