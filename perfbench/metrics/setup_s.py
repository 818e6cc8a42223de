"""Process start to the first timed request: imports, the kernels loaded
from the build cache (built on a checkout's first run), the weights drawn
on the card, the engine's arena, and the cell's own shapes run once."""


def read(run):
    return run.setup_s
