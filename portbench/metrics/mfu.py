"""The whole step's share of the card's peak: model FLOPs an image (from
the configuration's shapes) times the images a second of the traced
window, counted on the host's clock, over the peak of the cell's
precision.  The profiler's own host work slows the host-bound cells in
this window, so it reads below what an untraced run does."""
from portbench.harness.peaks import FLOPS


def read(run):
    if run.trace is None or not run.flops_per_image or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_image * run.images / run.window_s / FLOPS[run.dtype]
