"""The entropy chain's host time an image: the ``h_rans`` ranges of the
port's runtime (``timed_stage``) inside the traced window, over the
window's images.  The host chain waits for the card's prior at each
step, so the range spans the chain's whole blocking time."""


def read(run):
    t = run.trace
    if t is None or not run.images:
        return None
    s = t.range_host_s("h_rans")
    return 1000.0 * s / run.images if s > 0 else None
