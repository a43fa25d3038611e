"""The generator's device time an image: operations launched inside the
port's ``maskgit.step`` spans (each sampler step's generator passes,
guidance, noise and mask update), over the window's images."""


def read(run):
    t = run.trace
    if t is None or not run.images:
        return None
    s = t.range_device_s(("maskgit.step",))
    return 1000.0 * s / run.images if s > 0 else None
