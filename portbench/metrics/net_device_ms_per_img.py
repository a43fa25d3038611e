"""Device time of the networks an image: operations launched inside the
runtime's ``encode_device`` / ``decode_device`` ranges and the
benchmark's own ranges around the generator and the token decode."""

RANGES = ("encode_device", "decode_device", "portbench.generate",
          "portbench.decode_tokens")


def read(run):
    t = run.trace
    if t is None or not run.images:
        return None
    s = t.range_device_s(RANGES)
    return 1000.0 * s / run.images if s > 0 else None
