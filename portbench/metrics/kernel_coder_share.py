"""The encode router's share of batches sent to the device coder (the
rANS encode kernel) in the traced window: the runtime's
``encode_path_counts``, device over all."""


def read(run):
    c = run.counters
    total = c.get("device", 0) + c.get("host", 0)
    return 100.0 * c["device"] / total if total else None
