"""100 x (1 - the union of the device's kernel, copy and set intervals /
the traced window), over the profiled steps of a ``--trace 1`` run."""


def read(rec):
    trace = rec.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
