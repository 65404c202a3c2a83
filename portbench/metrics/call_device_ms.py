"""Mean over the window of the device time between CUDA events recorded on
the compute stream just before each entry call and just after it returns
(the call's input copy, graph replay and output clones)."""


def read(rec):
    t = rec.get("call_device_s")
    return 1e3 * sum(t) / len(t) if t else None
