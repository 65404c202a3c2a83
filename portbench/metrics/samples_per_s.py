"""Capture samples handed in and decoded a second over the whole window:
completed calls x samples a call / the window's seconds (host clock)."""


def read(rec):
    return rec["calls"] * rec["samples_per_call"] / rec["window_s"]
