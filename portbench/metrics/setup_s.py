"""Seconds from the start of the process to the first call of the window:
imports, the kernels' build on a checkout's first run, the spec's
constants, the traffic made on the card, and every input shape's graph
capture and first replay."""


def read(rec):
    return rec["setup_s"]
