"""Mean host time of ``BlockStager``'s call (the pinned-slot fill and the
copy's enqueue on its side stream) over the window, host clock."""


def read(rec):
    t = rec.get("stage_s")
    return 1e3 * sum(t) / len(t) if t else None
