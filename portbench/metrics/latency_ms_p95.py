"""95th percentile, over every call completed in the window, of the time
from handing the call's input to the program until its outputs are on the
host (host clock; numpy's linear interpolation)."""

import numpy as np


def read(rec):
    lat = rec["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
