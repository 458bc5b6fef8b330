"""The 95th percentile, over every request of the window, of the host clock
from the client's call to the depth maps in host memory."""

import numpy as np


def read(w):
    return 1e3 * float(np.percentile(w.latencies_s, 95)) if w.latencies_s else None
