"""Known-bad fixture: host numpy inside a hot path -> exactly one RA002."""
import numpy as np


class MinibatchStream:  # a hot class: its methods are hot scopes
    # the step every streamed batch runs
    def step(self, x):
        mean = np.mean(x)  # <- RA002: host numpy op in a hot path
        return x - mean
