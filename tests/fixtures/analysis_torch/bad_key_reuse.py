"""Known-bad fixture: PRNG key consumed twice -> exactly one RA003."""
from repro_torch.core import threefry


def init_params(seed):
    key = threefry.prng_key(seed)
    w = threefry.uniform(key, (4, 4))
    b = threefry.uniform(key, (4,))  # <- RA003: key already consumed
    return w, b
