"""The chunk schedule of ``update_n`` (counterpart of the bucket schedule
of the JAX package's ``utils/jit.py``).

The JAX package dispatches ``n`` steps as a few scanned buckets, so that
any ``n`` costs at most about ``2 log2(n)`` compilations.  The port keeps
the same schedule: the divergence freeze of a plain chunk restarts at the
start of every bucket there (a state frozen in one bucket is stepped once
more at the start of each later one), and the port's ``update_n`` returns
the same state only if it restarts at the same steps.
"""

from __future__ import annotations


def scan_buckets(n: int) -> list:
    """The bucket sizes, in order, that ``n`` steps are dispatched in:
    powers of two from the largest down, with a tail of 3 instead of a
    bucket of 1 (``n == 1`` itself excepted)."""
    out = []
    remaining = int(n)
    while remaining > 0:
        if remaining == 3:
            bucket = 3
        else:
            bucket = 1 << (remaining.bit_length() - 1)
            if bucket > 1 and remaining - bucket == 1:
                bucket //= 2  # leave a 3-tail instead of a 1-tail
        out.append(bucket)
        remaining -= bucket
    return out
