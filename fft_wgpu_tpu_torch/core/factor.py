"""Mixed-radix factorization for plan construction (pure python).

Any length whose prime factors are <= MAX_DIRECT runs the mixed-radix path;
other lengths take a direct O(N^2) DFT matmul or, from ``BLUESTEIN_MIN`` on,
Bluestein (see ``ops/stockham.py``).  Same results as
``fft_wgpu_tpu.core.factor`` without its native C++ helper.
"""

from __future__ import annotations

import functools
import math

__all__ = ["MAX_DIRECT", "balanced_split", "radix_schedule", "is_smooth"]

# Largest base-case DFT executed as a single direct matmul.
MAX_DIRECT = 128


@functools.lru_cache(maxsize=None)
def balanced_split(n: int) -> tuple[int, int]:
    """Split n = n1 * n2 with n1 <= n2, n1 as close to sqrt(n) as possible.

    Returns (1, n) when n is prime (caller uses the direct-DFT fallback).
    """
    for d in range(math.isqrt(n), 1, -1):
        if n % d == 0:
            return d, n // d
    return 1, n


@functools.lru_cache(maxsize=None)
def radix_schedule(n: int, max_radix: int = MAX_DIRECT) -> tuple[int, ...] | None:
    """Greedy largest-first factor list with every factor <= max_radix,
    or None if n contains a prime factor > max_radix."""
    out = []
    m = n
    while m > 1:
        f = next((r for r in range(min(m, max_radix), 1, -1) if m % r == 0), 0)
        if f == 0:
            return None
        out.append(f)
        m //= f
    return tuple(out)


def is_smooth(n: int, max_radix: int = MAX_DIRECT) -> bool:
    return radix_schedule(n, max_radix) is not None
