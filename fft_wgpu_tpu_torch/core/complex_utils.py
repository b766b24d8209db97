"""Split real/imag complex representation helpers (torch).

Complex data is carried as a planar pair of float32 tensors ``(re, im)``
through the compute path; ``complex64`` is the public facade.  Numpy input
is placed on an explicit ``device`` (CPU by default); tensors stay on the
device they lie on.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["split", "merge", "promote_to_split"]


def split(x, device=None):
    """complex (or real) array/tensor -> (re, im) pair of float32 tensors."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if np.iscomplexobj(x):
            re = torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
            im = torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
            return re.to(device or "cpu"), im.to(device or "cpu")
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device or "cpu")
    if x.is_complex():
        return (x.real.to(torch.float32).contiguous(),
                x.imag.to(torch.float32).contiguous())
    x = x.to(torch.float32)
    return x, torch.zeros_like(x)


def merge(re, im):
    """(re, im) float32 pair -> complex64 tensor."""
    return torch.complex(re.to(torch.float32), im.to(torch.float32))


def promote_to_split(x, device=None):
    """Accept complex/real tensor or numpy input, or an (re, im) pair, and
    return an (re, im) float32 tensor pair."""
    if isinstance(x, (tuple, list)) and len(x) == 2:
        re, im = x
        return (torch.as_tensor(re, dtype=torch.float32, device=device),
                torch.as_tensor(im, dtype=torch.float32, device=device))
    return split(x, device)
