"""The steppers' plan object, shared by the Burgers, Kuramoto-Sivashinsky,
2-D Navier-Stokes and NLSE models (each JAX module defines its own copy of
the same class; the port keeps their names as subclasses of this one)."""

from __future__ import annotations

import torch

from ..core.complex_utils import default_device, is_pair, split, to_device


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None is the current CUDA device,
    which raises if there is none."""
    return default_device() if device is None else torch.device(device)


class StepperPlan:
    """Immutable stepper config (plan-object semantics: build once with the
    model's ``*_init``, replay many times).  Its tables are float32 tensors
    on ``device``; the step and rollout functions compute there.  Non-tensor
    input (numpy arrays) goes to ``device``; a tensor must lie there."""

    def __init__(self, consts, device):
        self._consts = consts
        self.device = device

    def __getitem__(self, key):
        return self._consts[key]

    def field(self, x) -> torch.Tensor:
        """A real field as a float32 tensor: a tensor on its own device,
        anything else on the plan's."""
        return to_device(x, None if isinstance(x, torch.Tensor) else self.device)

    def split_field(self, psi):
        """An (re, im) pair, or a real or complex array or tensor, as an
        (re, im) pair of float32 tensors, placed as :meth:`field` places."""
        if is_pair(psi):
            return self.field(psi[0]), self.field(psi[1])
        return split(psi, None if isinstance(psi, torch.Tensor) else self.device)
