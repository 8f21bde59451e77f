"""Constant tables that a step uses on every call, sent to each device
once. Copying a host array to the card makes the host wait for the
device queue, so a table built on the host is copied the first time a
device asks for it and kept."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_CACHE: dict = {}


def device_const(key: tuple, device, make: Callable[[], np.ndarray | tuple]):
    """`make()` (a numpy array, or a tuple of them) as tensors on `device`,
    built and copied once per (`key`, device). `key` names the table and
    its parameters, and is unique across callers."""
    k = (key, str(device))
    if k not in _CACHE:
        v = make()
        _CACHE[k] = (tuple(torch.from_numpy(a).to(device) for a in v)
                     if isinstance(v, tuple) else torch.from_numpy(v).to(device))
    return _CACHE[k]
