"""Where the port's public entry points put the tensors they make, and
how host code reads them back."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, ``cuda``.
    There is no fallback: without a card, a tensor made there raises from
    torch, so a caller who wants the CPU says ``device="cpu"``."""
    return torch.device("cuda") if device is None else torch.device(device)


def host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
