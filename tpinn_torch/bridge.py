"""Weight carry between the JAX package and the port.

Both packages keep MLP parameters as a list of ``{"kernel": (in, out),
"bias": (out,)}`` dicts.  Moving them as numpy arrays lets the two compute
from the same θ (the parity tests do exactly that).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def params_from_numpy(params: Sequence[dict], device="cpu",
                      dtype: torch.dtype = torch.float64) -> List[dict]:
    """numpy (or array-like) params -> torch tensors on ``device``."""
    return [
        {key: torch.as_tensor(np.array(p[key]), dtype=dtype, device=device)
         for key in ("kernel", "bias")}
        for p in params
    ]


def params_to_numpy(params: Sequence[dict]) -> List[dict]:
    """torch params -> numpy arrays (detached, on the host)."""
    return [
        {key: p[key].detach().cpu().numpy() for key in ("kernel", "bias")}
        for p in params
    ]
