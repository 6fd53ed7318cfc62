"""The model's weights, drawn by the benchmark from ``--seed`` on the card.

One uniform draw covers every randomly initialised value, from a
``torch.Generator`` on the device; the inverse normal CDF turns it into
N(0, 1), truncated at two standard deviations where the spec says
"trunc", and a per-value scale gives each tensor its std. Biases and
BatchNorm start at zero / one. The result is a flat dict of f32 tensors
(the type the program keeps its parameters in) with the names of
``reference.model.param_specs``, which the program's state dict shares.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from .reference.model import Spec, param_specs

_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Phi(-2)
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))   # Phi(2)


def draw(specs: List[Spec], seed: int, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``specs``, the same for the same seed."""
    rand = [s for s in specs if s[2] in ("trunc", "normal")]
    sizes = [math.prod(s[1]) for s in rand]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=g, device=device)
    counts = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(
        torch.tensor([s[3] for s in rand], device=device), counts)
    trunc = torch.repeat_interleave(
        torch.tensor([s[2] == "trunc" for s in rand], device=device), counts)
    lo = torch.where(trunc, _PHI_LO, 0.0)
    hi = torch.where(trunc, _PHI_HI, 1.0)
    p = (lo + u * (hi - lo)).clamp(1e-7, 1.0 - 1e-7)
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    values = (z * std).split(sizes)
    out, i = {}, 0
    for name, shape, init, _ in specs:
        if init in ("trunc", "normal"):
            out[name] = values[i].reshape(shape)
            i += 1
        else:
            fill = 1.0 if init == "ones" else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def model_weights(c: dict, seed: int, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """The weights of the configuration ``c`` (a config file's
    ``config`` section)."""
    return draw(param_specs(c), seed, device)
