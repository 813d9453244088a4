"""Import the reference's shipped pore-detector weights.

The reference distributes trained patch CNNs as raw torch state dicts keyed
by feature count (pore-detection/out_of_the_box_detect/models/{4..64}, loaded
by util/utils.py:68-114 into net{N}{max,nomax} stacks): blocks `net.{i}.block.0`
= Conv (OIHW, no bias), `net.{i}.block.2` = BatchNorm, the head `net.{L-1}` =
Conv with bias. They load straight into the port's `PlainPoreNet`: only the
keys are renamed (`LayerBlock_{i}.Conv_0`, `LayerBlock_{i}.BatchNorm_0`,
`Conv_0`); the layouts are torch's on both sides.
"""
from __future__ import annotations

from typing import Any, Dict

import torch


def convert_pore_state_dict(state_dict: Dict[str, Any], num_layers: int = 8
                            ) -> Dict[str, torch.Tensor]:
    """Reference state dict -> state_dict of `PlainPoreNet(num_layers=...)`."""
    t = lambda k: torch.as_tensor(state_dict[k]).detach().cpu()
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_layers - 1):
        out[f"LayerBlock_{i}.Conv_0.weight"] = t(f"net.{i}.block.0.weight")
        for name in ("weight", "bias", "running_mean", "running_var"):
            out[f"LayerBlock_{i}.BatchNorm_0.{name}"] = \
                t(f"net.{i}.block.2.{name}")
        out[f"LayerBlock_{i}.BatchNorm_0.num_batches_tracked"] = \
            torch.zeros((), dtype=torch.long)       # unused at inference
    head = num_layers - 1
    out["Conv_0.weight"] = t(f"net.{head}.weight")
    out["Conv_0.bias"] = t(f"net.{head}.bias")
    return out


def load_reference_detector(path: str, features: int = 40,
                            num_layers: int = 8, device="cuda"):
    """A reference weights file -> `PlainPoreNet` in eval mode on `device`."""
    from .. import resolve_device
    from .architectures import PlainPoreNet

    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = PlainPoreNet(features=features, num_layers=num_layers,
                         max_pool=False)
    model.load_state_dict(convert_pore_state_dict(sd, num_layers=num_layers))
    return model.to(resolve_device(device)).eval()
