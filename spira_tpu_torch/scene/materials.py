"""Material model as a structure of tensors.

Counterpart of :mod:`spira_tpu.scene.materials`.  Every field is a tensor
that can take ``requires_grad`` — albedo and emission are what inverse
rendering optimizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import colorimetry as cl
from ..core.device import resolve_device
from ..core.types import tensor_dataclass


@tensor_dataclass
class Materials:
    """SoA over M materials.

    albedo:        (M, 3) base color in [0, 1]
    emission:      (M, 3) radiant emission (can exceed 1)
    metallic:      (M,)   probability of the specular lobe
    roughness:     (M,)   fuzz radius of the specular lobe
    ior:           (M,)   index of refraction (dielectrics; 1.0 = none)
    transmission:  (M,)   probability the specular lobe refracts (glass)
    albedo_spd, emission_spd: (M, N_SPD_BINS) spectral tables, or None
    cauchy_b:      (M,)   dispersion coefficient (µm²), or None
    """

    albedo: torch.Tensor
    emission: torch.Tensor
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    albedo_spd: Optional[torch.Tensor] = None
    emission_spd: Optional[torch.Tensor] = None
    cauchy_b: Optional[torch.Tensor] = None

    @property
    def count(self) -> int:
        return self.albedo.shape[0]


def make_materials(records, device=None) -> Materials:
    """Build Materials from a list of dicts with keys
    albedo, emission, metallic, roughness[, ior, transmission, cauchy_b,
    albedo_spd, emission_spd].

    The spectral tables are the Smits upsampling of albedo and emission
    (:func:`spira_tpu_torch.core.colorimetry.rgb_to_spd`, on the host); a
    record's own ``albedo_spd`` or ``emission_spd`` wins over it.  The
    tensors go to ``device`` (``None``: the card).
    """
    device = resolve_device(device)

    def col(name, default):
        return torch.tensor(
            [r.get(name, default) for r in records], dtype=torch.float32,
            device=device,
        )

    albedo = torch.tensor(
        [r["albedo"] for r in records], dtype=torch.float32, device=device
    )
    emission = col("emission", (0.0, 0.0, 0.0))
    albedo_spd = cl.rgb_to_spd(albedo.cpu().numpy())
    emission_spd = cl.rgb_to_spd(emission.cpu().numpy())
    for i, r in enumerate(records):
        if "albedo_spd" in r:
            albedo_spd[i] = np.asarray(r["albedo_spd"], np.float32)
        if "emission_spd" in r:
            emission_spd[i] = np.asarray(r["emission_spd"], np.float32)

    return Materials(
        albedo=albedo,
        emission=emission,
        metallic=col("metallic", 0.0),
        roughness=col("roughness", 0.5),
        ior=col("ior", 1.0),
        transmission=col("transmission", 0.0),
        albedo_spd=torch.from_numpy(albedo_spd).to(device),
        emission_spd=torch.from_numpy(emission_spd).to(device),
        cauchy_b=col("cauchy_b", 0.0),
    )
