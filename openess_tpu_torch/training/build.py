"""Model construction: the serving subset of ``openess_tpu/training/build.py``.

For a voxel ``config_option`` the event path is two modules: the E2VID
front end (``front_sensor_b``, frozen, latent only) and the SemSegE2VID head
(``back_end``) scoring against the CLIP text embeddings. Weights are drawn
from a seed with the flax initializers' distributions (truncated-normal
LeCun for convs, variance-scaled uniform for the transposed convs, zero
biases); released checkpoints are not loaded yet.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
from torch import nn

from openess_tpu_torch import resolve_device
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.models.e2vid import E2VIDStreamingStep
from openess_tpu_torch.models.semseg_e2vid import SemSegE2VID

VOXEL_OPTIONS = ("recon2voxel", "frame2voxel")
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def compute_dtype(s: Settings) -> torch.dtype:
    return torch.bfloat16 if s.compute_dtype == "bfloat16" else torch.float32


def load_text_embeddings(s: Settings, rng: np.random.Generator) -> np.ndarray:
    """CLIP text embeddings ``[num_classes, 512]`` f32: the reference's
    ``.pth`` buffer when the file exists, else the random-normal init the
    reference uses with no path (the same numbers as the JAX package for the
    same ``rng``)."""
    if s.text_embeddings_path and os.path.isfile(s.text_embeddings_path):
        emb = torch.load(s.text_embeddings_path, map_location="cpu")
        emb = emb.float().numpy()
    else:
        emb = rng.normal(0.0, 0.01, (s.semseg_num_classes, 512)).astype(
            np.float32
        )
    if emb.shape[0] != s.semseg_num_classes:
        raise ValueError(
            f"text embeddings have {emb.shape[0]} rows, the config "
            f"{s.semseg_num_classes} classes"
        )
    return emb


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv of ``module`` from ``generator`` with the flax
    initializers' distributions (biases zero)."""
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
        elif isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(
                m.weight, 0.0, std, -2 * std, 2 * std, generator=generator
            )
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()


@dataclasses.dataclass
class ServingModels:
    e2vid: E2VIDStreamingStep      # front_sensor_b
    head: SemSegE2VID              # back_end
    text_embeddings: torch.Tensor  # [num_classes, 512]: the head's buffer
    dtype: torch.dtype
    device: torch.device


def build_models(s: Settings, seed: int = 0, device=None) -> ServingModels:
    """The voxel option's serving modules, in eval mode, on ``device``
    (CUDA unless asked otherwise) in the compute dtype, channels-last."""
    if s.config_option not in VOXEL_OPTIONS:
        raise ValueError(
            f"config_option {s.config_option!r} has no event path; the "
            f"serving models need one of {VOXEL_OPTIONS}"
        )
    dev = resolve_device(device)
    dt = compute_dtype(s)
    text = torch.from_numpy(load_text_embeddings(s, np.random.default_rng(seed)))
    e2vid = E2VIDStreamingStep(
        num_bins=s.input_channels_b, normalize=True, latent_only=True,
        fused_gates=s.e2vid_fused_gates,
    )
    head = SemSegE2VID(input_c=256, num_classes=s.semseg_num_classes)
    gen = torch.Generator().manual_seed(seed)
    init_weights(e2vid, gen)
    init_weights(head, gen)
    head.text_embeddings.copy_(text)
    mods = []
    for m in (e2vid, head):
        m = m.to(device=dev, dtype=dt, memory_format=torch.channels_last)
        mods.append(m.eval().requires_grad_(False))
    return ServingModels(
        e2vid=mods[0], head=mods[1], text_embeddings=mods[1].text_embeddings,
        dtype=dt, device=dev,
    )
