"""Model-set construction per workload, the counterpart of
``openess_tpu/training/build.py``.

One function maps (task, config_option) to named modules with roles:

================  ==========================================================
name              role
================  ==========================================================
front_sensor_b    ``e2vid``: the E2VID reconstructor over the T windows,
                  latent only; frozen (gradients never reach it) except in
                  a fine-tune with ``unfrozen_e2vid``
back_end          ``semseg_head``: SemSegE2VID over the E2VID latents,
                  scoring against the CLIP text embeddings; with the
                  ``linear_probe`` conv under ``if_linear_probing``
model_recon       ``deeplab``: the DeepLabV3 student on reconstructions
                  (pretrain ``frame2recon``, the supervised tasks on
                  ``frame2recon``, UDA on ``frame2recon`` and
                  ``recon2voxel``), or ``teacher`` in a ``recon2voxel``
                  pretrain
model_frame       ``teacher``: the frame teacher (frozen dilated ResNet-50
                  encoder, trainable ``decoder_conv``) of a pretrain on
                  ``frame2voxel`` or ``frame2recon``; or ``deeplab`` on
                  frames in UDA on ``frame2voxel`` and ``frame2recon``
================  ==========================================================

This is the one place where a module is made and initialised: the trainer
and the streaming server both build from it. Weights are drawn from a seed
with the flax initializers' distributions (truncated-normal LeCun for
convs, variance-scaled uniform for the transposed convs, zero biases,
identity BatchNorms); released checkpoints are not loaded yet.

Parameter dtypes: a frozen E2VID is stored in the compute dtype; the rest
(the head, the teacher, the DeepLabV3 students, E2VID under
``unfrozen_e2vid``) keeps f32 parameters and casts them to the compute
dtype where they are used (as flax modules do), so the optimizer updates
f32 weights under a bf16 compute dtype.
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
from openess_tpu_torch.models.deeplabv3 import DeepLabV3TextSeg
from openess_tpu_torch.models.e2vid import (
    E2VIDReconstructor,
    E2VIDStreamingStep,
)
from openess_tpu_torch.models.image_teacher import DilationFeatureExtractor
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


def task_from_settings(s: Settings) -> str:
    """The train entry point's dispatch order."""
    if s.if_supervised_only:
        return "sup_only"
    if s.if_pretraining:
        return "pretrain"
    if s.if_finetuning:
        return "finetune"
    if s.if_linear_probing:
        return "linear_probe"
    return "openess"


@dataclasses.dataclass
class ModelSet:
    modules: dict                  # name -> nn.Module
    roles: dict                    # name -> 'e2vid'|'semseg_head'|'teacher'
                                   #         |'deeplab'
    groups: dict                   # name -> group 'recon'|'frame'|'voxel'
    text_embeddings: torch.Tensor  # [num_classes, 512]: a student's buffer
    task: str
    dtype: torch.dtype             # the compute dtype
    device: torch.device

    def state_dict(self) -> dict:
        """``{name: module.state_dict()}`` (the checkpoint's model part)."""
        return {k: m.state_dict() for k, m in self.modules.items()}


def refuse_unported_mesh(s: Settings, device=None) -> None:
    """The ``tpu.mesh_*`` settings the port cannot honour raise, as the JAX
    package asserts ``data x model <= devices`` (``parallel/mesh.py``) and
    shards: model parallelism at all, and more data shards than devices
    (CUDA devices, or 1 on the CPU). The shipped ``-1`` (every device) and
    ``1`` pass; the port then trains on the one device it is given."""
    item = "ROADMAP Queue 1 item 12 (multi-device)"
    if s.mesh_model > 1:
        raise NotImplementedError(
            f"tpu.mesh_model {s.mesh_model}: model parallelism is not "
            f"ported yet: {item}")
    dev = torch.device("cuda" if device is None else device)
    devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    if s.mesh_data > devices:
        raise NotImplementedError(
            f"tpu.mesh_data {s.mesh_data} is more than the {devices} "
            f"{dev.type} device(s) here, and data parallelism is not ported "
            f"yet: {item}")


def e2vid_trains(s: Settings) -> bool:
    """Whether E2VID's parameters train: only a fine-tune with
    ``unfrozen_e2vid``."""
    return bool(s.unfrozen_e2vid and s.if_finetuning)


def build_models(s: Settings, seed: int = 0, device=None, *,
                 event_path_only: bool = False) -> ModelSet:
    """The modules of the configured workload on ``device`` (CUDA unless
    asked otherwise), seeded: every task on every ``config_option``, as the
    JAX package builds them. ``tpu.e2vid_s2d`` raises
    ``NotImplementedError`` naming the ROADMAP item that brings it.
    ``event_path_only`` builds ``front_sensor_b`` and ``back_end`` alone
    (a server needs nothing else; they come out as in the full build), and
    raises on ``frame2recon``, which has no event path."""
    task = task_from_settings(s)
    opt = s.config_option
    if s.e2vid_s2d:
        raise NotImplementedError(
            "tpu.e2vid_s2d: E2VID's space-to-depth form is not ported yet: "
            "ROADMAP Queue 1 item 10 (the tpu.e2vid_s2d knob)")
    if opt not in VOXEL_OPTIONS + ("frame2recon",):
        raise ValueError(f"unknown config_option {opt!r}")
    if event_path_only and opt not in VOXEL_OPTIONS:
        raise ValueError(
            f"config_option {opt!r} has no event path (E2VID and the "
            "SemSegE2VID head): serving needs frame2voxel or recon2voxel")
    dev = resolve_device(device)
    dt = compute_dtype(s)
    text = torch.from_numpy(
        load_text_embeddings(s, np.random.default_rng(seed)))

    modules, roles, groups = {}, {}, {}

    def add(name, module, role, group):
        modules[name], roles[name], groups[name] = module, role, group

    def event_path(linear_probe=False):
        add("front_sensor_b", E2VIDReconstructor(
            num_bins=s.input_channels_b, normalize=True, planar_input=True,
            latent_only=True, fused_gates=s.e2vid_fused_gates,
        ), "e2vid", "voxel")
        add("back_end", SemSegE2VID(
            input_c=256, num_classes=s.semseg_num_classes,
            linear_probe=linear_probe,
        ), "semseg_head", "voxel")

    def deeplab(name, group, linear_probe=False):
        add(name, DeepLabV3TextSeg(
            s.semseg_num_classes, output_stride=s.output_stride,
            linear_probe=linear_probe, fold_bn=s.student_fold_bn, dtype=dt,
        ), "deeplab", group)

    def teacher(name, group):
        add(name, DilationFeatureExtractor(
            dtype=dt, output_stride=s.teacher_os, fold_bn=s.teacher_fold_bn,
        ), "teacher", group)

    lp = s.if_linear_probing
    if event_path_only:
        event_path(lp and task in ("finetune", "linear_probe", "sup_only"))
    elif task == "pretrain":
        if opt == "frame2recon":
            deeplab("model_recon", "recon")
            teacher("model_frame", "frame")
        else:
            event_path()
            if opt == "recon2voxel":
                teacher("model_recon", "recon")
            else:
                teacher("model_frame", "frame")
    elif task in ("finetune", "linear_probe", "sup_only"):
        if opt in VOXEL_OPTIONS:
            event_path(lp)
        else:
            deeplab("model_recon", "recon", lp)
    else:  # openess (UDA)
        if opt == "frame2recon":
            deeplab("model_recon", "recon")
            deeplab("model_frame", "frame")
        else:
            event_path()
            if opt == "recon2voxel":
                deeplab("model_recon", "recon")
            else:
                deeplab("model_frame", "frame")

    gen = torch.Generator().manual_seed(seed)
    for m in modules.values():
        init_weights(m, gen)
    for name, m in modules.items():
        if roles[name] == "semseg_head":
            m.text_embeddings.copy_(text)
        elif roles[name] == "deeplab":
            m.classifier.text_embeddings.copy_(text)
    for name, m in modules.items():
        if roles[name] == "e2vid" and not e2vid_trains(s):
            # frozen: stored in the compute dtype
            m.to(device=dev, dtype=dt, memory_format=torch.channels_last)
        else:
            m.to(device=dev, memory_format=torch.channels_last)
    student = (modules["back_end"].text_embeddings if "back_end" in modules
               else modules["model_recon"].classifier.text_embeddings)
    mset = ModelSet(
        modules=modules, roles=roles, groups=groups,
        text_embeddings=student, task=task, dtype=dt, device=dev,
    )
    labels = trainable_labels(mset, s)
    for name, m in modules.items():
        for pname, p in m.named_parameters():
            p.requires_grad_(labels[f"{name}.{pname}"] != "frozen")
    return mset


def trainable_labels(mset: ModelSet, s: Settings) -> dict:
    """``{"<module>.<parameter>": label}`` with the optimizer-group label
    ('recon' / 'frame' / 'voxel') of every parameter, or 'frozen': E2VID
    unless it trains (:func:`e2vid_trains`), the teacher's ``encoder``,
    under ``if_linear_probing`` everything of the head and of the DeepLabV3
    students but ``linear_probe``, and under ``if_finetuning`` with
    ``frozen_backbone`` a student's ``backbone``; the rest trains in its
    module's group. ``frozen_backbone`` changes nothing on the event
    path."""
    labels = {}
    for name, m in mset.modules.items():
        role, group = mset.roles[name], mset.groups[name]
        for pname, _ in m.named_parameters():
            if role == "e2vid":
                label = group if e2vid_trains(s) else "frozen"
            elif role == "teacher" and pname.startswith("encoder"):
                label = "frozen"
            elif (role in ("semseg_head", "deeplab") and s.if_linear_probing
                  and "linear_probe" not in pname):
                label = "frozen"
            elif (role == "deeplab" and not s.if_linear_probing
                  and s.if_finetuning and s.frozen_backbone
                  and pname.startswith("backbone")):
                label = "frozen"
            else:
                label = group
            labels[f"{name}.{pname}"] = label
    return labels


@dataclasses.dataclass
class ServingModels:
    e2vid: E2VIDStreamingStep      # one window of front_sensor_b
    head: SemSegE2VID              # back_end
    text_embeddings: torch.Tensor  # [num_classes, 512]: the head's buffer
    dtype: torch.dtype
    device: torch.device


def serving_models(mset: ModelSet) -> ServingModels:
    """The event path of a model set, for inference: the one-window step
    of ``front_sensor_b`` and the head, both in the compute dtype, eval
    mode, no gradients. Converts the set's modules in place."""
    mods = []
    for m in (mset.modules["front_sensor_b"].streaming_step(),
              mset.modules["back_end"]):
        m = m.to(dtype=mset.dtype)
        mods.append(m.eval().requires_grad_(False))
    return ServingModels(
        e2vid=mods[0], head=mods[1], text_embeddings=mods[1].text_embeddings,
        dtype=mset.dtype, device=mset.device,
    )
