"""Checkpoints in ``torch.save`` format, the counterpart of
``openess_tpu/training/checkpoint.py``.

Three flavours:
- full        models + optimizer state + step + epoch
              (``<dir>/ckpt_<epoch>.pt``, the newest three kept)
- model-only  per-epoch weights snapshot (``<dir>/epoch_<epoch>.pt``)
- partial     stage-to-stage transfer with shape filtering and name
              exclusion (:func:`load_pretrained_params`)

The model part is ``{module name: state_dict}`` of a ``ModelSet``. A
checkpoint whose model part is a superset of the current build's (extra
modules or keys) restores; a key the build needs and the checkpoint lacks
raises, and so does a shape mismatch. Values are copied into the existing
tensors, so the build's dtypes and devices stay.
"""
from __future__ import annotations

import glob
import os
import re

import torch

_KEEP = 3


def _model_part(mset) -> dict:
    return {
        name: {k: v.detach().cpu() for k, v in sd.items()}
        for name, sd in mset.state_dict().items()
    }


def save_checkpoint(ckpt_dir: str, mset, optimizer, step: int,
                    epoch: int) -> str:
    """Full training state; returns the file written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{epoch}.pt")
    torch.save({
        "models": _model_part(mset),
        "optimizer": optimizer.state_dict() if optimizer is not None else None,
        "step": int(step), "epoch": int(epoch),
    }, path)
    for old in _full_checkpoints(ckpt_dir)[:-_KEEP]:
        os.remove(old)
    return path


def save_model_only(ckpt_dir: str, mset, epoch: int) -> str:
    """Per-epoch weights snapshot; returns the file written."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"epoch_{epoch}.pt")
    torch.save({"models": _model_part(mset)}, path)
    return path


def _full_checkpoints(ckpt_dir: str) -> list:
    """``ckpt_<epoch>.pt`` files of a directory, oldest epoch first."""
    found = []
    for p in glob.glob(os.path.join(ckpt_dir, "ckpt_*.pt")):
        m = re.fullmatch(r"ckpt_(\d+)\.pt", os.path.basename(p))
        if m:
            found.append((int(m.group(1)), p))
    return [p for _, p in sorted(found)]


def _resolve(path: str) -> str:
    """A checkpoint file, or the newest full checkpoint of a directory."""
    if os.path.isdir(path):
        files = _full_checkpoints(path)
        if not files:
            raise FileNotFoundError(f"no ckpt_<epoch>.pt under {path!r}")
        return files[-1]
    return path


def _read(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def read_model_state(path: str) -> dict:
    """``{module name: state dict}`` of a checkpoint or weights snapshot (a
    file, or a directory's newest full checkpoint), on the CPU."""
    return _read(_resolve(path))["models"]


def _load_superset(mset, loaded: dict) -> None:
    """Copy ``loaded`` into the modules of ``mset``: extra modules and keys
    in ``loaded`` are ignored; a missing key or a shape mismatch raises."""
    for name, module in mset.modules.items():
        if name not in loaded:
            raise ValueError(f"checkpoint missing module '{name}'")
        src = loaded[name]
        own = module.state_dict()
        for key, target in own.items():
            if key not in src:
                raise ValueError(f"checkpoint missing leaf at '{name}.{key}'")
            if tuple(src[key].shape) != tuple(target.shape):
                raise ValueError(
                    f"checkpoint shape mismatch at '{name}.{key}': "
                    f"{tuple(src[key].shape)} vs {tuple(target.shape)}"
                )
        module.load_state_dict({k: src[k] for k in own}, strict=True)


def restore_checkpoint(path: str, mset, optimizer=None, *,
                       restore_optimizer: bool = False):
    """Resume from a full checkpoint (a file, or a directory's newest):
    restores the models and returns ``(step, epoch)``.

    ``restore_optimizer=False`` (the default) matches the reference, which
    does not restore optimizers on resume: the optimizer keeps its fresh
    state. Pass True for an exact continuation; that needs a checkpoint
    whose parameters are exactly the current build's."""
    raw = _read(_resolve(path))
    _load_superset(mset, raw["models"])
    if restore_optimizer:
        if optimizer is None or raw.get("optimizer") is None:
            raise ValueError(
                "restore_optimizer=True needs an optimizer and a checkpoint "
                "that holds one"
            )
        optimizer.load_state_dict(raw["optimizer"])
    return int(raw.get("step", 0)), int(raw.get("epoch", 0))


def load_model_only(path: str, mset) -> None:
    """Load a weights snapshot (or the model part of a full checkpoint)
    into the modules ``mset`` has."""
    _load_superset(mset, read_model_state(path))


def load_pretrained_params(path: str, mset, *, exclude_substrings=()) -> list:
    """Shape-filtered partial transfer: a leaf whose name matches an
    exclusion, that the file lacks, or whose shape differs keeps its fresh
    value; everything else loads from ``path``. Returns the names loaded."""
    loaded = read_model_state(path)
    taken = []
    for name, module in mset.modules.items():
        src = loaded.get(name, {})
        own = module.state_dict()
        pick = {}
        for key, target in own.items():
            full = f"{name}.{key}"
            if (key in src
                    and tuple(src[key].shape) == tuple(target.shape)
                    and not any(sub in full for sub in exclude_substrings)):
                pick[key] = src[key]
                taken.append(full)
        module.load_state_dict(pick, strict=False)
    return taken
