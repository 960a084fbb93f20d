"""Convert released torch checkpoints into a weights file of the port, the
counterpart of ``tools/convert_torch_checkpoints.py``.

The reference ships ``E2VID_lightweight.pth.tar``, OpenESS ``Epoch_N.pt``
/ ``ckp.pt`` checkpoints, self-supervised ResNet-50 teacher weights and
CLIP text embeddings (``.pth``). This entry point takes them onto the
port's modules (``models/convert.py``) and writes one file,
``{"models": {module name: state dict}}``, that ``checkpoint.pretrained_file``
names in any config (``training/checkpoint.load_pretrained_params``: a
partial load, filtered by name and shape). Every file is read with
``torch.load(weights_only=True)``: tensors and plain containers only.

Examples:
  # stage-2 fine-tuning from a released stage-1 OpenESS checkpoint
  python -m openess_tpu_torch.convert_checkpoints \\
      --openess_ckpt Epoch_29.pt --e2vid E2VID_lightweight.pth.tar \\
      --out converted/openess_pretrain.pt

  # frozen frame teacher from DINO ResNet-50
  python -m openess_tpu_torch.convert_checkpoints \\
      --teacher_r50 dino_resnet50_pretrain.pth --teacher_name model_frame \\
      --out converted/dino_teacher.pt

  # CLIP text embeddings .pth -> .npy
  python -m openess_tpu_torch.convert_checkpoints \\
      --text_pth dsec_text_embeddings.pth --text_out dsec_text.npy
"""
import argparse
import os

import numpy as np
import torch

from openess_tpu_torch.models.convert import (
    e2vid_state_dict_from_released,
    openess_state_dicts_from_released,
    teacher_state_dict_from_released,
)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--openess_ckpt",
                    help="released OpenESS Epoch_N.pt / ckp.pt")
    ap.add_argument("--e2vid", help="E2VID_lightweight.pth.tar")
    ap.add_argument("--teacher_r50",
                    help="self-supervised ResNet-50 torch weights "
                         "(dino/moco/swav state_dict)")
    ap.add_argument("--teacher_name", default="model_frame",
                    choices=["model_frame", "model_recon"],
                    help="which teacher slot the R50 fills (frame2voxel/"
                         "frame2recon -> model_frame; recon2voxel -> "
                         "model_recon)")
    ap.add_argument("--text_pth", help="CLIP text embeddings .pth")
    ap.add_argument("--text_out", help="output .npy for --text_pth")
    ap.add_argument("--out", help="output weights file (.pt), for "
                                  "checkpoint.pretrained_file")
    args = ap.parse_args(argv)

    models = {}  # a later file's module replaces an earlier one's
    if args.openess_ckpt:
        models.update(openess_state_dicts_from_released(
            _load(args.openess_ckpt)))
        print(f"openess ckpt: models {sorted(models)}")
    if args.e2vid:
        raw = _load(args.e2vid)
        models["front_sensor_b"] = e2vid_state_dict_from_released(
            raw.get("state_dict", raw))
        print("e2vid: front_sensor_b loaded")
    if args.teacher_r50:
        sd = _load(args.teacher_r50)
        sd = sd.get("state_dict", sd)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        models[args.teacher_name] = teacher_state_dict_from_released(sd)
        print(f"teacher r50 -> {args.teacher_name}")
    if args.text_pth:
        emb = _load(args.text_pth).float().numpy()
        out = args.text_out or args.text_pth.rsplit(".", 1)[0] + ".npy"
        np.save(out, emb.astype(np.float32))
        print(f"text embeddings {emb.shape} -> {out}")
    if models:
        if not args.out:
            ap.error("--out is required when converting model weights")
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        torch.save({"models": models}, args.out)
        print(f"wrote {args.out} (use as checkpoint.pretrained_file)")


if __name__ == "__main__":
    main()
