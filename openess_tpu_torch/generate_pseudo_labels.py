"""Offline open-vocabulary pseudo-labels, the counterpart of
``tools/generate_pseudo_labels.py`` (reference:
``fc-clip/demo/generate_pl_dsec.py``, which max-pools a 36-class extended
vocabulary onto the 11 DSEC classes, :104-127, and writes argmax PNGs to
``pl_fcclip_rgb/``).

``--teacher fcclip`` (the default, the reference's teacher): the FC-CLIP
meta-architecture (``models/fcclip``, bf16) on the released checkpoint
(``--fcclip_ckpt fcclip_cocopan.pth``, held to the released manifest
first), its VILD prompt ensemble over the 36-class vocabulary built by the
checkpoint's own CLIP text tower (``--bpe_vocab
bpe_simple_vocab_16e6.txt.gz``, the CLIP merges file), max-pooled into the
dataset's classes (``models/fcclip/labeler.build_fcclip_labeler``).

``--teacher maskclip``: the dense MaskCLIP labeler
(``models/maskclip.MaskClipFeatureExtractor``, bf16) on the released
``--clip_ckpt`` (``ViT16_clip_backbone.pth``) and ``--visual_projs``
(``ViT16_clip_weights.pth``), against ``--text_embeddings`` (``.npy`` or
``.pth``, one row per vocabulary entry); the dataset's remap
(``models/fcclip/labeler.DATASET_REMAP``) is cut to the vocabulary's
length.

Every ``images_aligned`` frame of a DSEC or DDD17 tree gets a uint8 PNG
under ``--out_name`` in its place; existing outputs are skipped;
``--shard/--num_shards`` splits the frames between processes.

    python -m openess_tpu_torch.generate_pseudo_labels --root /data/DSEC \\
        --fcclip_ckpt fcclip_cocopan.pth \\
        --bpe_vocab bpe_simple_vocab_16e6.txt.gz

    python -m openess_tpu_torch.generate_pseudo_labels --root /data/DSEC \\
        --teacher maskclip --clip_ckpt ViT16_clip_backbone.pth \\
        --visual_projs ViT16_clip_weights.pth \\
        --text_embeddings dsec_text_embeddings.pth --out_name pl_maskclip

It runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os

import numpy as np
import torch

from openess_tpu_torch import resolve_device
from openess_tpu_torch.data.png import frame_paths
from openess_tpu_torch.models.convert import (
    maskclip_arch,
    maskclip_state_dict_from_released,
)
from openess_tpu_torch.models.fcclip.labeler import (
    DATASET_REMAP,
    build_fcclip_labeler,
    maxpool_argmax,
)
from openess_tpu_torch.models.maskclip import MaskClipFeatureExtractor


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_text_embeddings(path: str) -> np.ndarray:
    """Text embeddings ``[V, D]`` f32 from a ``.npy`` or a torch ``.pth``."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    return _load(path).float().numpy()


def build_maskclip(clip_ckpt: str, visual_projs: str, device,
                   dtype=torch.bfloat16) -> MaskClipFeatureExtractor:
    """The released MaskCLIP files -> the extractor on ``device``, computing
    in ``dtype``, in eval mode."""
    backbone = _load(clip_ckpt)
    sd = maskclip_state_dict_from_released(
        backbone.get("state_dict", backbone), _load(visual_projs))
    model = MaskClipFeatureExtractor(dtype=dtype, **maskclip_arch(sd))
    model.load_state_dict(sd)
    return model.to(device).eval()


def build_maskclip_infer(args, device):
    """``image [1, H, W, 3] in [0, 1] (numpy) -> uint8 labels [1, H, W]``
    (numpy): the vocabulary's logits max-pooled into the dataset's
    classes."""
    text = torch.from_numpy(load_text_embeddings(args.text_embeddings))
    remap = DATASET_REMAP[args.dataset][0][:text.shape[0]]
    model = build_maskclip(args.clip_ckpt, args.visual_projs, device)
    text = text.to(device)

    @torch.no_grad()
    def infer(img):
        logits = model(torch.from_numpy(img).to(device), text)
        return maxpool_argmax(logits, remap, args.num_classes).cpu().numpy()

    return infer


def build_fcclip_infer(args, device):
    """``image [1, H, W, 3] in [0, 1] (numpy) -> uint8 labels [1, H, W]``
    (numpy) through the FC-CLIP labeler; ``--num_classes`` must be the
    dataset remap's."""
    infer, num_classes = build_fcclip_labeler(
        args.fcclip_ckpt, args.bpe_vocab, args.dataset, device)
    if num_classes != args.num_classes:
        raise SystemExit(f"--num_classes {args.num_classes} does not match "
                         f"the {args.dataset} remap ({num_classes} classes)")
    return lambda img: infer(img).cpu().numpy()


def main(argv=None):
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--dataset", choices=["dsec", "ddd17"], default="dsec")
    ap.add_argument("--teacher", choices=["fcclip", "maskclip"],
                    default="fcclip")
    ap.add_argument("--fcclip_ckpt", help="released fcclip_cocopan.pth")
    ap.add_argument("--bpe_vocab", help="CLIP bpe_simple_vocab_16e6.txt.gz")
    ap.add_argument("--clip_ckpt")
    ap.add_argument("--visual_projs")
    ap.add_argument("--text_embeddings",
                    help="extended-vocabulary CLIP text embeddings .pth/.npy")
    ap.add_argument("--num_classes", type=int, default=None,
                    help="the dataset's class count (11/6) by default")
    ap.add_argument("--out_name", default="pl_fcclip_rgb")
    ap.add_argument("--shard", type=int, default=0)
    ap.add_argument("--num_shards", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.num_classes is None:
        args.num_classes = DATASET_REMAP[args.dataset][1]

    if args.teacher == "fcclip":
        if not (args.fcclip_ckpt and args.bpe_vocab):
            raise SystemExit("--teacher fcclip needs --fcclip_ckpt and "
                             "--bpe_vocab")
        infer = build_fcclip_infer(args, resolve_device(args.device))
    else:
        if not (args.clip_ckpt and args.visual_projs
                and args.text_embeddings):
            raise SystemExit("--teacher maskclip needs --clip_ckpt/"
                             "--visual_projs/--text_embeddings")
        infer = build_maskclip_infer(args, resolve_device(args.device))

    paths = frame_paths(args.dataset, args.root)
    for i, p in enumerate(paths[args.shard::args.num_shards]):
        if args.dataset == "dsec":
            parts = p.split(os.sep)
            parts[-3] = args.out_name  # images_aligned -> the labels' dir
            op = os.sep.join(parts)
        else:
            op = p.replace("/images_aligned/", f"/{args.out_name}/")
        if os.path.exists(op):
            continue
        img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        pl = infer(img[None])[0]
        os.makedirs(os.path.dirname(op), exist_ok=True)
        Image.fromarray(pl).save(op)
        if i % 20 == 0:
            print(f"[{args.shard}] {i} {op}")


if __name__ == "__main__":
    main()
