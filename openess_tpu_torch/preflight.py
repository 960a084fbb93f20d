"""Check the downloaded assets before a long run, the counterpart of
``tools/preflight.py`` (one line per asset, PASS or FAIL).

A checkpoint passes when the port's own converters (``models/convert.py``'s
``*_from_released``, ``models/fcclip/convert.py``) take the whole file and
what they give loads with ``load_state_dict(strict=True)`` into the port's
module, built on the meta device (no weights are drawn; the JAX tool uses
``jax.eval_shape``): every key there, every shape right, nothing left over.
FC-CLIP goes through the very load the tools run
(``convert_fcclip_checkpoint``, held to the released manifest, then
``build_fcclip``). Every file is read with ``torch.load(weights_only=True)``,
as the tools read it: tensors and plain containers only, so a file holding
other pickled objects fails here as it would fail there. ``--bpe`` builds the port's
tokenizer and checks the merge count and the start/end ids. ``--sam`` keeps
the JAX tool's structure check. A dataset root is checked against the trees
the port's loaders read (``data/dsec.py``, ``data/ddd17.py``).

  python -m openess_tpu_torch.preflight \\
      [--fcclip fcclip_cocopan.pth] [--bpe bpe_simple_vocab_16e6.txt.gz] \\
      [--e2vid E2VID_lightweight.pth.tar] [--dino dino_resnet50_pretrain.pth] \\
      [--maskclip_backbone ViT16_clip_backbone.pth] \\
      [--maskclip_weights ViT16_clip_weights.pth] \\
      [--text dsec_11_classes.pth] [--sam sam_vit_h_4b8939.pth] \\
      [--openess_ckpt Epoch_29.pt] \\
      [--dsec_root /data/DSEC] [--ddd17_root /data/DDD17] [--num_classes 11]

The exit code is 0 only if every asset given passes.
"""
import argparse
import glob
import gzip
import os
import sys

import numpy as np
import torch

from openess_tpu_torch.models.convert import (
    e2vid_state_dict_from_released,
    maskclip_state_dict_from_released,
    openess_state_dicts_from_released,
    teacher_state_dict_from_released,
)
from openess_tpu_torch.models.deeplabv3 import DeepLabV3TextSeg
from openess_tpu_torch.models.e2vid import E2VIDReconstructor
from openess_tpu_torch.models.fcclip.convert import (
    build_fcclip,
    convert_fcclip_checkpoint,
)
from openess_tpu_torch.models.image_teacher import DilationFeatureExtractor
from openess_tpu_torch.models.maskclip import MaskClipFeatureExtractor
from openess_tpu_torch.models.semseg_e2vid import SemSegE2VID

BPE_MERGES = 49152 - 256 - 2  # the tokenizer reads merges[1:48895]


def _torch_load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def load_strict(make, sd: dict, what: str):
    """``make()`` built on the meta device, ``sd`` loaded strictly into it;
    a ``ValueError`` names the keys and shapes at fault."""
    with torch.device("meta"):
        module = make()
    try:
        module.load_state_dict(sd, strict=True, assign=True)
    except RuntimeError as e:
        raise ValueError(f"{what}: {e}") from None


def _unconsumed(given, taken, ignore=()):
    left = sorted(k for k in set(given) - set(taken)
                  if not any(k.startswith(p) or k.endswith(p) for p in ignore))
    if left:
        raise ValueError(f"{len(left)} unconsumed keys: {left[:6]}...")


def check_fcclip(path):
    image_sd, text_sd = convert_fcclip_checkpoint(path)
    # the tensors are assigned, not copied: no second set of weights
    build_fcclip(image_sd, text_sd, "cpu", torch.float32)
    return (f"{len(image_sd) + len(text_sd)} inference keys match the "
            f"released fcclip_cocopan manifest; FCCLIP and its text tower "
            f"load strictly")


def check_bpe(path):
    with gzip.open(path, "rt", encoding="utf-8") as f:
        merges = f.read().split("\n")
    if len(merges) - 1 < BPE_MERGES:
        raise ValueError(
            f"only {len(merges) - 1} merge lines; need >= {BPE_MERGES}")
    bad = [m for m in merges[1:BPE_MERGES + 1] if len(m.split()) != 2]
    if bad:
        raise ValueError(f"{len(bad)} malformed merge lines, e.g. {bad[0]!r}")
    from openess_tpu_torch.models.fcclip.tokenizer import SimpleTokenizer

    tok = SimpleTokenizer(path)
    if (tok.sot, tok.eot) != (49406, 49407):
        raise ValueError(f"sot/eot ids {(tok.sot, tok.eot)} != (49406, 49407)")
    return (f"{BPE_MERGES} merges, vocab {len(tok.encoder)}, "
            f"sot/eot 49406/49407")


def check_e2vid(path):
    raw = _torch_load(path)
    sd = raw.get("state_dict", raw)
    got = e2vid_state_dict_from_released(sd)
    pre = "unetrecurrent."
    _unconsumed([k.removeprefix(pre) for k in sd],
                [k.removeprefix(pre) for k in got])
    load_strict(E2VIDReconstructor, got, "E2VIDReconstructor")
    return f"all {len(sd)} keys consumed; E2VIDReconstructor loads strictly"


def check_dino(path):
    raw = _torch_load(path)
    sd = raw.get("state_dict", raw)
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    got = teacher_state_dict_from_released(sd)
    # the fc head and the BatchNorms' trackers are not the encoder's
    _unconsumed(sd, [k.removeprefix("encoder.") for k in got],
                ignore=("fc.", "num_batches_tracked"))
    load_strict(lambda: DilationFeatureExtractor().encoder,
                {k.removeprefix("encoder."): v for k, v in got.items()},
                "the teacher's ResNet-50")
    return "resnet50 encoder loads strictly"


def check_maskclip(backbone_path, weights_path, num_classes):
    bsd = _torch_load(backbone_path)
    bsd = bsd.get("state_dict", bsd)
    wsd = _torch_load(weights_path)
    wsd = wsd.get("state_dict", wsd)
    if "proj" not in wsd or "weight" not in wsd["proj"]:
        raise ValueError("weights file lacks the visual proj "
                         "{'proj': {'weight': ...}} entry")
    got = maskclip_state_dict_from_released(bsd, wsd)
    load_strict(MaskClipFeatureExtractor, got, "MaskClipFeatureExtractor")
    return (f"ViT-B/16 + proj load strictly (text rows of "
            f"{got['proj.weight'].shape[0]} for {num_classes} classes)")


def check_text(path):
    t = _torch_load(path)
    if isinstance(t, dict):  # some releases wrap the tensor
        t = next(iter(t.values()))
    arr = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach") else t)
    if arr.ndim != 2 or arr.shape[1] != 512:
        raise ValueError(f"expected [num_classes, 512], got {arr.shape}")
    return f"text embeddings {arr.shape[0]} classes x 512"


def check_sam(path):
    sd = _torch_load(path)
    sd = sd.get("state_dict", sd)
    for prefix in ("image_encoder.", "prompt_encoder.", "mask_decoder."):
        if not any(k.startswith(prefix) for k in sd):
            raise ValueError(f"no keys under {prefix}")
    pe = sd.get("image_encoder.patch_embed.proj.weight")
    if pe is None or tuple(pe.shape) != (1280, 3, 16, 16):
        raise ValueError(
            "image_encoder.patch_embed.proj.weight is "
            f"{None if pe is None else tuple(pe.shape)}, want (1280, 3, 16, "
            "16): is this sam_vit_h_4b8939.pth?")
    return f"vit_h structure OK ({len(sd)} keys)"


def check_openess_ckpt(path):
    ckpt = _torch_load(path)
    known = {"front_sensor_b", "model_recon", "model_frame", "back_end"}
    found = sorted(known & set(ckpt))
    if not found:
        raise ValueError(
            f"no per-model state dicts (saver.py layout) in {sorted(ckpt)[:8]}")
    models = openess_state_dicts_from_released(ckpt)
    for name, sd in models.items():
        probe = "linear_probe.weight" in sd
        if name == "front_sensor_b":
            load_strict(E2VIDReconstructor, sd, name)
        elif name == "back_end":
            n = sd["text_embeddings"].shape[0] if "text_embeddings" in sd \
                else 11
            load_strict(lambda: SemSegE2VID(num_classes=n, linear_probe=probe),
                        {"text_embeddings": torch.zeros(n, 512), **sd}, name)
        else:
            n = sd["classifier.text_embeddings"].shape[0]
            load_strict(lambda: DeepLabV3TextSeg(n, linear_probe=probe), sd,
                        name)
    text = models.get("back_end", {}).get("text_embeddings")
    return (f"converted models: {', '.join(found)}, each loads strictly"
            + (f"; text embeddings {tuple(text.shape)}" if text is not None
               else ""))


def check_dsec_root(root, num_classes):
    from openess_tpu_torch.data.dsec import TRAIN_SEQUENCES, VAL_SEQUENCES

    problems = []
    n_seq = 0
    for split, names in (("train", TRAIN_SEQUENCES), ("test", VAL_SEQUENCES)):
        base = os.path.join(root, split)
        if not os.path.isdir(base):
            problems.append(f"missing {base}/")
            continue
        hits = [c for c in sorted(os.listdir(base))
                if any(n in c for n in names)]
        if not hits:
            problems.append(f"no {split} sequences matching the namelist "
                            f"under {base}")
        for c in hits:
            seq = os.path.join(base, c)
            for rel in ("semantic/semantic_timestamps.txt",
                        f"semantic/left/{num_classes}classes",
                        "events/left/events.h5",
                        "events/left/rectify_map.h5"):
                if not os.path.exists(os.path.join(seq, rel)):
                    problems.append(f"{c}: missing {rel}")
            n_seq += 1
    if problems:
        raise ValueError("; ".join(problems[:8]))
    return f"{n_seq} sequences, full tree present"


def check_ddd17_root(root):
    dirs = sorted(glob.glob(os.path.join(root, "dir*")))
    if len(dirs) < 6:
        raise ValueError(f"found {len(dirs)} dir*/ (need 6: the loader's "
                         "split table)")
    problems = []
    for d in dirs:
        for rel in ("events.dat.t", "events.dat.xyp", "index/index_50ms.npy",
                    "segmentation_masks"):
            if not os.path.exists(os.path.join(d, rel)):
                problems.append(f"{os.path.basename(d)}: missing {rel}")
        tp = os.path.join(d, "events.dat.t")
        if os.path.exists(tp) and os.path.getsize(tp) % 8:
            problems.append(f"{os.path.basename(d)}: events.dat.t size not "
                            "a multiple of int64")
    if problems:
        raise ValueError("; ".join(problems[:8]))
    return f"{len(dirs)} recording dirs, full tree present"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for flag in ("fcclip", "bpe", "e2vid", "dino", "maskclip_backbone",
                 "maskclip_weights", "text", "sam", "openess_ckpt",
                 "dsec_root", "ddd17_root"):
        ap.add_argument("--" + flag)
    ap.add_argument("--num_classes", type=int, default=11,
                    help="label-space size for the DSEC tree / maskclip "
                         "checks")
    args = ap.parse_args(argv)

    checks = []
    if args.fcclip:
        checks.append(("fcclip", lambda: check_fcclip(args.fcclip)))
    if args.bpe:
        checks.append(("bpe_vocab", lambda: check_bpe(args.bpe)))
    if args.e2vid:
        checks.append(("e2vid", lambda: check_e2vid(args.e2vid)))
    if args.dino:
        checks.append(("dino_r50", lambda: check_dino(args.dino)))
    if args.maskclip_backbone or args.maskclip_weights:
        if not (args.maskclip_backbone and args.maskclip_weights):
            ap.error("--maskclip_backbone and --maskclip_weights go together")
        checks.append(("maskclip", lambda: check_maskclip(
            args.maskclip_backbone, args.maskclip_weights, args.num_classes)))
    if args.text:
        checks.append(("text_embeddings", lambda: check_text(args.text)))
    if args.sam:
        checks.append(("sam", lambda: check_sam(args.sam)))
    if args.openess_ckpt:
        checks.append(("openess_ckpt",
                       lambda: check_openess_ckpt(args.openess_ckpt)))
    if args.dsec_root:
        checks.append(("dsec_root", lambda: check_dsec_root(
            args.dsec_root, args.num_classes)))
    if args.ddd17_root:
        checks.append(("ddd17_root", lambda: check_ddd17_root(args.ddd17_root)))
    if not checks:
        ap.error("no assets given: pass at least one (see --help)")

    failed = 0
    for name, fn in checks:
        try:
            print(f"PASS  {name:18s} {fn()}")
        except Exception as e:  # noqa: BLE001 (report it, check the rest)
            failed += 1
            print(f"FAIL  {name:18s} {type(e).__name__}: {e}")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
