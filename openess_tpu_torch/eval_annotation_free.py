"""Annotation-free (zero-shot) evaluation, the counterpart of
``tools/eval_annotation_free.py`` (BASELINE.md's 'MaskCLIP' row; the
reference's zero-shot protocol, README.md:376-377).

A frozen CLIP teacher segments the validation split's reconstructions
(``--source recon``) or frames (``--source frame``) and is scored by the
confusion matrix's mIoU and accuracy against the labels:

- ``--teacher maskclip``: ``models/maskclip.MaskClipFeatureExtractor``
  (bf16) on the settings' ``clip.maskclip_checkpoint``,
  ``visual_projs_path`` and ``text_embeddings_path`` (one text row per
  class), the argmax of its logits;
- ``--teacher fcclip``: the FC-CLIP labeler
  (``models/fcclip/labeler.build_fcclip_labeler``, bf16) on the released
  checkpoint (``--fcclip_ckpt``) and the CLIP merges file
  (``--bpe_vocab``): the 36-class vocabulary max-pooled into DSEC's 11 or
  DDD17's 6 classes (the dataset read off ``dataset.name_b``), which must
  be the settings' ``semseg_num_classes``.

The validation set runs in batches of ``batch_size``; the last batch is
padded to the full size with its last sample and the padded rows' labels
set to the ignore label, so every sample is scored once. Prints the
summary (per-class IoU, ``miou``, ``acc``, in percent).

    python -m openess_tpu_torch.eval_annotation_free \\
        --settings_file configs/.../eval.yaml --source recon

It runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np
import torch

from openess_tpu_torch import resolve_device
from openess_tpu_torch.config.settings import load_settings
from openess_tpu_torch.data.loaders import build_datasets
from openess_tpu_torch.generate_pseudo_labels import (
    build_maskclip,
    load_text_embeddings,
)
from openess_tpu_torch.metrics import MetricsSemseg
from openess_tpu_torch.models.fcclip.labeler import build_fcclip_labeler


def build_maskclip_infer(s, device):
    """``images [B, H, W, 3] in [0, 1] (numpy) -> class ids [B, H, W]`` (a
    tensor on ``device``)."""
    if not (s.maskclip_checkpoint and s.visual_projs_path
            and s.text_embeddings_path):
        raise SystemExit(
            "annotation-free eval needs clip.maskclip_checkpoint, "
            "visual_projs_path and text_embeddings_path in the settings yaml")
    model = build_maskclip(s.maskclip_checkpoint, s.visual_projs_path,
                           device)
    text = torch.from_numpy(load_text_embeddings(
        s.text_embeddings_path)).to(device)

    @torch.no_grad()
    def infer(img):
        logits = model(torch.as_tensor(img).to(device), text)
        return torch.argmax(logits, dim=-1)

    return infer


def build_fcclip_infer(s, fcclip_ckpt: str, bpe_vocab: str, device):
    """``images [B, H, W, 3] in [0, 1] (numpy) -> class ids [B, H, W]`` (a
    tensor on ``device``) through the FC-CLIP labeler of the settings'
    dataset."""
    dataset = "ddd17" if "DDD17" in s.dataset_name_b.upper() else "dsec"
    infer, num_classes = build_fcclip_labeler(fcclip_ckpt, bpe_vocab,
                                              dataset, device)
    if num_classes != s.semseg_num_classes:
        raise SystemExit(
            f"settings semseg_num_classes={s.semseg_num_classes} does not "
            f"match the {dataset} FC-CLIP remap ({num_classes} classes)")
    return infer


def evaluate(s, infer, source: str, device) -> dict:
    """The validation split through ``infer`` -> the metrics' summary."""
    _, val_ds = build_datasets(s, device)
    metrics = MetricsSemseg(s.semseg_num_classes, s.semseg_ignore_label,
                            s.semseg_class_names)
    bs, n = s.batch_size_b, len(val_ds)
    for i in range(0, n, bs):
        idx = list(range(i, min(i + bs, n)))
        pad = bs - len(idx)
        batch = val_ds.get_batch(idx + [idx[-1]] * pad)
        pred = infer(batch[source])
        label = np.array(batch["label"])
        label[len(idx):] = s.semseg_ignore_label
        metrics.update_batch(pred.cpu(), label)
    return metrics.get_metrics_summary()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings_file", required=True)
    ap.add_argument("--source", choices=["recon", "frame"], default="recon")
    ap.add_argument("--teacher", choices=["maskclip", "fcclip"],
                    default="maskclip")
    ap.add_argument("--fcclip_ckpt", help="released fcclip_cocopan.pth")
    ap.add_argument("--bpe_vocab", help="CLIP bpe_simple_vocab_16e6.txt.gz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    if args.teacher == "fcclip" and not (args.fcclip_ckpt and args.bpe_vocab):
        raise SystemExit("--teacher fcclip needs --fcclip_ckpt/--bpe_vocab")
    device = resolve_device(args.device)
    s = load_settings(args.settings_file, generate_log=False)
    if args.teacher == "fcclip":
        infer = build_fcclip_infer(s, args.fcclip_ckpt, args.bpe_vocab,
                                   device)
    else:
        infer = build_maskclip_infer(s, device)
    out = evaluate(s, infer, args.source, device)
    print({k: round(float(v), 2) for k, v in out.items() if k != "cm"})
    return out


if __name__ == "__main__":
    main()
