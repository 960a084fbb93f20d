"""The open-vocabulary labelers: the FC-CLIP labeler that the offline
pseudo-label tool and the annotation-free evaluator share, and the
vocabulary remaps, the counterpart of
``openess_tpu/models/fcclip/labeler.py``.

Reference contracts:

- DSEC: ``fc-clip/demo/generate_pl_dsec.py:104-127``, the 36-class
  extended vocabulary max-pooled onto the 11 DSEC classes;
- DDD17: ``fc-clip/demo/generate_pl_ddd17.py:106-130``, the same
  vocabulary (demo/predictor.py:121-136) with a 34-entry remap onto the 6
  DDD17 classes: the reference loops ``range(len(user_to_ddd17))``, so the
  last two vocabulary entries take no part, and :func:`maxpool_argmax`
  reads only the first ``len(remap)`` channels.
"""
from __future__ import annotations

import numpy as np
import torch

from openess_tpu_torch import resolve_device
from openess_tpu_torch.models.fcclip.convert import load_fcclip
from openess_tpu_torch.models.fcclip.meta import (
    DSEC_USER_CLASSES,
    PIXEL_MEAN,
    fold_template_embeddings,
    prepare_class_names,
)
from openess_tpu_torch.models.fcclip.tokenizer import SimpleTokenizer

# extended-vocabulary index -> DSEC class (generate_pl_dsec.py:104-116)
USER_TO_DSEC = np.array(
    [0,
     1, 1,
     2,
     3, 3, 3, 3, 3,
     4, 4, 4,
     5,
     6,
     7, 7, 7, 7, 7,
     8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
     9,
     10, 10, 10]
)

# extended-vocabulary index -> DDD17 class (generate_pl_ddd17.py:106-115;
# 34 entries: vocabulary entries 34 and 35 are not remapped)
USER_TO_DDD17 = np.array(
    [0, 0,
     1, 1,
     2, 2, 2, 2, 2, 2, 2,
     3, 3, 3, 3, 3,
     4, 4, 4, 4, 4,
     5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5]
)

DATASET_REMAP = {
    "dsec": (USER_TO_DSEC, 11),
    "ddd17": (USER_TO_DDD17, 6),
}


def maxpool_argmax(scores: torch.Tensor, remap, num_classes: int):
    """Vocabulary scores ``[..., V]`` -> uint8 class labels ``[...]``: each
    class takes the max of the first ``len(remap)`` channels remapped to it
    (-inf where none is), then the argmax, the first of equal maxima."""
    remap = np.asarray(remap)
    if not ((0 <= remap) & (remap < num_classes)).all():
        raise ValueError(f"remap outside [0, {num_classes})")
    out = torch.full(scores.shape[:-1] + (num_classes,), -torch.inf,
                     dtype=scores.dtype, device=scores.device)
    for user_idx, c in enumerate(remap.tolist()):
        out[..., c] = torch.maximum(out[..., c], scores[..., user_idx])
    return torch.argmax(out, dim=-1).to(torch.uint8)


TEXT_CHUNK = 256  # prompts a text-tower call, as the JAX labeler


def text_classifier(text_encoder, tokens: np.ndarray) -> torch.Tensor:
    """The folded ``[K', embed]`` class rows (f32) of the VILD prompts'
    ``tokens``, the text tower run on ``TEXT_CHUNK`` prompts at a time."""
    device = next(text_encoder.parameters()).device
    with torch.no_grad():
        chunks = [text_encoder(torch.from_numpy(tokens[i:i + TEXT_CHUNK])
                               .to(device))
                  for i in range(0, len(tokens), TEXT_CHUNK)]
    return fold_template_embeddings(torch.cat(chunks).float())


def pad_to_32(img: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 255] padded at the bottom and right to
    multiples of 32 with the pixel mean: the reference pads after the
    mean/std normalization (detectron2's ImageList zero pad)."""
    h, w = img.shape[1], img.shape[2]
    mean = torch.tensor(PIXEL_MEAN, dtype=img.dtype, device=img.device)
    x = torch.nn.functional.pad((img - mean).permute(0, 3, 1, 2),
                                (0, (-w) % 32, 0, (-h) % 32))
    return x.permute(0, 2, 3, 1) + mean


def build_fcclip_labeler(fcclip_ckpt: str, bpe_vocab: str, dataset: str,
                         device=None, dtype=torch.bfloat16):
    """``infer(image [B, H, W, 3] in [0, 1], numpy or tensor) -> uint8
    labels [B, H, W]`` (a tensor on ``device``) and the class count: the
    FC-CLIP meta-architecture in ``dtype`` over the 36-class extended
    vocabulary, max-pooled into ``dataset``'s classes ('dsec' -> 11,
    'ddd17' -> 6). The checkpoint is held to the released manifest first;
    the 504-prompt text classifier is built once. Runs on the card unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    remap, num_classes = DATASET_REMAP[dataset]
    model, text = load_fcclip(fcclip_ckpt, device, dtype)
    overlap, num_templates, prompts = prepare_class_names(DSEC_USER_CLASSES)
    tokens = SimpleTokenizer(bpe_vocab)(prompts)
    tc = text_classifier(text, tokens)
    del text
    nt = tuple(num_templates)

    @torch.no_grad()
    def infer(img):
        img = torch.as_tensor(img).to(device, torch.float32)
        h, w = img.shape[1], img.shape[2]
        sem = model(pad_to_32(img * 255.0), tc, nt, overlap)
        return maxpool_argmax(sem[:, :h, :w], remap, num_classes)

    return infer, num_classes
