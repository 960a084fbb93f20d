"""FC-CLIP panoptic and instance inference, the counterpart of
``openess_tpu/models/fcclip/inference.py``.

Reference: ``fc-clip/fcclip/fcclip.py:468-524`` (``panoptic_inference``)
and ``:526-568`` (``instance_inference``). The reference paints a canvas
in a data-dependent loop over the kept queries and returns ragged lists;
the JAX package gives the same answers in static shapes, and so does this
module: every query in order gets a segment id (0 when it is dropped; a
stuff class reuses the id of its first segment), the canvas is the sum of
the disjoint argmax-winner masks, and validity flags stand in for the
dropped entries.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PanopticResult(NamedTuple):
    panoptic_seg: torch.Tensor  # [H, W] int32 segment ids (0 = unassigned)
    segment_id: torch.Tensor    # [Q] int32 id per query (0 = none)
    category: torch.Tensor      # [Q] int32 predicted class per query
    isthing: torch.Tensor       # [Q] bool
    info_valid: torch.Tensor    # [Q] bool: True where a NEW segments_info
    #                             entry was emitted (a stuff reuse is not)


def panoptic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor,
                       thing_mask, *, object_mask_threshold: float = 0.8,
                       overlap_threshold: float = 0.8) -> PanopticResult:
    """One image's panoptic segmentation (fcclip.py:468-524).

    ``mask_cls [Q, K+1]`` class logits (the last column void), ``mask_pred
    [Q, H, W]`` mask logits, ``thing_mask`` bool ``[K]``: True for the
    "thing" classes."""
    num_classes = mask_cls.shape[-1] - 1
    probs = torch.softmax(mask_cls.float(), dim=-1)
    scores = probs.amax(dim=-1)
    labels = probs.argmax(dim=-1)  # the first of equal maxima, as JAX's
    keep = (labels != num_classes) & (scores > object_mask_threshold)

    sig = torch.sigmoid(mask_pred.float())  # [Q, H, W]
    # a query that is not kept never wins the argmax (the reference indexes
    # the kept subset); with none kept the argmax is 0 and no query is valid
    prob_masks = torch.where(keep[:, None, None], scores[:, None, None] * sig,
                             torch.tensor(-torch.inf, device=sig.device))
    mask_ids = torch.argmax(prob_masks, dim=0)  # [H, W]

    q = mask_cls.shape[0]
    qi = torch.arange(q, device=mask_cls.device)
    win = mask_ids[None] == qi[:, None, None]  # [Q, H, W]
    binary = sig >= 0.5
    seg_mask = win & binary
    mask_area = win.sum(dim=(1, 2))
    orig_area = binary.sum(dim=(1, 2))
    bin_area = seg_mask.sum(dim=(1, 2))
    ratio = mask_area / orig_area.clamp(min=1)
    valid = (keep & (mask_area > 0) & (orig_area > 0) & (bin_area > 0)
             & (ratio >= overlap_threshold))

    safe_labels = labels.clamp(0, num_classes - 1)
    thing = torch.as_tensor(thing_mask, dtype=torch.bool,
                            device=mask_cls.device)
    isthing = thing[safe_labels] & valid

    # the JAX scan over the queries, in order
    seg_ids, fresh = [], []
    next_id, stuff_ids = 0, [0] * num_classes
    for v, cls, th in zip(valid.tolist(), safe_labels.tolist(),
                          isthing.tolist()):
        reuse = stuff_ids[cls] > 0 and not th
        new_id = (stuff_ids[cls] if reuse else next_id + 1) if v else 0
        is_new = v and not reuse
        if is_new:
            next_id += 1
            if not th:
                stuff_ids[cls] = new_id
        seg_ids.append(new_id)
        fresh.append(is_new)
    seg_ids = torch.tensor(seg_ids, dtype=torch.int32, device=mask_cls.device)
    canvas = (seg_ids[:, None, None] * seg_mask.int()).sum(dim=0)
    return PanopticResult(
        panoptic_seg=canvas.int(),
        segment_id=seg_ids,
        category=safe_labels.int(),
        isthing=isthing,
        info_valid=torch.tensor(fresh, dtype=torch.bool,
                                device=mask_cls.device))


class InstanceResult(NamedTuple):
    pred_masks: torch.Tensor    # [topk, H, W] float32 binary masks
    pred_classes: torch.Tensor  # [topk] int32
    scores: torch.Tensor        # [topk] float32 (class score x mean mask prob)
    valid: torch.Tensor         # [topk] bool (False: a non-thing detection
    #                             with panoptic_on; the reference drops it)


def instance_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor, *,
                       topk: int, thing_mask: Optional[torch.Tensor] = None
                       ) -> InstanceResult:
    """One image's instance segmentation (fcclip.py:526-568): the top
    ``topk`` of the Q*K class scores, the lower flat index first among
    equal scores (as ``lax.top_k``). ``thing_mask`` (bool ``[K]``) marks
    non-thing detections ``valid=False``, where the reference drops
    them."""
    num_classes = mask_cls.shape[-1] - 1
    scores = torch.softmax(mask_cls.float(), dim=-1)[:, :-1]
    flat = scores.reshape(-1)  # [Q * K]
    top_scores, top_idx = torch.sort(flat, descending=True, stable=True)
    top_scores, top_idx = top_scores[:topk], top_idx[:topk]
    labels = top_idx % num_classes
    query = top_idx // num_classes

    masks = mask_pred[query].float()  # [topk, H, W]
    binary = (masks > 0).float()
    mask_scores = (torch.sigmoid(masks) * binary).sum(dim=(1, 2)) / (
        binary.sum(dim=(1, 2)) + 1e-6)
    if thing_mask is not None:
        valid = torch.as_tensor(thing_mask, dtype=torch.bool,
                                device=labels.device)[labels]
    else:
        valid = torch.ones_like(labels, dtype=torch.bool)
    return InstanceResult(pred_masks=binary, pred_classes=labels.int(),
                          scores=top_scores * mask_scores, valid=valid)
