"""The FC-CLIP meta-architecture, open-vocabulary semantic inference: the
counterpart of ``openess_tpu/models/fcclip/meta.py``.

Reference: ``fc-clip/fcclip/fcclip.py``: the VILD prompt ensemble (:26-41),
the class names with their synonyms and the category-overlap mask
(:139-179), the text classifier (:186-218), the in/out-vocabulary geometric
ensemble (:345-402) and semantic inference (:463-467).

:class:`FCCLIP` holds the trunk, the projection head, the pixel decoder,
the transformer decoder, the void embedding and CLIP's logit scale under
the released checkpoint's names (``backbone.clip_model.visual.trunk.*``,
``backbone.clip_model.visual.head.mlp.*``, ``backbone.clip_model.logit_scale``,
``sem_seg_head.pixel_decoder.*``, ``sem_seg_head.predictor.*``,
``void_embedding.weight``), so the image half of a released ``model`` dict
loads with ``load_state_dict`` (``models/fcclip/convert.py``). ``forward``
is one image -> per-pixel class probability map; its stages are methods
of their own (:meth:`FCCLIP.encode_image`, the two decoders,
:meth:`FCCLIP.semantic_inference`) so that each can be timed.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from openess_tpu_torch.models.fcclip.backbone import (
    CLIP_EMBED_DIM,
    CONVNEXT_LARGE_DEPTHS,
    CONVNEXT_LARGE_DIMS,
    CLIPVisualProjection,
    ConvNeXtCLIPVisual,
)
from openess_tpu_torch.models.fcclip.pixel_decoder import (
    MSDeformAttnPixelDecoder,
)
from openess_tpu_torch.models.fcclip.transformer_decoder import (
    FCCLIPTransformerDecoder,
    get_classification_logits,
    mask_pooling,
)
from openess_tpu_torch.ops.resize import resize_bilinear

# fcclip.py:26-41
VILD_PROMPT = (
    "a photo of a {}.",
    "This is a photo of a {}",
    "There is a {} in the scene",
    "There is the {} in the scene",
    "a photo of a {} in the scene",
    "a photo of a small {}.",
    "a photo of a medium {}.",
    "a photo of a large {}.",
    "This is a photo of a small {}.",
    "This is a photo of a medium {}.",
    "This is a photo of a large {}.",
    "There is a small {} in the scene.",
    "There is a medium {} in the scene.",
    "There is a large {} in the scene.",
)

# the geometric ensemble's exponents on the out-of-vocabulary
# probabilities, for seen and unseen classes (fcclip.py's defaults)
ENSEMBLE_ALPHA, ENSEMBLE_BETA = 0.4, 0.8

# CLIP pixel statistics (config: PIXEL_MEAN/STD, RGB order)
PIXEL_MEAN = (122.7709383, 116.7460125, 104.09373615)
PIXEL_STD = (68.5005327, 66.6321579, 70.32316305)

# The 36-class user vocabulary the OpenESS pseudo-labels are generated with
# (demo/predictor.py:121-136); groups of synonyms map onto the 11 DSEC
# classes via the max-logit remap in the PL tool.
DSEC_USER_CLASSES = (
    "sky",
    "building", "house",
    "fence",
    "person", "pedestrian", "walking people", "standing people",
    "sitting people",
    "pole", "traffic sign pole", "light pole",
    "road",
    "sidewalk",
    "vegetation", "tree", "tree trunk", "woods",
    "grass",
    "car", "jeep", "SUV", "van", "caravan", "truck", "trailer",
    "bus", "train", "tram", "motorcycle", "scooter", "bicycle",
    "wall",
    "traffic-sign", "parking-sign", "direction-sign",
)

# The plain COCO-panoptic-133 category names, the default training
# vocabulary of the category-overlap (seen/unseen) test. The reference uses
# the openseg prompt-engineered variant (fcclip/data/datasets/
# openseg_classes.py, not in the OpenESS snapshot); pass
# ``train_class_names`` to reproduce it exactly.
COCO_PANOPTIC_CLASSES = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush", "banner",
    "blanket", "bridge", "cardboard", "counter", "curtain", "door-stuff",
    "floor-wood", "flower", "fruit", "gravel", "house", "light",
    "mirror-stuff", "net", "pillow", "platform", "playingfield", "railroad",
    "river", "road", "roof", "sand", "sea", "shelf", "snow", "stairs",
    "tent", "towel", "wall-brick", "wall-stone", "wall-tile", "wall-wood",
    "water-other", "window-blind", "window-other", "tree-merged",
    "fence-merged", "ceiling-merged", "sky-other-merged", "cabinet-merged",
    "table-merged", "floor-other-merged", "pavement-merged",
    "mountain-merged", "grass-merged", "dirt-merged", "paper-merged",
    "food-other-merged", "building-other-merged", "rock-merged",
    "wall-other-merged", "rug-merged",
)



def split_synonyms(class_names: Sequence[str]):
    """fcclip.py:140-146: each entry may hold comma-separated synonyms."""
    return [n.replace(", ", ",").split(",") for n in class_names]


def prepare_class_names(class_names: Sequence[str],
                        train_class_names: Sequence[str] = COCO_PANOPTIC_CLASSES):
    """fcclip.py:139-179. Returns (category_overlapping_mask [K] int32,
    num_templates [K] synonym counts, the templated prompts,
    ``sum(num_templates) * len(VILD_PROMPT)`` of them)."""
    groups = split_synonyms(class_names)
    train_set = {s for n in split_synonyms(train_class_names) for s in n}
    overlap = np.array(
        [int(not train_set.isdisjoint(set(g))) for g in groups], np.int32)
    num_templates = [len(g) for g in groups]
    prompts = [t.format(syn) for g in groups for syn in g for t in VILD_PROMPT]
    return overlap, num_templates, prompts


def fold_template_embeddings(embeddings: torch.Tensor) -> torch.Tensor:
    """fcclip.py:196-199: ``[R * len(VILD_PROMPT), C]`` raw text embeddings
    -> ``[R, C]`` classifier rows (normalize, mean over the templates,
    normalize)."""
    e = embeddings / torch.linalg.vector_norm(embeddings, dim=-1, keepdim=True)
    e = e.reshape(-1, len(VILD_PROMPT), e.shape[-1]).mean(dim=1)
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)


class _Node(nn.Module):
    """A named level of the released state dict's tree."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class FCCLIP(nn.Module):
    """The inference meta-architecture: ``forward(image [B, H, W, 3] in
    [0, 255] RGB, text_classifier [R, embed_dim], num_templates,
    category_overlap [K])`` -> per-pixel class probabilities ``[B, H, W,
    K]`` f32 (semantic_inference, fcclip.py:463-467, channels last).

    ``text_classifier`` is the folded class matrix
    (:func:`fold_template_embeddings`); the void row is appended from the
    model's ``void_embedding``. ``num_templates`` and ``category_overlap``
    come from :func:`prepare_class_names`. The architecture defaults are the
    released convnext_large_d_320 FC-CLIP's; ``models/fcclip/convert.
    fcclip_arch`` reads them off a state dict."""

    def __init__(self, trunk_depths: Sequence[int] = CONVNEXT_LARGE_DEPTHS,
                 trunk_dims: Sequence[int] = CONVNEXT_LARGE_DIMS,
                 clip_embed_dim: int = CLIP_EMBED_DIM, conv_dim: int = 256,
                 mask_dim: int = 256, num_queries: int = 250,
                 dec_layers: int = 9, enc_layers: int = 6, n_heads: int = 8,
                 enc_ff: int = 1024, dec_ff: int = 2048, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = tuple(trunk_dims)
        trunk = ConvNeXtCLIPVisual(trunk_depths, dims, dtype)
        projection = CLIPVisualProjection(dims[-1], clip_embed_dim, dtype)
        # the projection's norm is the trunk's head norm in the released tree
        trunk.head = _Node(norm=projection.norm)
        self.backbone = _Node(clip_model=_Node(
            visual=_Node(trunk=trunk, head=_Node(mlp=projection.mlp)),
            logit_scale=nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))))
        self.sem_seg_head = _Node(
            pixel_decoder=MSDeformAttnPixelDecoder(
                in_channels=dims, conv_dim=conv_dim, mask_dim=mask_dim,
                n_heads=n_heads, dim_feedforward=enc_ff,
                enc_layers=enc_layers, dtype=dtype),
            predictor=FCCLIPTransformerDecoder(
                hidden_dim=conv_dim, num_queries=num_queries, n_heads=n_heads,
                dim_feedforward=dec_ff, dec_layers=dec_layers,
                mask_dim=mask_dim, clip_embedding_dim=clip_embed_dim,
                dtype=dtype))
        self.void_embedding = nn.Embedding(1, clip_embed_dim)
        nn.init.normal_(self.void_embedding.weight, std=0.02)
        # not registered: its modules already are, under the released names
        self.__dict__["visual_projection"] = projection

    @property
    def trunk(self) -> ConvNeXtCLIPVisual:
        return self.backbone.clip_model.visual.trunk

    def encode_image(self, image):
        """``image [B, H, W, 3]`` in [0, 255] -> the trunk's feature dict."""
        mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32,
                            device=image.device)
        std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=image.device)
        return self.trunk((image.float() - mean) / std)

    def classifier(self, text_classifier):
        """The folded class rows and the normalized void row, f32."""
        void = self.void_embedding.weight
        return torch.cat([text_classifier.float(), void / torch.linalg.
                          vector_norm(void, dim=-1, keepdim=True)], dim=0)

    def semantic_inference(self, features, out, tc, num_templates,
                           category_overlap, size):
        """The geometric ensemble (fcclip.py:345-402), the void
        reweighting, the upsample to ``size`` and semantic inference
        (:404-410, :463-467) -> ``[B, H, W, K]`` f32."""
        mask_cls = out["pred_logits"].float()  # [B, Q, K+1]
        mask_pred = out["pred_masks"].float()  # [B, Q, h4, w4]

        pooled = mask_pooling(features["clip_vis_dense"], mask_pred)
        pooled = self.visual_projection(pooled.to(self.dtype)).float()
        out_vocab = get_classification_logits(
            pooled, tc, self.backbone.clip_model.logit_scale, num_templates)
        in_vocab_probs = torch.softmax(mask_cls[..., :-1], dim=-1)
        out_vocab_probs = torch.softmax(out_vocab[..., :-1], dim=-1)

        overlap = torch.as_tensor(category_overlap, device=mask_cls.device
                                  ).float()
        alpha, beta = ENSEMBLE_ALPHA, ENSEMBLE_BETA
        seen = torch.log(in_vocab_probs ** (1 - alpha)
                         * out_vocab_probs ** alpha + 1e-30) * overlap
        unseen = torch.log(in_vocab_probs ** (1 - beta)
                           * out_vocab_probs ** beta + 1e-30) * (1 - overlap)
        cls_results = seen + unseen

        is_void = torch.softmax(mask_cls, dim=-1)[..., -1:]
        probs = torch.cat([torch.softmax(cls_results, dim=-1) * (1.0 - is_void),
                           is_void], dim=-1)
        mask_cls = torch.log(probs + 1e-8)

        H, W = size
        m = resize_bilinear(mask_pred.permute(0, 2, 3, 1), out_h=H, out_w=W,
                            align_corners=False)
        return torch.einsum("bqk,bhwq->bhwk",
                            torch.softmax(mask_cls, dim=-1)[..., :-1],
                            torch.sigmoid(m))

    def forward(self, image, text_classifier, num_templates,
                category_overlap):
        features = self.encode_image(image)
        tc = self.classifier(text_classifier)
        mask_features, ms_feats = self.sem_seg_head.pixel_decoder(features)
        out = self.sem_seg_head.predictor(ms_feats, mask_features, tc,
                                          num_templates)
        return self.semantic_inference(features, out, tc, num_templates,
                                       category_overlap, image.shape[1:3])
