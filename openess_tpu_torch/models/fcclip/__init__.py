"""FC-CLIP, the open-vocabulary teacher of OpenESS's annotation-free
pseudo-labels (reference: fc-clip/fcclip/*), the counterpart of
``openess_tpu/models/fcclip/``: the CLIP ConvNeXt-L backbone and text
tower, the MSDeformAttn pixel decoder, the masked transformer decoder, the
meta-architecture's open-vocabulary inference, panoptic and instance
inference, the CLIP tokenizer, the released checkpoint's manifest and
converters, and the labeler the offline tools share."""
from openess_tpu_torch.models.fcclip.backbone import (
    CLIPTextEncoder,
    CLIPVisualProjection,
    ConvNeXtCLIPVisual,
)
from openess_tpu_torch.models.fcclip.convert import (
    build_fcclip,
    convert_fcclip_checkpoint,
    fcclip_arch,
    fcclip_state_dict_from_jax,
    fcclip_state_dicts_from_released,
    load_fcclip,
    text_arch,
)
from openess_tpu_torch.models.fcclip.inference import (
    instance_inference,
    panoptic_inference,
)
from openess_tpu_torch.models.fcclip.labeler import (
    DATASET_REMAP,
    USER_TO_DDD17,
    USER_TO_DSEC,
    build_fcclip_labeler,
    maxpool_argmax,
)
from openess_tpu_torch.models.fcclip.meta import (
    DSEC_USER_CLASSES,
    FCCLIP,
    VILD_PROMPT,
    fold_template_embeddings,
    prepare_class_names,
)
from openess_tpu_torch.models.fcclip.pixel_decoder import (
    MSDeformAttnPixelDecoder,
)
from openess_tpu_torch.models.fcclip.tokenizer import SimpleTokenizer
from openess_tpu_torch.models.fcclip.transformer_decoder import (
    FCCLIPTransformerDecoder,
    get_classification_logits,
    mask_pooling,
)

__all__ = [
    "CLIPTextEncoder",
    "CLIPVisualProjection",
    "ConvNeXtCLIPVisual",
    "DATASET_REMAP",
    "DSEC_USER_CLASSES",
    "FCCLIP",
    "FCCLIPTransformerDecoder",
    "MSDeformAttnPixelDecoder",
    "SimpleTokenizer",
    "USER_TO_DDD17",
    "USER_TO_DSEC",
    "VILD_PROMPT",
    "build_fcclip",
    "build_fcclip_labeler",
    "convert_fcclip_checkpoint",
    "fcclip_arch",
    "fcclip_state_dict_from_jax",
    "fcclip_state_dicts_from_released",
    "fold_template_embeddings",
    "get_classification_logits",
    "instance_inference",
    "load_fcclip",
    "mask_pooling",
    "maxpool_argmax",
    "panoptic_inference",
    "prepare_class_names",
    "text_arch",
]
