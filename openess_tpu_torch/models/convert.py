"""Weights from elsewhere -> ``state_dict``s of the port's modules.

Two sources:

- **JAX (flax) parameter trees** (``*_state_dict_from_jax``): the inverse
  of ``openess_tpu/models/torch_convert.py`` ``convert_e2vid``,
  ``convert_semseg_e2vid``, ``convert_dilation_teacher`` and
  ``convert_deeplab``; the trees are nested dicts of numpy arrays.
- **The released torch files** (``*_state_dict_from_released``,
  :func:`openess_state_dicts_from_released`): ``E2VID_lightweight.pth.tar``,
  the OpenESS ``Epoch_N.pt`` / ``ckp.pt`` checkpoints, a self-supervised
  ResNet-50 (DINO, MoCo) and, through ``convert_checkpoints``, the CLIP
  text embeddings ``.pth``. The port's modules keep the reference's
  module names, so a released state dict needs no transposes and no
  renames; what the conversion does is a prefix (``unetrecurrent.`` on
  E2VID, ``encoder.`` on the teacher, ``module.`` off a DataParallel
  save), a dtype (every tensor to f32 on the CPU) and a selection: the
  keys the JAX converters read, and no others. So the trackers
  ``num_batches_tracked``, a classifier ``fc.*`` or ``aux_classifier.*``
  are dropped, and a key the file lacks (the teacher's ``decoder_conv``,
  a head's ``text_embeddings``) is left out and keeps the build's value
  under ``checkpoint.load_pretrained_params``. The text embeddings travel
  inside ``back_end`` (``text_embeddings``) and ``model_recon`` /
  ``model_frame`` (``classifier.text_embeddings``), where the released
  files keep them. Nothing else differs from the JAX conversion, which a
  test holds bit for bit.

The state-dict keys are the reference's. Layout rules of the JAX trees:

- conv            flax HWIO ``[kh, kw, I, O]`` -> torch OIHW ``[O, I, kh, kw]``
- transposed conv ``ConvTranspose2dTorch`` ``[kh, kw, O, I]`` ->
  torch ``ConvTranspose2d`` ``[I, O, kh, kw]`` (no flip: the JAX module
  flips at apply time)
- BatchNorm       flax ``scale``/``bias`` params and ``mean``/``var`` batch
  stats -> torch ``weight``/``bias``/``running_mean``/``running_var``
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable copy


def _conv(sd: dict, name: str, p: dict):
    sd[name + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[name + ".bias"] = _t(p["bias"])


def e2vid_state_dict_from_jax(params: dict, prefix: str = "unetrecurrent.") -> dict:
    """E2VID params -> ``state_dict`` of :class:`E2VIDStreamingStep` /
    :class:`E2VIDReconstructor` (keys under ``prefix``; pass ``""`` for a
    bare :class:`UNetRecurrent`).

    ``params`` is the UNet tree (``head``, ``encoders_{i}/conv``, ...) or a
    tree that holds it as ``step/unet`` (the streaming step, the
    reconstructor and ``build_models``' ``front_sensor_b``). A latent-only
    tree has no decode path and gives no decode keys.
    """
    if "step" in params:
        params = params["step"]["unet"]
    sd: dict = {}
    _conv(sd, prefix + "head.conv2d", params["head"]["conv2d"])
    i = 0
    while f"encoders_{i}/conv" in params:
        e = f"{prefix}encoders.{i}."
        _conv(sd, e + "conv.conv2d", params[f"encoders_{i}/conv"]["conv2d"])
        _conv(sd, e + "recurrent_block.Gates",
              params[f"encoders_{i}/lstm"]["gates"])
        i += 1
    i = 0
    while f"resblocks_{i}" in params:
        for c in ("conv1", "conv2"):
            _conv(sd, f"{prefix}resblocks.{i}.{c}", params[f"resblocks_{i}"][c])
        i += 1
    i = 0
    while f"decoders_{i}" in params:
        p = params[f"decoders_{i}"]
        name = f"{prefix}decoders.{i}.transposed_conv2d"
        sd[name + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        sd[name + ".bias"] = _t(p["bias"])
        i += 1
    if "pred" in params:
        _conv(sd, prefix + "pred.conv2d", params["pred"]["conv2d"])
    return sd


def semseg_state_dict_from_jax(params: dict, text) -> dict:
    """SemSegE2VID params and text embeddings ``[C, 512]`` -> ``state_dict``
    of :class:`SemSegE2VID` (with ``linear_probe.*`` when the tree has
    it)."""
    sd: dict = {}
    for i in range(5):
        r = params[f"ds1_res{i}"]
        _conv(sd, f"decoder_scale_1.{i}.model.0", r["conv1"])
        _conv(sd, f"decoder_scale_1.{i}.model.3", r["conv2"])
    for jax_name, torch_name in (
        ("ds1_conv", "decoder_scale_1.5"),
        ("ds2_conv1", "decoder_scale_2.0"),
        ("ds2_conv2", "decoder_scale_2.1"),
        ("ds3_conv1", "decoder_scale_3.0"),
        ("ds3_conv2", "decoder_scale_3.1"),
        ("ds4_conv", "decoder_scale_4.0"),
    ):
        _conv(sd, torch_name + ".model.0", params[jax_name]["conv"])
    _conv(sd, "decoder_ch256.0", params["decoder_ch256"])
    _conv(sd, "decoder_ch512.0", params["decoder_ch512"])
    if "linear_probe" in params:
        _conv(sd, "linear_probe", params["linear_probe"])
    sd["text_embeddings"] = _t(text)
    return sd


def _bn(sd: dict, name: str, p: dict, stats: dict):
    sd[name + ".weight"] = _t(p["scale"])
    sd[name + ".bias"] = _t(p["bias"])
    sd[name + ".running_mean"] = _t(stats["mean"])
    sd[name + ".running_var"] = _t(stats["var"])


def resnet50_state_dict_from_jax(params: dict, batch_stats: dict,
                                 prefix: str = "") -> dict:
    """flax ``ResNet50`` params and batch stats -> torchvision-named
    ``state_dict`` (the keys ``convert_resnet50`` reads); the blocks are
    the tree's, so a trunk of other ``layers`` converts too."""
    sd: dict = {}
    _conv(sd, prefix + "conv1", params["conv1"])
    _bn(sd, prefix + "bn1", params["bn1"], batch_stats["bn1"])
    for li in range(1, 5):
        bi = 0
        while f"layer{li}/{bi}" in params:
            bp = params[f"layer{li}/{bi}"]
            bs = batch_stats[f"layer{li}/{bi}"]
            base = f"{prefix}layer{li}.{bi}."
            for ci in (1, 2, 3):
                _conv(sd, base + f"conv{ci}", bp[f"conv{ci}"])
                _bn(sd, base + f"bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
            if "downsample_conv" in bp:
                _conv(sd, base + "downsample.0", bp["downsample_conv"])
                _bn(sd, base + "downsample.1", bp["downsample_bn"],
                    bs["downsample_bn"])
            bi += 1
    return sd


def teacher_state_dict_from_jax(params: dict, batch_stats: dict) -> dict:
    """flax ``DilationFeatureExtractor`` params and batch stats ->
    ``state_dict`` of the port's :class:`DilationFeatureExtractor`
    (``encoder.*`` and ``decoder_conv.*``). The inverse of
    ``convert_dilation_teacher``: feeding it the ``encoder.``-stripped keys
    and the decoder conv gives the same trees back."""
    sd = resnet50_state_dict_from_jax(
        params["encoder"], batch_stats["encoder"], prefix="encoder."
    )
    _conv(sd, "decoder_conv", params["decoder_conv"])
    return sd


def deeplab_state_dict_from_jax(params: dict, batch_stats: dict,
                                text) -> dict:
    """flax ``DeepLabV3TextSeg`` params, batch stats and text embeddings
    ``[C, 512]`` -> ``state_dict`` of the port's :class:`DeepLabV3TextSeg`
    (with ``linear_probe.*`` when the tree has it). The inverse of
    ``convert_deeplab``."""
    sd = resnet50_state_dict_from_jax(
        params["backbone"], batch_stats["backbone"], prefix="backbone."
    )
    head, stats = params["classifier"], batch_stats["classifier"]
    aspp, aspp_s = head["aspp"], stats["aspp"]
    base = "classifier.ASPP."
    for i in range(4):
        _conv(sd, f"{base}convs.{i}.0", aspp[f"conv{i}"])
        _bn(sd, f"{base}convs.{i}.1", aspp[f"bn{i}"], aspp_s[f"bn{i}"])
    _conv(sd, base + "convs.4.1", aspp["conv4"])
    _bn(sd, base + "convs.4.2", aspp["bn4"], aspp_s["bn4"])
    _conv(sd, base + "project.0", aspp["project"])
    _bn(sd, base + "project.1", aspp["project_bn"], aspp_s["project_bn"])
    _conv(sd, "classifier.classifier.0", head["classifier_conv"])
    _bn(sd, "classifier.classifier.1", head["classifier_bn"],
        stats["classifier_bn"])
    sd["classifier.text_embeddings"] = _t(text)
    if "linear_probe" in params:
        _conv(sd, "linear_probe", params["linear_probe"])
    return sd


# ---------------------------------------------------------------------------
# the released torch files
# ---------------------------------------------------------------------------

_BN = (".weight", ".bias", ".running_mean", ".running_var")
_RESNET50_BLOCKS = (3, 4, 6, 3)


def _f32(v) -> torch.Tensor:
    return v.detach().to("cpu", torch.float32).contiguous().clone()


def _pick(sd: dict, names, prefix: str = "", out_prefix: str = "",
          optional=()) -> dict:
    """``{out_prefix + name: f32 copy of sd[prefix + name]}`` for each name;
    a name in ``optional`` may be missing, any other raises KeyError."""
    out = {}
    for name in names:
        key = prefix + name
        if key in sd:
            out[out_prefix + name] = _f32(sd[key])
        elif name not in optional:
            raise KeyError(f"released state dict lacks {key!r}")
    return out


def e2vid_state_dict_from_released(sd: dict) -> dict:
    """The released ``E2VID_lightweight`` UNet (``state_dict`` of
    ``E2VIDRecurrent``, keys under ``unetrecurrent.``, or bare) -> the
    ``state_dict`` of :class:`E2VIDReconstructor` (keys under
    ``unetrecurrent.``; the decode path's too, which a latent-only build
    ignores): the keys ``convert_e2vid`` reads, 3 encoders and 2 residual
    blocks, in f32."""
    sd = {k.removeprefix("unetrecurrent."): v for k, v in sd.items()}
    convs = (["head.conv2d"]
             + [f"encoders.{i}.conv.conv2d" for i in range(3)]
             + ["pred.conv2d"])
    biased = ([f"encoders.{i}.recurrent_block.Gates" for i in range(3)]
              + [f"resblocks.{i}.conv{c}" for i in range(2) for c in (1, 2)]
              + [f"decoders.{i}.transposed_conv2d" for i in range(3)])
    names = ([n + ".weight" for n in convs + biased]
             + [n + ".bias" for n in convs + biased])
    return _pick(sd, names, out_prefix="unetrecurrent.",
                 optional=[n + ".bias" for n in convs])


def _resnet50_names(sd: dict, prefix: str) -> list:
    """The torchvision ResNet-50 keys ``convert_resnet50`` reads, a block's
    downsample where ``sd`` has it."""
    names = ["conv1.weight"] + ["bn1" + p for p in _BN]
    for li, blocks in zip(range(1, 5), _RESNET50_BLOCKS):
        for bi in range(blocks):
            base = f"layer{li}.{bi}."
            for ci in (1, 2, 3):
                names += [base + f"conv{ci}.weight"]
                names += [base + f"bn{ci}" + p for p in _BN]
            if prefix + base + "downsample.0.weight" in sd:
                names += [base + "downsample.0.weight"]
                names += [base + "downsample.1" + p for p in _BN]
    return names


def teacher_state_dict_from_released(sd: dict) -> dict:
    """A self-supervised ResNet-50 (torchvision keys; the checkpoint's
    ``state_dict`` and a ``module.`` prefix already taken off by the
    caller, as ``convert_checkpoints`` does) -> the ``encoder.*`` entries
    of :class:`DilationFeatureExtractor`'s ``state_dict``. ``decoder_conv``
    is not in the file and stays as built."""
    return _pick(sd, _resnet50_names(sd, ""), out_prefix="encoder.")


def deeplab_state_dict_from_released(sd: dict) -> dict:
    """A released ``DeepLabV3TextSeg`` (``model_recon`` / ``model_frame``
    of an OpenESS checkpoint: ``backbone.*``, ``classifier.ASPP.*``,
    ``classifier.classifier.{0,1}``, ``classifier.text_embeddings``,
    ``linear_probe.*`` when probing) -> the port's ``state_dict``, the keys
    ``convert_deeplab`` reads."""
    names = ["backbone." + n for n in _resnet50_names(sd, "backbone.")]
    base = "classifier.ASPP."
    for i in range(4):
        names += [f"{base}convs.{i}.0.weight"]
        names += [f"{base}convs.{i}.1" + p for p in _BN]
    names += [base + "convs.4.1.weight"] + [base + "convs.4.2" + p
                                            for p in _BN]
    names += [base + "project.0.weight"] + [base + "project.1" + p
                                            for p in _BN]
    names += ["classifier.classifier.0.weight"]
    names += ["classifier.classifier.1" + p for p in _BN]
    names += ["classifier.text_embeddings", "linear_probe.weight",
              "linear_probe.bias"]
    return _pick(sd, names,
                 optional=("linear_probe.weight", "linear_probe.bias"))


def semseg_state_dict_from_released(sd: dict) -> dict:
    """A released SemSegE2VID (``back_end``) -> the port's ``state_dict``,
    the keys ``convert_semseg_e2vid`` reads; ``text_embeddings`` and
    ``linear_probe.*`` where the file has them."""
    convs = [f"decoder_scale_1.{i}.model.{j}" for i in range(5)
             for j in (0, 3)]
    convs += ["decoder_scale_1.5.model.0", "decoder_scale_2.0.model.0",
              "decoder_scale_2.1.model.0", "decoder_scale_3.0.model.0",
              "decoder_scale_3.1.model.0", "decoder_scale_4.0.model.0",
              "decoder_ch256.0", "decoder_ch512.0", "linear_probe"]
    names = [c + p for c in convs for p in (".weight", ".bias")]
    return _pick(sd, names + ["text_embeddings"],
                 optional=("linear_probe.weight", "linear_probe.bias",
                           "text_embeddings"))


def openess_state_dicts_from_released(ckpt: dict) -> dict:
    """A released OpenESS checkpoint (``Epoch_N.pt`` / ``ckp.pt``: a dict of
    per-model state dicts, utils/saver.py) -> ``{module name: state
    dict}`` of the port's ``ModelSet``, for the modules it holds:
    ``front_sensor_b`` (E2VID), ``model_recon`` and ``model_frame``
    (DeepLabV3 students) and ``back_end`` (SemSegE2VID), as
    ``convert_openess_checkpoint`` reads them. Other entries (an
    optimizer, the epoch) are ignored."""
    out = {}
    if "front_sensor_b" in ckpt:
        out["front_sensor_b"] = e2vid_state_dict_from_released(
            ckpt["front_sensor_b"])
    for name in ("model_recon", "model_frame"):
        if name in ckpt:
            out[name] = deeplab_state_dict_from_released(ckpt[name])
    if "back_end" in ckpt:
        out["back_end"] = semseg_state_dict_from_released(ckpt["back_end"])
    return out
