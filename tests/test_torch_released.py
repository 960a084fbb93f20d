"""The released torch files into the port, against the JAX package's
converters, on the CPU with random weights in each released layout (no
file is downloaded):

- ``E2VID_lightweight.pth.tar``: ``{"arch", "model", "state_dict"}`` with
  the UNet under ``unetrecurrent.``;
- an OpenESS ``Epoch_N.pt``: ``front_sensor_b`` (E2VID), ``model_recon``
  (the DeepLabV3 student, with BatchNorm trackers and an
  ``aux_classifier``), ``back_end`` (SemSegE2VID with its text
  embeddings), and an ``epoch``;
- a DINO/MoCo ResNet-50: torchvision keys with ``fc.*`` and trackers, bare
  and under ``module.``;
- the CLIP text embeddings ``.pth``: one ``[11, 512]`` tensor.

Each layout converted by the JAX package's converter and carried into the
port by ``models/convert.*_state_dict_from_jax`` equals the port's direct
conversion bit for bit (same keys, same f32 values). E2VID (one window,
16x24) and SemSegE2VID (32x48) on the converted weights equal the JAX
modules on the JAX conversion within 1e-4 absolute (f32; measured up to
4.8e-7 and 2.7e-6). ``python -m
openess_tpu_torch.convert_checkpoints`` writes a file that
``checkpoint.load_pretrained_params`` loads into a built ``ModelSet``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.models import torch_convert as jconv
from openess_tpu.models.e2vid import E2VIDStreamingStep as JStep
from openess_tpu.models.e2vid import initial_stream_state as jstate
from openess_tpu.models.semseg_e2vid import SemSegE2VID as JSemSeg
from chip_smoke import randomized
from openess_tpu_torch import convert_checkpoints
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.models import convert
from openess_tpu_torch.models.deeplabv3 import DeepLabV3TextSeg
from openess_tpu_torch.models.e2vid import (
    E2VIDReconstructor,
    E2VIDStreamingStep,
    initial_stream_state,
)
from openess_tpu_torch.models.image_teacher import DilationFeatureExtractor
from openess_tpu_torch.models.semseg_e2vid import SemSegE2VID
from openess_tpu_torch.training import build
from openess_tpu_torch.training.checkpoint import load_pretrained_params

MODEL_ABS = 1e-4


@pytest.fixture(scope="module")
def released():
    """The four layouts, as the released files hold them."""
    torch.manual_seed(0)
    e2vid = randomized(torch, E2VIDReconstructor().state_dict(), 1)
    deeplab = randomized(torch, DeepLabV3TextSeg(11).state_dict(), 2)
    deeplab["aux_classifier.0.weight"] = torch.randn(256, 1024, 3, 3)
    semseg = randomized(torch, SemSegE2VID(input_c=256, num_classes=11)
                        .state_dict(), 3)
    r50 = {k.removeprefix("encoder."): v for k, v in randomized(torch, 
        DilationFeatureExtractor().encoder.state_dict(), 4).items()}
    r50["fc.weight"] = torch.randn(1000, 2048)
    r50["fc.bias"] = torch.randn(1000)
    return {
        "e2vid": {"arch": "E2VIDRecurrent",
                  "model": {"num_bins": 5, "recurrent_block_type": "convlstm"},
                  "state_dict": e2vid},
        "openess": {"front_sensor_b": e2vid, "model_recon": deeplab,
                    "back_end": semseg, "epoch": 29},
        "r50": r50,
        "text": torch.randn(11, 512),
    }


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def _np(sd):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in sd.items()}


def test_e2vid_matches_the_jax_conversion(released):
    sd = released["e2vid"]["state_dict"]
    want = convert.e2vid_state_dict_from_jax(jconv.convert_e2vid(_np(sd)))
    _assert_same(convert.e2vid_state_dict_from_released(sd), want)
    bare = {k.removeprefix("unetrecurrent."): v for k, v in sd.items()}
    _assert_same(convert.e2vid_state_dict_from_released(bare), want)


def test_semseg_matches_the_jax_conversion(released):
    sd = released["openess"]["back_end"]
    params, text = jconv.convert_semseg_e2vid(_np(sd))
    want = convert.semseg_state_dict_from_jax(params, text)
    _assert_same(convert.semseg_state_dict_from_released(sd), want)


def test_deeplab_matches_the_jax_conversion(released):
    sd = released["openess"]["model_recon"]
    params, stats, text = jconv.convert_deeplab(_np(sd))
    want = convert.deeplab_state_dict_from_jax(params, stats, text)
    _assert_same(convert.deeplab_state_dict_from_released(sd), want)


@pytest.mark.parametrize("prefix", ["", "module."])
def test_teacher_matches_the_jax_conversion(released, prefix):
    sd = {prefix + k: v for k, v in released["r50"].items()}
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    params, stats = jconv.convert_dilation_teacher(_np(sd))
    want = convert.resnet50_state_dict_from_jax(
        params["encoder"], stats["encoder"], prefix="encoder.")
    _assert_same(convert.teacher_state_dict_from_released(sd), want)


def test_openess_checkpoint_matches_the_jax_conversion(released):
    ckpt = released["openess"]
    params, stats, _ = jconv.convert_openess_checkpoint(
        {k: _np(v) for k, v in ckpt.items() if isinstance(v, dict)})
    got = convert.openess_state_dicts_from_released(ckpt)
    assert sorted(got) == ["back_end", "front_sensor_b", "model_recon"]
    _assert_same(got["front_sensor_b"], convert.e2vid_state_dict_from_jax(
        params["front_sensor_b"]))
    _assert_same(got["model_recon"], convert.deeplab_state_dict_from_jax(
        params["model_recon"], stats["model_recon"],
        _np(ckpt["model_recon"])["classifier.text_embeddings"]))
    _assert_same(got["back_end"], convert.semseg_state_dict_from_jax(
        params["back_end"], _np(ckpt["back_end"])["text_embeddings"]))


def test_e2vid_forward_on_released_weights_matches_jax(released):
    sd = released["e2vid"]["state_dict"]
    B, H, W = 1, 16, 24
    win = np.random.default_rng(5).normal(size=(B, 5, H, W)).astype(
        np.float32)
    win[np.abs(win) < 0.3] = 0
    jp = {"params": {"step": {"unet": jconv.convert_e2vid(_np(sd))}}}
    _, jlat, jimg = JStep().apply(jp, jstate(B, H, W), jnp.asarray(win))
    step = E2VIDStreamingStep()
    step.load_state_dict(convert.e2vid_state_dict_from_released(sd),
                         strict=True)
    with torch.no_grad():
        _, lat, img = step(initial_stream_state(B, H, W),
                           torch.from_numpy(win))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=MODEL_ABS)
    for k in ("1", "2", "4", "8"):
        np.testing.assert_allclose(lat[k].numpy(), np.asarray(jlat[k]),
                                   atol=MODEL_ABS, err_msg=k)


def test_semseg_forward_on_released_weights_matches_jax(released):
    sd = released["openess"]["back_end"]
    rng = np.random.default_rng(6)
    H, W = 32, 48
    latent = {str(2 ** i): rng.normal(size=(
        2, H // 2 ** i, W // 2 ** i, 32 * 2 ** i)).astype(np.float32)
        for i in (1, 2, 3)}
    params, text = jconv.convert_semseg_e2vid(_np(sd))
    jlog, jfeat = JSemSeg(num_classes=11).apply(
        {"params": params}, {k: jnp.asarray(v) for k, v in latent.items()},
        jnp.asarray(text))
    m = SemSegE2VID(input_c=256, num_classes=11)
    m.load_state_dict(convert.semseg_state_dict_from_released(sd),
                      strict=True)
    with torch.no_grad():
        log, feat = m({k: torch.from_numpy(v) for k, v in latent.items()})
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=MODEL_ABS)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat),
                               atol=MODEL_ABS)


def _settings(**kw):
    return Settings(dataset_name_b="synthetic_events", img_size_b=(32, 48),
                    semseg_num_classes=11, nr_events_data_b=2,
                    compute_dtype="float32", **kw)


def test_cli_writes_a_pretrained_file(released, tmp_path, monkeypatch):
    """Every flag at once; the file loads into the fine-tune's event path,
    the pretrain's frame teacher (``decoder_conv`` stays as built) and the
    ``frame2recon`` student, each tensor equal to the conversion."""
    paths = {}
    for name, obj, fname in (("e2vid", released["e2vid"],
                              "E2VID_lightweight.pth.tar"),
                             ("openess", released["openess"], "Epoch_29.pt"),
                             ("r50", {"state_dict": {
                                 "module." + k: v for k, v in
                                 released["r50"].items()}}, "dino_r50.pth"),
                             ("text", released["text"], "text.pth")):
        paths[name] = str(tmp_path / fname)
        torch.save(obj, paths[name])
    out = str(tmp_path / "converted" / "weights.pt")
    convert_checkpoints.main([
        "--openess_ckpt", paths["openess"], "--e2vid", paths["e2vid"],
        "--teacher_r50", paths["r50"], "--teacher_name", "model_frame",
        "--text_pth", paths["text"], "--text_out", str(tmp_path / "t.npy"),
        "--out", out])
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"),
                                  released["text"].numpy())
    held = torch.load(out, weights_only=True)["models"]
    assert sorted(held) == ["back_end", "front_sensor_b", "model_frame",
                            "model_recon"]

    monkeypatch.setattr(build, "init_weights", lambda module, gen: None)
    for kw, modules in (
            (dict(if_finetuning=True, config_option="frame2voxel"),
             ("front_sensor_b", "back_end")),
            (dict(if_pretraining=True, config_option="frame2voxel"),
             ("front_sensor_b", "back_end", "model_frame")),
            (dict(if_supervised_only=True, config_option="frame2recon"),
             ("model_recon",))):
        mset = build.build_models(_settings(**kw), device="cpu")
        taken = set(load_pretrained_params(out, mset))
        for name in modules:
            own = mset.modules[name].state_dict()
            for k, v in held[name].items():
                assert f"{name}.{k}" in taken or k not in own, (name, k)
                if k in own:
                    assert torch.equal(own[k].float(), v), (name, k)
        if "model_frame" in modules:
            assert not any(t.startswith("model_frame.decoder_conv")
                           for t in taken)
