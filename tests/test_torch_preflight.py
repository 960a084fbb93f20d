"""``python -m openess_tpu_torch.preflight`` (the counterpart of
``tools/preflight.py``) on random-weight files in every layout it checks,
written by the tests: FC-CLIP at a small manifest, E2VID, a DINO ResNet-50,
the MaskCLIP pair, text embeddings, an OpenESS checkpoint, a SAM file's
structure, a BPE merges file, and DSEC and DDD17 roots from
``openess_tpu/data/fixtures.py``. Each check passes on its file, fails
naming the key on a wrong shape and raises on a missing key; the command
line exits 0 only when every asset passes. No file outside the test's own
temporary directory is read (the JAX tool's tests read a reference tree
this repository does not hold)."""
import argparse
import functools
import gzip

import numpy as np
import pytest
import torch

from chip_smoke import randomized
from openess_tpu_torch import preflight
from openess_tpu_torch.models import maskclip
from openess_tpu_torch.models.deeplabv3 import DeepLabV3TextSeg
from openess_tpu_torch.models.e2vid import E2VIDReconstructor
from openess_tpu_torch.models.fcclip import manifest
from openess_tpu_torch.models.image_teacher import DilationFeatureExtractor
from openess_tpu_torch.models.semseg_e2vid import SemSegE2VID
from test_torch_fcclip import SMALL_MANIFEST, released_fcclip
from test_torch_maskclip import released_maskclip
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Every layout, written once: ``{name: (path, the dict written)}``."""
    root = tmp_path_factory.mktemp("preflight")
    torch.manual_seed(0)
    e2vid = randomized(torch, E2VIDReconstructor().state_dict(), 1)
    r50 = {k: v for k, v in randomized(
        torch, DilationFeatureExtractor().encoder.state_dict(), 2).items()}
    r50.update({"fc.weight": torch.randn(1000, 2048),
                "fc.bias": torch.randn(1000)})
    deeplab = randomized(torch, DeepLabV3TextSeg(11).state_dict(), 3)
    semseg = randomized(torch, SemSegE2VID(input_c=256, num_classes=11)
                        .state_dict(), 4)
    backbone, projs = released_maskclip(5)
    sam = {"image_encoder.patch_embed.proj.weight": torch.zeros(1280, 3, 16,
                                                               16),
           "image_encoder.blocks.0.norm1.weight": torch.ones(1280),
           "prompt_encoder.pe_layer.gaussian": torch.zeros(2, 128),
           "mask_decoder.iou_token.weight": torch.zeros(1, 256)}
    layouts = {
        "fcclip": released_fcclip(6),
        "e2vid": {"arch": "E2VIDRecurrent", "state_dict": e2vid},
        "dino": {"state_dict": {"module." + k: v for k, v in r50.items()}},
        "openess": {"front_sensor_b": e2vid, "model_recon": deeplab,
                    "back_end": semseg, "epoch": 29},
        "text": torch.randn(11, 512),
        "sam": sam,
        "maskclip_backbone": backbone,
        "maskclip_weights": projs,
    }
    out = {}
    for name, obj in layouts.items():
        path = root / f"{name}.pth"
        torch.save(obj, path)
        out[name] = (str(path), obj)
    return out


@pytest.fixture
def small(monkeypatch):
    """The FC-CLIP manifest at the test file's size, and MaskCLIP's
    reference model at the test pair's width (2 layers of 128)."""
    monkeypatch.setattr(manifest, "released_manifest", functools.partial(
        manifest.released_manifest, **SMALL_MANIFEST))
    monkeypatch.setattr(preflight, "MaskClipFeatureExtractor",
                        functools.partial(maskclip.MaskClipFeatureExtractor,
                                          embed_dim=128, num_layers=2,
                                          num_heads=2))


def _rewrite(tmp_path, obj, edit):
    """A copy of ``obj`` (a checkpoint dict) with ``edit`` applied to its
    innermost state dict, saved; returns the path."""
    obj = {k: (dict(v) if isinstance(v, dict) else v) for k, v in obj.items()}
    inner = next((v for k, v in obj.items() if k in (
        "model", "state_dict", "front_sensor_b")), obj)
    edit(inner)
    path = tmp_path / "edited.pth"
    torch.save(obj, path)
    return str(path)


CHECKS = {
    "fcclip": (lambda p: preflight.check_fcclip(p),
               "sem_seg_head.predictor.query_embed.weight"),
    "e2vid": (lambda p: preflight.check_e2vid(p),
              "unetrecurrent.head.conv2d.weight"),
    "dino": (lambda p: preflight.check_dino(p), "module.layer2.0.conv1.weight"),
    "openess": (lambda p: preflight.check_openess_ckpt(p),
                "unetrecurrent.encoders.0.conv.conv2d.weight"),
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_checkpoint_passes_then_fails_on_a_wrong_shape_and_a_missing_key(
        files, small, name, tmp_path):
    check, key = CHECKS[name]
    path, obj = files[name]
    assert "strictly" in check(path)

    def wrong(sd):
        sd[key] = torch.zeros(*[n + 1 for n in sd[key].shape])

    with pytest.raises(ValueError, match=key.removeprefix("module.")):
        check(_rewrite(tmp_path, obj, wrong))
    with pytest.raises((KeyError, ValueError), match=key.removeprefix(
            "module.").removeprefix("unetrecurrent.")):
        check(_rewrite(tmp_path, obj, lambda sd: sd.pop(key)))


def test_an_extra_key_is_refused(files, small, tmp_path):
    """A key the converter leaves over fails E2VID's and FC-CLIP's
    checks, naming it."""
    for name, check in (("e2vid", preflight.check_e2vid),
                        ("fcclip", preflight.check_fcclip)):
        path, obj = files[name]
        edited = _rewrite(tmp_path, obj, lambda sd: sd.__setitem__(
            "unetrecurrent.stray.weight" if name == "e2vid"
            else "sem_seg_head.stray", torch.zeros(1)))
        with pytest.raises(ValueError, match="stray"):
            check(edited)


@pytest.mark.parametrize("name,flag", [("fcclip", "--fcclip"),
                                       ("e2vid", "--e2vid"),
                                       ("openess", "--openess_ckpt")])
def test_a_file_holding_other_pickled_objects_fails(files, small, tmp_path,
                                                    capsys, name, flag):
    """Every file is read with ``weights_only=True``, as the tools read it:
    the same checkpoint with an ``argparse.Namespace`` beside its tensors
    runs no pickled code and FAILs, exit 1."""
    path, obj = files[name]
    torch.save({**obj, "args": argparse.Namespace(lr=0.1)},
               tmp_path / "pickled.pth")
    with pytest.raises(SystemExit) as e:
        preflight.main([flag, str(tmp_path / "pickled.pth")])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert out.startswith("FAIL") and "weights_only" in out, out


def test_maskclip_pair(files, small, tmp_path):
    bpath, bobj = files["maskclip_backbone"]
    wpath, wobj = files["maskclip_weights"]
    assert "load strictly" in preflight.check_maskclip(bpath, wpath, 11)
    key = "backbone.layers.1.ln2.weight"
    wrong = {"state_dict": dict(bobj["state_dict"], **{key: torch.ones(7)})}
    torch.save(wrong, tmp_path / "b.pth")
    with pytest.raises(ValueError, match="layers.1.ln2.weight"):
        preflight.check_maskclip(str(tmp_path / "b.pth"), wpath, 11)
    missing = {"state_dict": {k: v for k, v in bobj["state_dict"].items()
                              if k != key}}
    torch.save(missing, tmp_path / "m.pth")
    with pytest.raises(KeyError, match="layers.1.ln2.weight"):
        preflight.check_maskclip(str(tmp_path / "m.pth"), wpath, 11)
    torch.save({"other": {}}, tmp_path / "w.pth")
    with pytest.raises(ValueError, match="proj"):
        preflight.check_maskclip(bpath, str(tmp_path / "w.pth"), 11)


def test_text_and_sam(files, tmp_path):
    assert "11 classes x 512" in preflight.check_text(files["text"][0])
    torch.save(torch.zeros(11, 300), tmp_path / "t.pth")
    with pytest.raises(ValueError, match="300"):
        preflight.check_text(str(tmp_path / "t.pth"))
    path, sam = files["sam"]
    assert "vit_h structure OK" in preflight.check_sam(path)
    key = "image_encoder.patch_embed.proj.weight"
    torch.save(dict(sam, **{key: torch.zeros(768, 3, 16, 16)}),
               tmp_path / "s.pth")
    with pytest.raises(ValueError, match=key):
        preflight.check_sam(str(tmp_path / "s.pth"))
    torch.save({k: v for k, v in sam.items()
                if not k.startswith("mask_decoder.")}, tmp_path / "s2.pth")
    with pytest.raises(ValueError, match="mask_decoder"):
        preflight.check_sam(str(tmp_path / "s2.pth"))


def _bpe(path, n):
    lines = ["#version: test"] + [f"{chr(0x4e00 + i // 200)}{i % 200} "
                                  f"x{i}" for i in range(n)]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return str(path)


def test_bpe(tmp_path):
    """48 894 distinct two-symbol merge lines: the tokenizer's specials at
    49406/49407; one line short, or a malformed line, fails."""
    msg = preflight.check_bpe(_bpe(tmp_path / "ok.txt.gz", 48894))
    assert "sot/eot 49406/49407" in msg and "vocab 49408" in msg
    with pytest.raises(ValueError, match="48893 merge lines"):
        preflight.check_bpe(_bpe(tmp_path / "short.txt.gz", 48893))
    path = tmp_path / "bad.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#v"] + ["a b"] * 100 + ["abc"] + ["c d"] * 48800))
    with pytest.raises(ValueError, match="malformed"):
        preflight.check_bpe(str(path))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from openess_tpu.data.fixtures import write_ddd17_dir, write_dsec_sequence

    root = tmp_path_factory.mktemp("roots")
    rng = np.random.default_rng(7)
    write_dsec_sequence(root / "dsec" / "train" / "zurich_city_00_a", rng)
    write_dsec_sequence(root / "dsec" / "test" / "zurich_city_13_a", rng)
    for i in range(6):
        write_ddd17_dir(root / "ddd17" / f"dir{i}", rng, n_imgs=1,
                        n_events=100)
    return root


def test_dataset_roots(roots):
    assert "2 sequences" in preflight.check_dsec_root(str(roots / "dsec"), 11)
    with pytest.raises(ValueError, match="6classes"):
        preflight.check_dsec_root(str(roots / "dsec"), 6)
    assert "6 recording dirs" in preflight.check_ddd17_root(
        str(roots / "ddd17"))
    idx = roots / "ddd17" / "dir3" / "index" / "index_50ms.npy"
    idx.rename(idx.with_suffix(".bak"))
    try:
        with pytest.raises(ValueError, match="dir3: missing index"):
            preflight.check_ddd17_root(str(roots / "ddd17"))
    finally:
        idx.with_suffix(".bak").rename(idx)
    with pytest.raises(ValueError, match="found 0 dir"):
        preflight.check_ddd17_root(str(roots / "dsec"))


def test_cli_exit_codes(files, small, tmp_path, capsys):
    """0 when every asset given passes, 1 when one fails (the others still
    reported), 2 with no asset."""
    with pytest.raises(SystemExit) as e:
        preflight.main(["--fcclip", files["fcclip"][0], "--text",
                        files["text"][0], "--sam", files["sam"][0]])
    assert e.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out] == [
        ["PASS", "fcclip"], ["PASS", "text_embeddings"], ["PASS", "sam"]]
    torch.save(torch.zeros(3, 4), tmp_path / "t.pth")
    with pytest.raises(SystemExit) as e:
        preflight.main(["--text", str(tmp_path / "t.pth"), "--sam",
                        files["sam"][0]])
    assert e.value.code == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("FAIL  text_embeddings") and out[1].startswith(
        "PASS  sam")
    with pytest.raises(SystemExit) as e:
        preflight.main([])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        preflight.main(["--maskclip_backbone", files["maskclip_backbone"][0]])
    assert e.value.code == 2
