"""Every shipped YAML under ``configs/`` builds in the port on the CPU:
``build_models``, ``make_optimizer`` and ``StepBuilder`` accept it, with
the modules, roles and optimizer groups the JAX package's ``build_models``
and ``trainable_labels`` give the same (task, ``config_option``)."""
import glob
import os

import pytest

from openess_tpu_torch.config.settings import load_settings
from openess_tpu_torch.training import build
from openess_tpu_torch.training.build import (
    build_models,
    task_from_settings,
    trainable_labels,
)
from openess_tpu_torch.training.optim import make_optimizer
from openess_tpu_torch.training.steps import StepBuilder
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))

# (task, config_option) -> [(module, role, group)], as the JAX package's
# training/build.py:137-173 adds them
EVENT = [("front_sensor_b", "e2vid", "voxel"),
         ("back_end", "semseg_head", "voxel")]
MODULES = {
    ("pretrain", "frame2recon"): [("model_recon", "deeplab", "recon"),
                                  ("model_frame", "teacher", "frame")],
    ("pretrain", "frame2voxel"): EVENT + [("model_frame", "teacher",
                                           "frame")],
    ("pretrain", "recon2voxel"): EVENT + [("model_recon", "teacher",
                                           "recon")],
    ("openess", "frame2recon"): [("model_recon", "deeplab", "recon"),
                                 ("model_frame", "deeplab", "frame")],
    ("openess", "frame2voxel"): EVENT + [("model_frame", "deeplab",
                                          "frame")],
    ("openess", "recon2voxel"): EVENT + [("model_recon", "deeplab",
                                          "recon")],
}
for _task in ("finetune", "linear_probe", "sup_only"):
    MODULES[(_task, "frame2recon")] = [("model_recon", "deeplab", "recon")]
    MODULES[(_task, "frame2voxel")] = MODULES[(_task, "recon2voxel")] = EVENT


def test_every_yaml_is_found():
    assert len(YAMLS) == 37


@pytest.mark.parametrize("path", YAMLS)
def test_shipped_yaml_builds(path, monkeypatch):
    # the structure is under test, not the seeded draws: skipping the
    # truncated-normal draws of up to two ResNet-50s saves ~2 s a YAML
    monkeypatch.setattr(build, "init_weights", lambda module, gen: None)
    s = load_settings(os.path.join(ROOT, path), generate_log=False)
    mset = build_models(s, device="cpu")
    task = task_from_settings(s)
    assert mset.task == task
    want = MODULES[(task, s.config_option)]
    assert [(n, mset.roles[n], mset.groups[n]) for n in mset.modules] == want
    labels = trainable_labels(mset, s)
    for name, m in mset.modules.items():
        if mset.roles[name] == "deeplab":
            assert m.backbone.fold_bn == s.student_fold_bn
            probe = m.linear_probe is not None
            assert probe == (task in ("finetune", "linear_probe", "sup_only")
                             and s.if_linear_probing)
            frozen_backbone = {labels[f"{name}.{p}"] == "frozen"
                               for p, _ in m.named_parameters()
                               if p.startswith("backbone.")}
            assert frozen_backbone == {s.if_linear_probing or (
                s.if_finetuning and s.frozen_backbone)}
    opt = make_optimizer(s, mset)
    StepBuilder(s, mset, opt, steps_per_epoch=1)
