"""UDA (the ``openess`` task) of the port against the JAX package's
``StepBuilder`` on the CPU, on the three options: two DeepLabV3 students
on ``frame2recon``, a DeepLabV3 student beside the event path (E2VID and
the SemSegE2VID head) on ``recon2voxel`` and ``frame2voxel``, with the
contrastive loss at the reference's fixed 30 or 50 superpixels. The
machinery, sizes and tolerances are those of ``test_torch_recon_train.py``
(its module docstring gives them with what was measured).
"""
import pytest

from test_torch_recon_train import (
    check_gradients,
    check_losses,
    check_stats,
    check_update,
    one_step,
    student_bns,
    test_eval_and_viz_steps_match as _eval_and_viz,
)
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

UDA = dict(if_spatial_contrastive=True)
BRANCHES = {
    "frame2recon": dict(UDA, config_option="frame2recon"),
    "recon2voxel": dict(UDA, config_option="recon2voxel"),
    "frame2voxel": dict(UDA, config_option="frame2voxel"),
}
KEYS = {
    "frame2recon": {"semseg_frame_loss", "semseg_recon_loss",
                    "cons_feat_loss", "cons_pred_loss",
                    "contrastive_nce_loss", "total_loss"},
    "recon2voxel": {"semseg_recon_loss", "semseg_sensor_b_loss",
                    "cons_feat_loss", "cons_pred_loss",
                    "contrastive_nce_loss", "total_loss"},
}
KEYS["frame2voxel"] = KEYS["recon2voxel"]
MODULES = {
    "frame2recon": ["model_recon", "model_frame"],
    "recon2voxel": ["front_sensor_b", "back_end", "model_recon"],
    "frame2voxel": ["front_sensor_b", "back_end", "model_frame"],
}


@pytest.fixture(scope="module", params=list(BRANCHES))
def run(request):
    with pytest.MonkeyPatch.context() as mp:
        yield request.param, one_step(BRANCHES[request.param], mp,
                                      viz=request.param == "recon2voxel")


def test_loss_dict_matches_stepbuilder(run):
    name, r = run
    assert r["tm"].task == "openess"
    assert list(r["tm"].modules) == MODULES[name]
    check_losses(r, KEYS[name])


def test_gradients_match_stepbuilder(run):
    """Both students train in their groups; E2VID stays frozen."""
    name, r = run
    check_gradients(r)
    assert not any(k.startswith("front_sensor_b.") for k in r["tgrads"])
    for module in MODULES[name]:
        if module != "front_sensor_b":
            assert any(k.startswith(module + ".") for k in r["tgrads"])


def test_one_adamw_update_matches_stepbuilder(run):
    _, r = run
    check_update(r)


def test_running_statistics_match_stepbuilder(run):
    name, r = run
    students = 2 if name == "frame2recon" else 1
    assert student_bns(r) == (17 + 7) * students
    assert check_stats(r) == 2 * student_bns(r)


def test_eval_and_viz_steps_match(run):
    """The eval step reads ``model_recon`` on ``frame2recon`` and the
    event path on the voxel options (the viz step too, on
    ``recon2voxel``)."""
    _eval_and_viz(run)
