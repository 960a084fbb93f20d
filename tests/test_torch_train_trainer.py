"""The port's ``Trainer`` on the CPU from one module-scoped run
(``trained``: two tiny ``sup_only`` epochs on the synthetic dataset,
64x96, T = 2, 6 classes): training, validation with a padded last batch,
the three checkpoint flavours and their restore rules, resuming, the test
entry point and serving the trained checkpoint. The settings helpers are
``test_torch_train.py``'s.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from openess_tpu_torch.data.synthetic import SyntheticESS
from openess_tpu_torch.training import checkpoint as ckpt
from openess_tpu_torch.training.build import build_models
from openess_tpu_torch.training.optim import make_optimizer
from openess_tpu_torch.training.trainer import Trainer
from test_torch_train import C, H, SUP_ONLY, T, W, torch_settings
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two tiny sup_only epochs: 8 training samples, 5 validation samples
    (so the last validation batch is padded), batch size 4."""
    out = tmp_path_factory.mktemp("run")
    ts = torch_settings(**SUP_ONLY, batch_size_b=4, num_epochs=2,
                        data_augmentation_train=True, log_dir=str(out))
    ts.ckpt_dir = str(out / "checkpoints")
    kw = dict(height=H, width=W, num_classes=C, num_windows=T)

    def make(n, seed):
        ds = SyntheticESS(num_samples=n, seed=seed, **kw)
        ds.get_batch = lambda idx: ds.raw_wire_batch(list(idx))
        return ds

    trainer = Trainer(ts, make(8, 1205), make(5, 1206), device="cpu")
    best = trainer.training()
    return ts, trainer, best, make


def test_trainer_trains_validates_and_checkpoints(trained):
    ts, trainer, best, _ = trained
    assert np.isfinite(best["miou"]) and 0.0 <= best["miou"] <= 100.0
    # the padded sixth..eighth samples of the last batch are masked out
    assert best["cm"].sum() == 5 * H * W
    assert trainer.sb.step == 4 and trainer.steps_per_epoch == 2
    assert sorted(os.listdir(ts.ckpt_dir)) == ["ckpt_0.pt", "ckpt_1.pt"]
    lr = [g["lr"] for g in trainer.optimizer.param_groups]
    assert lr == [pytest.approx(ts.lr_voxel * 0.5)]  # epoch 1 of 2
    avg = trainer.train_epoch()
    assert set(avg) == {"semseg_loss", "total_loss"}
    assert all(np.isfinite(v) for v in avg.values())


def _fresh(ts, seed=7):
    return build_models(ts, seed=seed, device="cpu")


def _same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return all(torch.equal(sa[n][k], sb[n][k]) for n in sa for k in sa[n])


def test_checkpoint_restores_full_model_only_partial_superset(trained,
                                                              tmp_path):
    ts, trainer, _, _ = trained
    path = ckpt.save_checkpoint(str(tmp_path), trainer.mset,
                                trainer.optimizer, trainer.sb.step, 1)
    # full, without the optimizer (the default) and with it
    m = _fresh(ts)
    opt = make_optimizer(ts, m)
    assert not _same(m, trainer.mset)
    assert ckpt.restore_checkpoint(str(tmp_path), m, opt) == (
        trainer.sb.step, 1)
    assert _same(m, trainer.mset) and not opt.state_dict()["state"]
    ckpt.restore_checkpoint(path, m, opt, restore_optimizer=True)
    got, ref = opt.state_dict()["state"], trainer.optimizer.state_dict()["state"]
    assert got.keys() == ref.keys() and len(got) == 36
    assert all(torch.equal(got[i]["exp_avg"], ref[i]["exp_avg"]) for i in got)
    # model-only
    snap = ckpt.save_model_only(str(tmp_path), trainer.mset, 1)
    assert os.path.basename(snap) == "epoch_1.pt"
    m = _fresh(ts)
    ckpt.load_model_only(snap, m)
    assert _same(m, trainer.mset)
    # partial: excluded names and mismatched shapes keep their fresh values
    m = _fresh(ts)
    fresh = {k: v.clone() for k, v in m.modules["back_end"].state_dict().items()}
    taken = ckpt.load_pretrained_params(snap, m,
                                        exclude_substrings=("decoder_ch512",))
    sd, ref = m.modules["back_end"].state_dict(), trainer.mset.modules[
        "back_end"].state_dict()
    assert torch.equal(sd["decoder_ch512.0.weight"],
                       fresh["decoder_ch512.0.weight"])
    assert torch.equal(sd["decoder_ch256.0.weight"],
                       ref["decoder_ch256.0.weight"])
    assert "back_end.decoder_ch512.0.weight" not in taken
    ts9 = dataclasses.replace(ts, semseg_num_classes=11)
    m9 = _fresh(ts9)
    taken = ckpt.load_pretrained_params(snap, m9)
    assert "back_end.text_embeddings" not in taken  # [6, 512] vs [11, 512]
    assert torch.equal(m9.modules["back_end"].state_dict()[
        "decoder_ch256.0.weight"], ref["decoder_ch256.0.weight"])
    # superset restores (extra module, extra key); a missing leaf raises
    raw = torch.load(path, weights_only=True)
    raw["models"]["model_frame"] = {"decoder_conv.weight": torch.zeros(1)}
    raw["models"]["back_end"]["dead.weight"] = torch.zeros(3)
    torch.save(raw, tmp_path / "superset.pt")
    m = _fresh(ts)
    ckpt.restore_checkpoint(str(tmp_path / "superset.pt"), m)
    assert _same(m, trainer.mset)
    del raw["models"]["back_end"]["decoder_ch256.0.bias"]
    torch.save(raw, tmp_path / "missing.pt")
    with pytest.raises(ValueError, match="missing leaf.*decoder_ch256.0.bias"):
        ckpt.restore_checkpoint(str(tmp_path / "missing.pt"), _fresh(ts))
    # only the newest three full checkpoints are kept
    for e in (2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), trainer.mset, None, 0, e)
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("ckpt_")) \
        == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]


def test_resume_and_test_entry_point_evaluate_the_checkpoint(trained):
    ts, trainer, best, make = trained
    rs = dataclasses.replace(ts, resume_training=True,
                             resume_ckpt_file=ts.ckpt_dir)
    resumed = Trainer(rs, make(5, 1206), make(5, 1206), device="cpu")
    assert resumed.epoch == 1 and resumed.sb.step == 4
    assert _same(resumed.mset, trainer.mset)
    summary = resumed.val_epochs()
    final = trainer.val_epoch()
    np.testing.assert_array_equal(summary["cm"], final["cm"])


def test_serve_stream_serves_the_trained_checkpoint(trained):
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.serve_stream import StreamServer, synthetic_windows

    ts, trainer, _, _ = trained
    served = StreamServer(ts, 1, device="cpu", checkpoint=ts.ckpt_dir)
    random = StreamServer(ts, 1, device="cpu")
    x, y, p, t = next(iter(synthetic_windows(1, 2000, H, W)))
    wire = upload_wire(served.pack(x, y, p, t), "cpu")
    _, labels, logits = served.step(served.initial_state(), wire)
    _, rlabels, _ = random.step(random.initial_state(), wire)
    # the trained head's labels: the same window through the trainer's own
    # modules
    sb = trainer.sb
    sb._set_mode(False)
    with torch.no_grad():
        want, _ = sb._event_path(wire)  # one window from a zero state
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5)
    assert torch.equal(labels, want.argmax(-1).to(torch.uint8))
    assert not torch.equal(labels, rlabels)

