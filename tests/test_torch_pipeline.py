"""The port's ``PrefetchLoader`` (``openess_tpu_torch/data/pipeline.py``)
against the JAX package's ``tests/test_pipeline.py`` contract: order kept
across worker counts, errors raised in the consumer, ``drop_last`` and
``pad_last``; and ``Trainer``, which assembles through it, against in-line
assembly on the CPU: the same batches and the same losses, bit for bit."""
import numpy as np
import pytest
import torch

from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.pipeline import PrefetchLoader, batch_indices
from openess_tpu_torch.data.synthetic import SyntheticESS
from openess_tpu_torch.training.trainer import Trainer, to_device
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")


class ToyDataset:
    def __init__(self, n=23, fail_at=None, delay_odd=False):
        self.n = n
        self.fail_at = fail_at
        self.delay_odd = delay_odd

    def __len__(self):
        return self.n

    def get_batch(self, indices):
        import time

        if self.fail_at is not None and self.fail_at in list(indices):
            raise ValueError("boom")
        if self.delay_odd and int(indices[0]) % 2 == 1:
            time.sleep(0.02)  # batches led by an odd index finish late
        return {"idx": np.asarray(indices)}


@pytest.mark.parametrize("num_workers", [1, 4])
def test_order_deterministic_across_workers(num_workers):
    ds = ToyDataset(n=23, delay_odd=True)
    loader = PrefetchLoader(ds, 4, shuffle=True,
                            rng=np.random.default_rng(7),
                            num_workers=num_workers)
    got = [b["idx"] for b in loader]
    ref = [idx for idx, _ in batch_indices(
        23, 4, shuffle=True, rng=np.random.default_rng(7), drop_last=True,
        pad_last=False)]
    assert len(got) == len(loader) == 5  # drop_last: 23 // 4
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_error_propagates():
    loader = PrefetchLoader(ToyDataset(n=16, fail_at=5), 4, shuffle=False,
                            num_workers=3)
    with pytest.raises(ValueError, match="boom"):
        list(loader)


def test_drop_last_false():
    loader = PrefetchLoader(ToyDataset(n=10), 4, shuffle=False,
                            drop_last=False, num_workers=2)
    batches = list(loader)
    assert len(batches) == len(loader) == 3
    assert batches[-1]["idx"].size == 2 and "valid" not in batches[-1]


@pytest.mark.parametrize("num_workers", [1, 3])
def test_pad_last_pads_and_masks(num_workers):
    """The validation form: the last partial batch repeats its last sample
    up to ``batch_size``, and every batch carries the ``valid`` mask."""
    seen = []
    loader = PrefetchLoader(ToyDataset(n=10), 4, shuffle=False,
                            drop_last=False, pad_last=True,
                            num_workers=num_workers,
                            put_fn=lambda b: seen.append(b) or b)
    batches = list(loader)
    assert len(batches) == 3 and len(seen) == 3
    np.testing.assert_array_equal(batches[-1]["idx"], [8, 9, 9, 9])
    np.testing.assert_array_equal(batches[-1]["valid"],
                                  [True, True, False, False])
    assert all(b["valid"].all() for b in batches[:2])


def test_consumer_stopping_early_cancels_the_rest():
    calls = []

    class Counting(ToyDataset):
        def get_batch(self, indices):
            calls.append(int(indices[0]))
            return super().get_batch(indices)

    it = iter(PrefetchLoader(Counting(n=40), 2, shuffle=False,
                             num_workers=2, prefetch=1))
    first = next(it)
    it.close()
    np.testing.assert_array_equal(first["idx"], [0, 1])
    assert len(calls) < 20  # at most the in-flight window was assembled


H, W, C, T = 32, 48, 6, 2


def _settings(**kw):
    return Settings(**{**dict(
        dataset_name_b="synthetic_events", img_size_b=(H, W),
        semseg_num_classes=C, nr_events_data_b=T, compute_dtype="float32",
        if_supervised_only=True, config_option="recon2voxel",
        data_augmentation_train=True, batch_size_b=2, num_epochs=1), **kw})


@pytest.mark.parametrize("wire_format", ["raw_events", "grid"])
def test_trainer_prefetch_is_bit_identical_to_inline(wire_format):
    """A ``Trainer`` with ``num_cpu_workers: 2`` (batches assembled by two
    threads ahead of the step) against the same seed stepped on batches
    assembled in line: every train batch and every step's losses equal,
    then the padded validation batches."""
    from openess_tpu_torch.data.loaders import _with_get_batch

    ts = _settings(num_cpu_workers=2, wire_format=wire_format,
                   host_voxelize=False)
    kw = dict(height=H, width=W, num_classes=C, num_windows=T)

    def datasets():
        return (_with_get_batch(SyntheticESS(num_samples=6, seed=3, **kw),
                                ts, "cpu"),
                _with_get_batch(SyntheticESS(num_samples=3, seed=4, **kw),
                                ts, "cpu"))

    train, val = datasets()
    trainer = Trainer(ts, train, val, seed=0, device="cpu")
    seen, losses, evals = [], [], []
    train_step, eval_step = trainer.sb.train_step, trainer.sb.eval_step

    def recording_train(batch, epoch):
        seen.append({k: v.clone() for k, v in batch.items()})
        losses.append(train_step(batch, epoch))
        return losses[-1]

    def recording_eval(batch):
        evals.append(({k: v.clone() for k, v in batch.items()},
                      eval_step(batch)))
        return evals[-1][1]

    trainer.sb.train_step = recording_train
    trainer.sb.eval_step = recording_eval
    trainer.train_epoch()
    trainer.val_epoch()

    train2, val2 = datasets()
    ref = Trainer(ts, train2, val2, seed=0, device="cpu")
    plan = list(batch_indices(len(train2), 2, shuffle=True, rng=ref.np_rng,
                              drop_last=True, pad_last=False))
    assert len(seen) == len(losses) == len(plan) == 3
    for (idx, _), got, got_losses in zip(plan, seen, losses):
        batch = to_device(train2.get_batch(idx), "cpu")
        assert sorted(batch) == sorted(got)
        for k in batch:
            assert torch.equal(batch[k], got[k]), k
        want = ref.sb.train_step(batch, 0)
        assert sorted(want) == sorted(got_losses)
        for k in want:
            assert torch.equal(want[k], got_losses[k]), k
    vplan = list(batch_indices(len(val2), 2, shuffle=False, rng=ref.np_rng,
                               drop_last=False, pad_last=True))
    assert len(evals) == len(vplan) == 2
    for (idx, valid), (got, (pred, _)) in zip(vplan, evals):
        batch = val2.get_batch(idx)
        batch["valid"] = valid
        batch = to_device(batch, "cpu")
        for k in batch:
            assert torch.equal(batch[k], got[k]), k
        assert torch.equal(ref.sb.eval_step(batch)[0], pred)
