"""Trainer: epoch loop, validation, checkpointing around the step core, the
counterpart of ``openess_tpu/training/trainer.py``.

One Trainer serves every ported workload; the differences live in
``StepBuilder.compute_losses``. Batches are assembled and uploaded by
``data/pipeline.PrefetchLoader`` on ``num_cpu_workers`` threads while the
device runs the step before them; the qualitative dumps (ROADMAP Queue 1
item 3) are not ported yet. A batch's grid-wire ``event`` made by K5 or
K6 is already on the device and is not copied.
"""
from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.pipeline import PrefetchLoader
from openess_tpu_torch.metrics import MetricsSemseg
from openess_tpu_torch.training import checkpoint as ckpt
from openess_tpu_torch.training.build import (
    build_models,
    refuse_unported_mesh,
)
from openess_tpu_torch.training.optim import make_optimizer
from openess_tpu_torch.training.steps import StepBuilder

log = logging.getLogger("openess_tpu_torch")


def to_device(batch: dict, device) -> dict:
    """Batch -> tensors on ``device``: numpy arrays are copied up, to a
    CUDA device through pinned memory with a copy that does not block the
    host (it queues on the current stream, ahead of the step that reads
    it); a tensor already there (the grid wire's ``event``, made on the
    device) passes through as it is."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                v = v.pin_memory()
        out[k] = v.to(device, non_blocking=True)
    return out


class Trainer:
    def __init__(self, settings: Settings, dataset_train, dataset_val=None,
                 seed: Optional[int] = None, device=None):
        self.s = settings
        self.train_data = dataset_train
        self.val_data = dataset_val
        seed = settings.seed if seed is None else seed
        self.np_rng = np.random.default_rng(seed)

        refuse_unported_mesh(settings, device)
        self.mset = build_models(settings, seed=seed, device=device)
        self.device = self.mset.device
        self.steps_per_epoch = max(
            1, len(dataset_train) // settings.batch_size_b
        )
        self.optimizer = make_optimizer(settings, self.mset)
        self.sb = StepBuilder(settings, self.mset, self.optimizer,
                              self.steps_per_epoch)
        self.sb.generator.manual_seed(seed)

        if settings.load_pretrained_weights and settings.pretrained_file:
            ckpt.load_pretrained_params(
                settings.pretrained_file, self.mset,
                exclude_substrings=("linear_probe",),
            )
            log.info("loaded pretrained weights from %s",
                     settings.pretrained_file)
        self.epoch = 0
        if settings.resume_training and settings.resume_ckpt_file:
            self.sb.step, self.epoch = ckpt.restore_checkpoint(
                settings.resume_ckpt_file, self.mset, self.optimizer,
                restore_optimizer=settings.resume_restore_optimizer,
            )
            log.info("resumed from %s at epoch %d",
                     settings.resume_ckpt_file, self.epoch)

        self.metrics = MetricsSemseg(
            settings.semseg_num_classes, settings.semseg_ignore_label,
            settings.semseg_class_names,
        )

    # ------------------------------------------------------------------

    def _batches(self, dataset, train: bool):
        # training drops the trailing partial batch; validation keeps it,
        # padded, with the `valid` mask keeping the metrics exact
        yield from PrefetchLoader(
            dataset, self.s.batch_size_b, shuffle=train, rng=self.np_rng,
            put_fn=lambda b: to_device(b, self.device), device=self.device,
            num_workers=self.s.num_cpu_workers, drop_last=train,
            pad_last=not train,
        )

    def train_epoch(self) -> dict:
        """One pass over the training set. Every batch's losses accumulate
        on the device; one fetch at the end gives the epoch averages."""
        sums, count = None, 0
        t0 = time.time()
        for bi, batch in enumerate(self._batches(self.train_data, True)):
            losses = self.sb.train_step(batch, self.epoch)
            count += 1
            sums = losses if sums is None else {
                k: sums[k] + v for k, v in losses.items()
            }
            if (bi + 1) % 20 == 0 or bi == 0:
                log.info("epoch %d batch %d: %s", self.epoch, bi,
                         {k: round(float(v), 4) for k, v in losses.items()})
        dt = time.time() - t0
        log.info("epoch %d done: %d steps in %.1fs (%.2f steps/s)",
                 self.epoch, count, dt, count / max(dt, 1e-9))
        if sums is None:
            return {}
        stacked = torch.stack(list(sums.values())).cpu() / count
        return dict(zip(sums, stacked.tolist()))

    def val_epoch(self) -> dict:
        if self.val_data is None:
            return {}
        self.metrics.reset()
        for batch in self._batches(self.val_data, False):
            pred, _ = self.sb.eval_step(batch)
            label = batch["label"]
            if "valid" in batch:  # mask padded samples out of the confusion
                label = torch.where(
                    batch["valid"][:, None, None], label,
                    torch.full_like(label, self.s.semseg_ignore_label),
                )
            self.metrics.update_batch(pred, label)
        summary = self.metrics.get_metrics_summary()
        log.info("epoch %d val: mIoU %.2f acc %.2f", self.epoch,
                 summary["miou"], summary["acc"])
        return summary

    def _maybe_checkpoint(self):
        if self.s.save_checkpoint and self.s.ckpt_dir:
            ckpt.save_checkpoint(self.s.ckpt_dir, self.mset, self.optimizer,
                                 self.sb.step, self.epoch)

    def training(self) -> dict:
        """Epoch loop with periodic validation; returns the best summary."""
        best = {}
        for e in range(self.epoch, self.s.num_epochs):
            self.epoch = e
            self.train_epoch()
            if (e + 1) % self.s.val_epoch_step == 0:
                summary = self.val_epoch()
                if summary and summary.get("miou", 0) >= best.get("miou", -1):
                    best = summary
                self._maybe_checkpoint()
        return best

    def pretraining(self) -> None:
        """No-validation loop."""
        for e in range(self.epoch, self.s.num_epochs):
            self.epoch = e
            self.train_epoch()
            if (e + 1) % self.s.val_epoch_step == 0:
                self._maybe_checkpoint()

    def val_epochs(self) -> dict:
        """The test entry point: one validation sweep over the val set."""
        return self.val_epoch()
