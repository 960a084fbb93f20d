"""The training core: one train step and one eval step per workload, the
counterpart of ``openess_tpu/training/steps.py``.

Batch dict convention (tensors on the device, NHWC except events):
  ev_*        raw-event sorted-chunk wire (data/device_voxelize.py); the
              step voxelizes it on the device (K1, or K4 for DDD17), before
              augmentation, so paired flips hit the grid
  event       [B, T, bins, H, W]   voxel windows, planar
  frame/recon [B, H, W, 3]         in [0, 1]
  label/pl/superpixel [B, H, W]    integer

Ported branches of ``compute_losses``: pretrain on the voxel options
(teacher features, the contrastive loss through K2 on student and teacher
features, Dice+CE on the pseudo-labels) and ``finetune`` /
``linear_probe`` / ``sup_only`` on the voxel options (Dice+CE on the
labels). The loss dicts carry the JAX package's keys.

The parts of a train step are wrapped in ``record_function`` spans named
``train/<part>`` (voxelize, augment, teacher, e2vid, head, losses,
backward, optimizer), so a ``torch.profiler`` trace gives the device time
of each; outside a profiler they cost nothing measurable.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.augment import augment_batch, draw_decisions
from openess_tpu_torch.data.device_voxelize import voxelize_wire
from openess_tpu_torch.losses import nce_loss, task_loss
from openess_tpu_torch.ops.segment_pool import segment_mean_pool
from openess_tpu_torch.training.build import (
    VOXEL_OPTIONS,
    ModelSet,
    e2vid_trains,
    trainable_labels,
)
from openess_tpu_torch.training.optim import set_learning_rates


def _pool(feats, seg, segments_per_image):
    # K2 reads [B*H*W, D] rows: an NHWC view of a channels-last tensor is
    # already contiguous and this is free; anything else is copied here,
    # once and in the open
    return segment_mean_pool(
        feats.contiguous(), seg, segments_per_image=segments_per_image
    )[0]


class StepBuilder:
    """Train, eval and viz steps of a configured workload.

    ``optimizer`` (``training/optim.make_optimizer``) and
    ``steps_per_epoch`` are needed by :meth:`train_step` only.
    """

    def __init__(self, settings: Settings, mset: ModelSet, optimizer=None,
                 steps_per_epoch: int = 1):
        if settings.config_option not in VOXEL_OPTIONS:
            raise NotImplementedError(
                f"config_option {settings.config_option!r}: ROADMAP Queue 1 "
                "item 6 (DeepLabV3 and the frame/recon workloads)"
            )
        if mset.task == "openess":
            raise NotImplementedError(
                f"task {mset.task!r}: ROADMAP Queue 1 item 6 (DeepLabV3 and "
                "the frame/recon workloads)"
            )
        self.s = settings
        self.mset = mset
        # modules with nothing to train stay in eval mode in a train step
        labels = trainable_labels(mset, settings)
        self._trains = {
            name: any(labels[f"{name}.{p}"] != "frozen"
                      for p, _ in m.named_parameters())
            for name, m in mset.modules.items()
        }
        self.optimizer = optimizer
        self.steps_per_epoch = steps_per_epoch
        self.step = 0
        # augmentation draws: seeded, on the models' device
        self.generator = torch.Generator(device=mset.device)
        self.generator.manual_seed(settings.seed)

    # ---------------- forward helpers ----------------

    def _set_mode(self, train: bool):
        # (the teacher's frozen encoder has no train-mode behaviour: no
        # dropout, BatchNorm always on running statistics)
        for name, m in self.mset.modules.items():
            m.train(train and self._trains[name])

    def _windows(self, batch):
        """Voxel windows ``[B, T, bins, H, W]``: the batch's own, or the
        raw-event wire voxelized on the device (K1)."""
        if "event" in batch:
            return batch["event"]
        return voxelize_wire(self.s, batch)

    def _with_windows(self, batch):
        if "event" in batch:
            return batch
        out = {k: v for k, v in batch.items() if not k.startswith("ev_")}
        out["event"] = self._windows(batch)
        return out

    def _event_path(self, batch, train: bool = False):
        """E2VID over the T windows -> latent -> SemSegE2VID head. The
        latent is detached and E2VID runs without a graph, so gradients
        never reach E2VID, except in a train step of a fine-tune with
        ``unfrozen_e2vid``: there the latent stays attached and E2VID's
        parameters, which are then in the voxel optimizer group, receive
        gradients through the T windows."""
        windows = self._windows(batch).to(self.mset.dtype)
        attached = train and e2vid_trains(self.s)
        with torch.set_grad_enabled(attached and torch.is_grad_enabled()), \
                record_function("train/e2vid"):
            _, latent = self.mset.modules["front_sensor_b"](windows)
        if not attached:
            latent = {k: latent[k].detach() for k in ("2", "4", "8")}
        with record_function("train/head"):
            return self.mset.modules["back_end"](latent)  # logits, feat256

    def _tloss(self, logits, target):
        s = self.s
        return task_loss(
            logits, target, num_classes=s.semseg_num_classes,
            ignore_index=s.semseg_ignore_label, losses=tuple(s.task_loss),
        )

    # ---------------- loss dispatch ----------------

    def compute_losses(self, batch, epoch: int):
        """``(total, losses)`` for one (already voxelized and augmented)
        batch; every entry is an f32 scalar on the device."""
        s, task, opt = self.s, self.mset.task, self.s.config_option
        losses = {}
        total = torch.zeros((), dtype=torch.float32, device=self.mset.device)
        if task == "pretrain":
            tname = "model_recon" if opt == "recon2voxel" else "model_frame"
            timg = batch["recon" if opt == "recon2voxel" else "frame"]
            with record_function("train/teacher"):
                feat_teacher = self.mset.modules[tname](timg)
            logits_voxel, feat_voxel = self._event_path(batch, train=True)
            if s.if_spatial_contrastive:
                with record_function("train/losses"):
                    sp = batch["superpixel"]
                    k = _pool(feat_voxel, sp, s.superpixel_size)
                    q = _pool(feat_teacher, sp, s.superpixel_size)
                    loss = nce_loss(k, q, temperature=0.07)
                losses["contrastive_nce_loss"] = loss
                total = total + loss
            if s.if_dense_clip_supervision:
                with record_function("train/losses"):
                    pl = batch["pl"]
                    if s.if_switchable_train and epoch >= 5:
                        pl = logits_voxel.detach().argmax(dim=-1)
                    loss = self._tloss(logits_voxel, pl) * s.weight_task_loss
                losses["dense_clip_loss"] = loss
                total = total + loss
        else:  # finetune | linear_probe | sup_only
            logits, _ = self._event_path(batch, train=True)
            with record_function("train/losses"):
                loss = self._tloss(logits, batch["label"]) \
                    * s.weight_task_loss
            losses["semseg_loss"] = loss
            total = total + loss
        losses["total_loss"] = total
        return total, losses

    # ---------------- steps ----------------

    def train_step(self, batch, epoch: int, decisions=None):
        """One optimizer step on ``batch``; returns the loss dict (detached
        device scalars). ``decisions`` overrides the augmentation draw (see
        ``data/augment.py``); it is ignored when augmentation is off."""
        self._set_mode(True)
        # raw-event wire: voxelize BEFORE augmentation so the paired flip
        # applies to the grid
        with record_function("train/voxelize"):
            batch = self._with_windows(batch)
        if self.s.data_augmentation_train:
            with record_function("train/augment"):
                if decisions is None:
                    decisions = draw_decisions(batch, self.generator)
                batch = augment_batch(batch, decisions)
        set_learning_rates(self.optimizer, self.step, self.steps_per_epoch,
                           self.s.num_epochs)
        self.optimizer.zero_grad(set_to_none=True)
        total, losses = self.compute_losses(batch, epoch)
        with record_function("train/backward"):
            total.backward()
        with record_function("train/optimizer"):
            self.optimizer.step()
        self.step += 1
        return {k: v.detach() for k, v in losses.items()}

    @torch.no_grad()
    def eval_step(self, batch):
        """``(pred [B, H, W] int64, task loss)`` on the event path."""
        self._set_mode(False)
        logits, _ = self._event_path(batch)
        return logits.argmax(dim=-1), self._tloss(logits, batch["label"])

    @torch.no_grad()
    def viz_step(self, batch):
        """``(pred [B, H, W], feat256 [B, H, W, 256])`` for the qualitative
        validation dumps."""
        self._set_mode(False)
        logits, feats = self._event_path(batch)
        return logits.argmax(dim=-1), feats
