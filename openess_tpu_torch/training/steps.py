"""The training core: one train step and one eval step per workload, the
counterpart of ``openess_tpu/training/steps.py``.

Batch dict convention (tensors on the device, NHWC except events):
  ev_*        raw-event sorted-chunk wire (data/device_voxelize.py); the
              step voxelizes it on the device (K1, or K4 for DDD17), before
              augmentation, so paired flips hit the grid
  event       [B, T, bins, H, W]   voxel windows, planar
  frame/recon [B, H, W, 3]         in [0, 1]
  label/pl/superpixel [B, H, W]    integer

Every branch of the JAX ``compute_losses`` is here: pretrain on the voxel
options (teacher features, the contrastive loss through K2 on student and
teacher features, Dice+CE on the pseudo-labels) and on ``frame2recon``
(the DeepLabV3 student against the frame teacher, with SAM distillation);
``finetune`` / ``linear_probe`` / ``sup_only`` (Dice+CE on the labels) on
every option; and UDA (the ``openess`` task) on every option. The loss
dicts carry the JAX package's keys.

BatchNorm and dropout go by role, as in the JAX package: a DeepLabV3
student runs with ``train=True`` in a train step (batch statistics,
running statistics updated, dropout drawn from the step's generator) even
when none of its parameters train, and with ``train=False`` in the eval
and viz steps; the frame teacher's trunk always runs on its running
statistics. The modules' own train flags decide nothing of this.

The parts of a train step are wrapped in ``record_function`` spans named
``train/<part>`` (voxelize, augment, teacher, student, e2vid, head,
losses, backward, optimizer), so a ``torch.profiler`` trace gives the
device time of each; outside a profiler they cost nothing measurable.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.augment import augment_batch, draw_decisions
from openess_tpu_torch.data.device_voxelize import voxelize_wire
from openess_tpu_torch.losses import cosine_distill, nce_loss, task_loss
from openess_tpu_torch.ops.resize import resize_bilinear
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
        # augmentation and dropout draws: seeded, on the models' device
        self.generator = torch.Generator(device=mset.device)
        self.generator.manual_seed(settings.seed)

    # ---------------- forward helpers ----------------

    def _set_mode(self, train: bool):
        # the modules' flags only: the teacher's trunk and the students'
        # BatchNorm and dropout take their mode as an argument
        for name, m in self.mset.modules.items():
            m.train(train and self._trains[name])

    def _deeplab(self, name, x, train: bool):
        """``(logits, feats)`` of a DeepLabV3 student; ``train`` is its
        BatchNorm and dropout mode (the role's, not the module's flag)."""
        with record_function("train/student"):
            return self.mset.modules[name](
                x, train=train, generator=self.generator if train else None)

    def _windows(self, batch):
        """Voxel windows ``[B, T, bins, H, W]``: the batch's own, or the
        raw-event wire voxelized on the device (K1)."""
        if "event" in batch:
            return batch["event"]
        return voxelize_wire(self.s, batch)

    def _with_windows(self, batch):
        if "event" in batch or self.s.config_option not in VOXEL_OPTIONS:
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
        batch; every entry is an f32 scalar on the device. A DeepLabV3
        student's running statistics are updated in place."""
        s, task, opt = self.s, self.mset.task, self.s.config_option
        losses = {}
        total = torch.zeros((), dtype=torch.float32, device=self.mset.device)

        def add(key, fn, *args):
            nonlocal total
            with record_function("train/losses"):
                loss = fn(*args)
            losses[key] = loss
            total = total + loss

        def tloss(logits, target):
            return self._tloss(logits, target) * s.weight_task_loss

        def contrastive(feat_student, feat_teacher, sp_size):
            sp = batch["superpixel"]
            k = _pool(feat_student, sp, sp_size)
            q = _pool(feat_teacher, sp, sp_size)
            return nce_loss(k, q, temperature=0.07)

        def switchable_pl(logits, pl):
            if s.if_switchable_train and epoch >= 5:
                return logits.detach().argmax(dim=-1)
            return pl

        def sam_distill(feat):
            h, w = feat.shape[1:3]
            m = max(h, w)
            sam = resize_bilinear(batch["sam_feat"], out_h=m, out_w=m,
                                  align_corners=False)[:, :h, :w]
            return cosine_distill(sam, feat)

        def uda(logits_a, feat_a, logits_b, feat_b, keys, sp_size,
                nce_student, nce_teacher):
            add(keys[0], tloss, logits_a, batch["pl"])
            add(keys[1], tloss, logits_b, batch["pl"])
            add("cons_feat_loss",
                lambda: (feat_a.float() - feat_b.float()).abs().mean())
            add("cons_pred_loss", cosine_distill, logits_a, logits_b)
            if s.if_spatial_contrastive:
                add("contrastive_nce_loss", contrastive, nce_student,
                    nce_teacher, sp_size)

        if task == "pretrain":
            tname = "model_recon" if opt == "recon2voxel" else "model_frame"
            timg = batch["recon" if opt == "recon2voxel" else "frame"]
            with record_function("train/teacher"):
                feat_teacher = self.mset.modules[tname](timg)
            if opt == "frame2recon":
                logits, feat = self._deeplab("model_recon", batch["recon"],
                                             True)
            else:
                logits, feat = self._event_path(batch, train=True)
            if s.if_spatial_contrastive:
                add("contrastive_nce_loss", contrastive, feat, feat_teacher,
                    s.superpixel_size)
            if s.if_dense_clip_supervision:
                add("dense_clip_loss", tloss, logits,
                    switchable_pl(logits, batch["pl"]))
            if s.if_sam_distillation and opt == "frame2recon":
                add("sam_distillation_loss", sam_distill, feat)
        elif task in ("finetune", "linear_probe", "sup_only"):
            if opt in VOXEL_OPTIONS:
                logits, _ = self._event_path(batch, train=True)
            else:
                logits, _ = self._deeplab("model_recon", batch["recon"], True)
            add("semseg_loss", tloss, logits, batch["label"])
        elif opt in VOXEL_OPTIONS:  # openess (UDA), DeepLab + event path
            rname = "model_recon" if opt == "recon2voxel" else "model_frame"
            rimg = batch["recon" if opt == "recon2voxel" else "frame"]
            logits_r, feat_r = self._deeplab(rname, rimg, True)
            logits_v, feat_v = self._event_path(batch, train=True)
            # the reference fixes 50 (recon2voxel) / 30 (frame2voxel)
            uda(logits_r, feat_r, logits_v, feat_v,
                ("semseg_recon_loss", "semseg_sensor_b_loss"),
                50 if opt == "recon2voxel" else 30, feat_v, feat_r)
        else:  # openess (UDA) on frame2recon: two DeepLabs
            logits_f, feat_f = self._deeplab("model_frame", batch["frame"],
                                             True)
            logits_r, feat_r = self._deeplab("model_recon", batch["recon"],
                                             True)
            uda(logits_f, feat_f, logits_r, feat_r,
                ("semseg_frame_loss", "semseg_recon_loss"), 30, feat_r,
                feat_f)
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

    def _predict(self, batch):
        """``(logits, feats)`` in eval mode: the event path on the voxel
        options, ``model_recon`` on ``frame2recon``."""
        self._set_mode(False)
        if self.s.config_option in VOXEL_OPTIONS:
            return self._event_path(batch)
        return self._deeplab("model_recon", batch["recon"], False)

    def infer(self, x):
        """``(pred [B, H, W] int32, logits [B, H, W, classes])`` in eval
        mode, the counterpart of the bodies of JAX's ``build_infer_fn``
        (``tools/export_model.py``) and what ``export_model`` traces: the
        grid-wire ``event [B, T, C, H, W]`` through the event path on the
        voxel options, ``recon [B, H, W, 3]`` through ``model_recon`` (its
        folded trunk under ``student_fold_bn``) on ``frame2recon``."""
        key = "event" if self.s.config_option in VOXEL_OPTIONS else "recon"
        logits, _ = self._predict({key: x})
        return logits.argmax(dim=-1).to(torch.int32), logits

    @torch.no_grad()
    def eval_step(self, batch):
        """``(pred [B, H, W] int64, task loss)``."""
        logits, _ = self._predict(batch)
        return logits.argmax(dim=-1), self._tloss(logits, batch["label"])

    @torch.no_grad()
    def viz_step(self, batch):
        """``(pred [B, H, W], feat256 [B, H, W, 256])`` for the qualitative
        validation dumps."""
        logits, feats = self._predict(batch)
        return logits.argmax(dim=-1), feats
