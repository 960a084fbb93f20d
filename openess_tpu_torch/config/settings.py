"""Settings: the reference YAML schema read into a flat dataclass.

Own copy of ``openess_tpu/config/settings.py`` (the port imports nothing of
the JAX package): same fields, same defaults, same parsing, so one YAML file
configures both packages. The ``tpu:`` section keeps its name; in the port
it carries the compute dtype, the wire version and the kernel switches.
``yaml`` is imported only where a YAML file is read.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time
from typing import Any, Sequence

from openess_tpu_torch.config.classes import (
    CLASS_NAMES,
    COLOR_MAPS,
    IGNORE_LABEL,
)


@dataclasses.dataclass
class Settings:
    # --- hardware / tpu section ---
    num_cpu_workers: int = 1
    compute_dtype: str = "bfloat16"
    mesh_data: int = -1
    mesh_model: int = 1
    tp_mode: str = "channel"
    teacher_os: int = 4
    teacher_fold_bn: bool = True
    student_fold_bn: bool = True
    # event wire: 'raw_events' ships the sorted-chunk wire and voxelizes on
    # the device (K1); 'grid' ships dense voxel grids
    wire_format: str = "raw_events"
    # wire v2: relative time as uint16 against the per-window t_range
    # (7 B/event); false ships exact f32 relative times (wire v1, 9 B/event)
    wire_t16: bool = True
    host_voxelize: bool = True
    e2vid_s2d: bool = False
    # run the ConvLSTM gate pointwise tail through the K3 kernel
    e2vid_fused_gates: bool = False
    # --- model ---
    model_name: str = "open_ess"
    skip_connect_encoder: bool = True
    skip_connect_task: bool = True
    skip_connect_task_type: str = "concat"
    data_augmentation_train: bool = True
    train_on_event_labels: bool = False
    unfrozen_e2vid: bool = False
    path_to_model: str = "e2vid/pretrained/E2VID_lightweight.pth.tar"
    # --- dataset (sensor b) ---
    dataset_name_b: str = "DSEC_events"
    dataset_path_b: str = ""
    split_train_b: str = "train"
    img_size_b: Sequence[int] = (440, 640)
    nr_events_data_b: int = 20
    delta_t_per_data_b: int = 50
    nr_events_window_b: int = 100000
    event_representation_b: str = "voxel_grid"
    nr_temporal_bins_b: int = 5
    separate_pol_b: bool = False
    normalize_event_b: bool = False
    fixed_duration_b: bool = False
    require_paired_data_train_b: bool = False
    require_paired_data_val_b: bool = False
    input_channels_b: int = 5
    # --- task ---
    semseg_num_classes: int = 11
    # --- optim ---
    batch_size_b: int = 8
    lr_voxel: float = 5e-4
    lr_recon: float = 5e-4
    lr_frame: float = 5e-4
    lr_decay: float = 0.9
    num_epochs: int = 30
    val_epoch_step: int = 1
    weight_task_loss: float = 1.0
    task_loss: Sequence[str] = ("dice", "cross_entropy")
    weight_decay: float = 0.01
    # --- checkpoint ---
    save_checkpoint: bool = True
    resume_training: bool = False
    resume_ckpt_file: str = ""
    resume_restore_optimizer: bool = False
    load_pretrained_weights: bool = False
    pretrained_file: str = ""
    # --- dirs ---
    log_dir: str = "log/run"
    # --- clip / workload ---
    config_option: str = "frame2recon"
    skip_ratio: int = 1
    text_embeddings_path: str = ""
    maskclip_checkpoint: str = ""
    visual_projs_path: str = ""
    output_stride: int = 16
    pretrained_backbone: str = ""
    if_supervised_only: bool = False
    if_pretraining: bool = False
    image_weights: str = "dino"
    if_spatial_contrastive: bool = True
    superpixel_sources: str = "sp_sam_rgb"
    superpixel_size: int = 100
    if_dense_clip_supervision: bool = True
    pl_sources: str = "pl_fcclip_rgb"
    if_sam_distillation: bool = False
    if_finetuning: bool = False
    if_switchable_train: bool = False
    frozen_backbone: bool = False
    if_linear_probing: bool = False
    use_amp: bool = False
    seed: int = 1205

    # Derived (filled in __post_init__)
    sensor_b_name: str = "events"
    semseg_ignore_label: int = IGNORE_LABEL
    semseg_class_names: Sequence[str] = ()
    semseg_color_map: Any = None
    ckpt_dir: str = ""
    vis_dir: str = ""
    logger: Any = None

    def __post_init__(self):
        if self.tp_mode not in ("channel", "spatial"):
            raise ValueError(
                f"tpu.tp_mode must be 'channel' or 'spatial', got {self.tp_mode!r}"
            )
        if self.teacher_os not in (4, 8, 16):
            raise ValueError(f"tpu.teacher_os must be 4, 8 or 16, got {self.teacher_os}")
        if self.wire_format not in ("raw_events", "grid"):
            raise ValueError(
                f"tpu.wire_format must be 'raw_events' or 'grid', "
                f"got {self.wire_format!r}"
            )
        self.sensor_b_name = self.dataset_name_b.split("_")[-1]
        if self.dataset_name_b == "DDD17_events":
            # the DDD17 loader always delivers 200x352 (346->352 resize and a
            # 60-row bottom crop of the 260-row sensor)
            delivered = (200, 352)
            if tuple(self.img_size_b) not in ((200, 346), delivered):
                import warnings

                warnings.warn(
                    f"DDD17 yaml shape {tuple(self.img_size_b)} is ignored: "
                    f"the loader always delivers {delivered} "
                    "(346->352 resize + 60-row bottom crop)",
                    stacklevel=2,
                )
            self.img_size_b = delivered
        self.semseg_class_names = CLASS_NAMES[self.semseg_num_classes]
        self.semseg_color_map = COLOR_MAPS[self.semseg_num_classes]
        if self.event_representation_b == "voxel_grid":
            self.input_channels_b = self.nr_temporal_bins_b * (
                2 if self.separate_pol_b else 1
            )
        elif self.event_representation_b == "ev_segnet":
            self.input_channels_b = 6
        else:
            self.input_channels_b = 2


def _get(d: dict, *path, default=None):
    cur = d
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


def load_settings(settings_yaml: str, generate_log: bool = False) -> Settings:
    """Parse a reference-format YAML into :class:`Settings`.

    ``generate_log=True`` creates the timestamped log dir with
    ``checkpoints/`` and ``visualization/``, a copy of the YAML and a file
    logger, as the reference does.
    """
    import yaml

    with open(settings_yaml) as f:
        y = yaml.safe_load(f)

    s = Settings()
    # hardware
    s.num_cpu_workers = _get(y, "hardware", "num_cpu_workers", default=1)
    if s.num_cpu_workers < 0:
        s.num_cpu_workers = os.cpu_count()
    # tpu section
    s.compute_dtype = _get(y, "tpu", "compute_dtype", default="bfloat16")
    s.mesh_data = _get(y, "tpu", "mesh_data", default=-1)
    s.mesh_model = _get(y, "tpu", "mesh_model", default=1)
    s.tp_mode = _get(y, "tpu", "tp_mode", default="channel")
    s.teacher_os = int(_get(y, "tpu", "teacher_os", default=4))
    s.wire_format = _get(y, "tpu", "wire_format", default="raw_events")
    s.wire_t16 = bool(_get(y, "tpu", "wire_t16", default=True))
    s.host_voxelize = bool(_get(y, "tpu", "host_voxelize", default=True))
    s.e2vid_s2d = bool(_get(y, "tpu", "e2vid_s2d", default=False))
    s.e2vid_fused_gates = bool(_get(y, "tpu", "e2vid_fused_gates", default=False))
    s.teacher_fold_bn = bool(_get(y, "tpu", "teacher_fold_bn", default=True))
    s.student_fold_bn = bool(_get(y, "tpu", "student_fold_bn", default=True))
    # model
    for k in (
        "model_name", "skip_connect_encoder", "skip_connect_task",
        "skip_connect_task_type", "data_augmentation_train",
        "train_on_event_labels", "unfrozen_e2vid",
    ):
        v = _get(y, "model", k)
        if v is not None:
            setattr(s, k, v)
    # dataset
    name_b = _get(y, "dataset", "name_b", default="DSEC_events")
    s.dataset_name_b = name_b
    spec = _get(y, "dataset", name_b, default={})
    s.dataset_path_b = spec.get("dataset_path", "")
    s.img_size_b = tuple(spec.get("shape", (440, 640)))
    s.nr_events_data_b = spec.get("nr_events_data", 20)
    s.delta_t_per_data_b = spec.get("delta_t_per_data", 50)
    s.nr_events_window_b = spec.get("nr_events_window", 100000)
    s.event_representation_b = spec.get("event_representation", "voxel_grid")
    s.nr_temporal_bins_b = spec.get("nr_temporal_bins", 5)
    s.separate_pol_b = bool(spec.get("separate_pol", False))
    s.normalize_event_b = bool(spec.get("normalize_event", False))
    s.fixed_duration_b = bool(spec.get("fixed_duration", False))
    s.require_paired_data_train_b = bool(spec.get("require_paired_data_train", False))
    s.require_paired_data_val_b = bool(spec.get("require_paired_data_val", False))
    s.split_train_b = spec.get("split_train", "train")
    # task
    s.semseg_num_classes = _get(y, "task", "semseg_num_classes", default=11)
    # optim
    opt = y.get("optim", {})
    s.batch_size_b = int(opt.get("batch_size_b", 8))
    s.lr_voxel = float(opt.get("lr_voxel", 5e-4))
    s.lr_recon = float(opt.get("lr_recon", 5e-4))
    s.lr_frame = float(opt.get("lr_frame", 5e-4))
    s.lr_decay = float(opt.get("lr_decay", 0.9))
    s.num_epochs = int(opt.get("num_epochs", 30))
    s.val_epoch_step = int(opt.get("val_epoch_step", 1))
    s.weight_task_loss = float(opt.get("weight_task_loss", 1))
    s.task_loss = tuple(opt.get("task_loss", ("dice", "cross_entropy")))
    # checkpoint
    ck = y.get("checkpoint", {})
    s.save_checkpoint = bool(ck.get("save_checkpoint", True))
    s.resume_training = bool(ck.get("resume_training", False))
    s.resume_ckpt_file = ck.get("resume_file", "") or ""
    s.resume_restore_optimizer = bool(ck.get("restore_optimizer", False))
    # clip
    c = y.get("clip", {})
    s.config_option = c.get("config_option", s.config_option)
    s.skip_ratio = int(c.get("skip_ratio", 1))
    s.text_embeddings_path = c.get("text_embeddings_path", "") or ""
    s.maskclip_checkpoint = c.get("maskclip_checkpoint", "") or ""
    s.visual_projs_path = c.get("visual_projs_path", "") or ""
    s.output_stride = int(c.get("output_stride", 16))
    s.pretrained_backbone = c.get("pre_trained_backbone", "") or ""
    s.if_supervised_only = bool(c.get("if_supervised_only", False))
    s.if_pretraining = bool(c.get("if_pretraining", False))
    s.image_weights = c.get("image_weights", "dino")
    s.if_spatial_contrastive = bool(c.get("if_spatial_contrastive", True))
    s.superpixel_sources = c.get("superpixel_sources", "") or ""
    s.superpixel_size = int(c.get("superpixel_size", 100))
    s.if_dense_clip_supervision = bool(c.get("if_dense_clip_supervision", True))
    s.pl_sources = c.get("pl_sources", "") or ""
    s.if_sam_distillation = bool(c.get("if_sam_distillation", False))
    s.if_finetuning = bool(c.get("if_finetuning", False))
    s.load_pretrained_weights = bool(c.get("load_pretrained_weights", False))
    s.pretrained_file = c.get("pretrained_file", "") or ""
    s.if_switchable_train = bool(c.get("if_switchable_train", False))
    s.frozen_backbone = bool(c.get("frozen_backbone", False))
    s.if_linear_probing = bool(c.get("if_linear_probing", False))
    s.use_amp = bool(c.get("use_amp", False))
    # dirs
    s.log_dir = _get(y, "dir", "log", default="log/run")

    s.__post_init__()

    logger = logging.getLogger("openess_tpu_torch")
    if generate_log:
        log_dir = os.path.join(s.log_dir, time.strftime("%Y%m%d-%H%M%S"))
        os.makedirs(log_dir, exist_ok=True)
        shutil.copyfile(
            settings_yaml, os.path.join(log_dir, os.path.basename(settings_yaml))
        )
        s.ckpt_dir = os.path.join(log_dir, "checkpoints")
        s.vis_dir = os.path.join(log_dir, "visualization")
        os.makedirs(s.ckpt_dir, exist_ok=True)
        os.makedirs(s.vis_dir, exist_ok=True)
        logger.setLevel(logging.INFO)
        fh = logging.FileHandler(os.path.join(log_dir, "running.log"))
        fh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        )
        logger.addHandler(fh)
        s.log_dir = log_dir
    else:
        s.ckpt_dir = os.path.join(s.log_dir, "checkpoints")
        s.vis_dir = ""
    s.logger = logger
    return s
