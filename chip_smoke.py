#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``openess_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds every kernel of the port's main paths from the sources in the
checkout, holds each against its plain PyTorch version at the shapes those
paths give it, times both, then drives the paths at full width. The first
two run the flagship configuration (``configs/pretrain/DSEC/frame2voxel_fcclip_slic.yaml``:
480x640 sensor cropped to 440x640, 5 bins, T = 20 windows of 100k events,
the E2VID_lightweight UNet, the SemSegE2VID head, 11 classes, the dilated
ResNet-50 teacher at output stride 4, 100 superpixels per image, bf16) with
seeded random weights, and checks what comes out:

- the streaming segmentation server (``openess_tpu_torch.serve_stream``);
- the pretrain ``frame2voxel`` trainer (``openess_tpu_torch.training``):
  train steps on one synthetic batch, an eval step, a checkpoint written,
  restored and served.

The downstream stages follow, each through ``Trainer`` as well:

- the DSEC fine-tune with ``unfrozen_e2vid``
  (``configs/finetunes/DSEC/slic/frame2recon_fcclip_slic_100.yaml`` run as
  ``frame2voxel``: E2VID trains, K3's backward runs 60 times a step), from
  the checkpoint the pretrain phase has just written;
- the DDD17 linear probe (``configs/linear_probe/DDD17/
  frame2voxel_fcclip_slic.yaml`` with ``if_pretraining`` off: 260x346 sensor
  voxelized by K4, resized and cropped to 200x352, T = 20 windows of 32 000
  events, 6 classes, only the head's ``linear_probe`` conv trains), and the
  streaming server on the same settings.

Then the grid wire (``tpu.wire_format: grid``), where the loaders make
``event`` once per batch: on the card (``tpu.host_voxelize: false``; K5
for DSEC, K6 for DDD17) or on the host (the C++ voxelizers of
``openess_tpu_torch/native.py``, and DSEC's histogram); each through
``Trainer``'s ``PrefetchLoader`` at ``num_cpu_workers`` 1 and 4:

- the flagship pretrain trainer on one DSEC batch's padded windows, made
  here (the card machine has no h5py to read a DSEC tree) and turned into
  the batch by ``data/dsec.event_batch``;
- the DDD17 linear probe read from a DDD17 tree that this script writes
  with numpy and PIL: ``build_datasets`` -> ``train_epoch`` ->
  ``val_epoch``.

The host's part: the C++ packer (``native.chunk_events_windows_host``)
packs every wire here, served windows included, and is timed on one thread
and on every core against the numpy chunker, its plain version, on the
flagship and DDD17 batches; the grid runs report the loader's time, its
share of a step and the share hidden behind the step, hold the host grids
against K5's and K6's, and, with 4 workers, the delivered batches against
in-line assembly. These numbers, with the host's core count, are printed
as one ``{"host": [...]}`` line before the kernels' line.

Then the frame/recon workloads, the DeepLabV3-ResNet50 student (output
stride 16, train-mode BatchNorm, ``student_fold_bn`` in eval) at the same
440x640, B = 8, bf16, 11 classes, each through ``Trainer`` on one
synthetic batch (random frames and reconstructions, block superpixels and
labels):

- T8-pretrain-recon (``configs/pretrain/DSEC/frame2recon_fcclip_slic.yaml``:
  the student against the frame teacher, NCE through K2 on the student's
  f32 features and the teacher's, dense CLIP, augmentation on), then
  ``val_epoch`` with the folded trunk and a checkpoint;
- F8-finetune-recon (``configs/finetunes/DSEC/slic/
  frame2recon_fcclip_slic_100.yaml`` as shipped) from that checkpoint;
- U8-uda-recon (``configs/linear_probe/DSEC/frame2recon_fcclip_sam.yaml``
  as shipped: UDA with two students);
- an f32 reference of the pretrain ``frame2recon`` step, CUDA against the
  CPU, at 64x96.

Around the trainer (since the tenth slice): the fine-tune runs a second
time with ``tpu.e2vid_s2d`` (E2VID's space-to-depth form) on the same
batch and checkpoint, the head's and enc0's weight gradients are profiled
alone in both forms, and an f32 step holds the s2d form to the standard
one on the card; ``val_epoch`` with ``vis_dir`` writes the JAX trainer's
five PNGs on a DSEC and a DDD17 raw-wire batch (K1 and K4 previews); two
T8-pretrain steps run under ``utils/profiling.trace`` (``--profile``'s
trace) and its file is read back; random weights written in the four
released layouts go through ``python -m openess_tpu_torch.convert_checkpoints``
and ``checkpoint.pretrained_file`` into CUDA model sets and one served
window; and ``python -m openess_tpu_torch.bench`` runs once at full width
in its own process, its JSON line printed on a line of its own.

The serving export (since the eleventh slice): ``export_model``'s build
functions export the flagship serving step at S = 1 and 8 and the batch step (B = 8,
T = 20) on the card (the export's time, the artifact's size and its
``lstm_gates_fwd`` nodes, K3's ``torch.library`` op), ``serve_stream``
serves 20 windows through each streaming artifact beside the live server
(labels equal window by window, logits within ``EXPORT_LOGIT_REL_TOL``,
p50 and p95 side by side), the batch artifact runs against eager
``StepBuilder.infer`` on one flagship grid batch, and an S = 1 DDD17
artifact serves 10 windows beside the live DDD17 server (K4 on the
artifact path); the host time a K3 call spends in its op is printed beside
the op's CUDA implementation called directly.

The offline tier and the MFU probe (since the twelfth slice), each with
seeded random weights written in the released layouts, in temporary
directories: O-recon-DSEC, ``generate_reconstructions.reconstruct_label``
(the DSEC tree mode's work for one label; the card machine has no h5py to
read a tree) on three labels of 20 windows x 100 000 uniform events at
480x640, bf16 with K3 (60 launches an image), held in f32 against the
plain gates before quantization; O-recon-file, ``generate_reconstructions
--events_file`` on a 480x640 text stream (``--fixed_duration``,
``--auto_hdr``; pandas, which the fixed-count reader needs, is reported);
O-slic, ``generate_superpixels_slic`` and ``generate_superpixels_sam
--backend slic`` on a DSEC (480x640, n 100) and a DDD17 (260x346, n 25)
frame tree, failing on any ``FAILED`` line; O-maskclip-PL,
``generate_pseudo_labels --teacher maskclip`` (ViT-B/16 at full width, 36
text rows remapped to 11 classes, bf16) on the DSEC tree, its f32 logits
on the card against the CPU; O-eval-af, ``eval_annotation_free``'s
MaskCLIP scoring of a DDD17 validation recording; P-mfu-probe,
``python -m openess_tpu_torch.mfu_ledger_probe`` on the flagship YAML, run
in this process so that K1, K2 and K3 count.

FC-CLIP and the assets' preflight (since the thirteenth slice), on a
seeded random FC-CLIP file in the released layout (the released
convnext_large_d_320 width, torch's seeded init, 847 tensors with
``criterion.empty_weight``, ~1.5 GB in f32) and a synthetic merges file
(48 894 distinct lines) in the temporary directory: O-fcclip-PL,
``generate_pseudo_labels --teacher fcclip`` on four DSEC (480x640) and
four DDD17 (200x352) frames in bf16, then the file's load and validation,
the 504-prompt classifier, the trunk, the pixel decoder (and its
deformable sampling alone), the transformer decoder and the
post-processing timed apart by CUDA events, and the peak memory; FC-CLIP
f32, the full-width image path on one 480x640 frame in f32 on the card
(TF32 off) against the CPU with the same text classifier, the text tower
on 14 prompts likewise, and the bf16 labels against the f32 ones;
O-eval-af-fcclip, ``eval_annotation_free``'s FC-CLIP scoring of
O-eval-af's recording; preflight, ``python -m openess_tpu_torch.preflight
--fcclip --bpe`` on the files (PASS) and on a copy with one shape wrong
(FAIL naming the key). And L-raw-wire, after the DSEC grid runs: raw-wire
DSEC batches assembled by three ``PrefetchLoader`` workers with the
packer's recycled buffers, each on its own stream, against in-line
assembly, key by key, over several epochs.

Data parallelism (since the fourteenth slice), after the ``frame2recon``
phases; each rank is this script run as ``python3 chip_smoke.py
--dp-rank DIR`` under torchrun's environment (a free localhost port), its
jobs in ``DIR/spec.json``, its results in ``DIR/rank<r>.pt``, its output in
``DIR/rank<r>.log`` (printed when a rank fails); the launches run in the
background (``dp_start``, ``dp_wait``) while this process runs the
one-process references and, beside the M and SP ranks, the released
checkpoints and the offline tier (``rank_phases``; their numbers are
taken on a card and host the ranks share): D1-nccl, one rank over NCCL against the
one-process flagship pretrain step (B = 8, bf16, augmentation on, 1 + 3
steps) run before and after it in the same process, bitwise where that
step repeats bitwise and otherwise no farther from it than its two runs
from each other; D2, two gloo ranks sharing the card at a global B = 8 (4
a rank), every job in one launch, each rank's batch assembled by the
trainer's loader (``PrefetchLoader`` with the mesh): D2-pretrain (the
flagship pretrain step in bf16, the per-rank step, the gradient all-reduce
and the idle share, a checkpoint; and in f32 with TF32 off at B = 4
against two one-process runs and the f64 step of the same batch,
``dp_f32_errors``), D2-pretrain-recon (T8-pretrain-recon's step likewise,
the synced BatchNorm's running statistics against one process) and
D2-finetune (F8's fine-tune with ``unfrozen_e2vid`` from D2-pretrain's
checkpoint through ``Trainer`` on both ranks: a padded ``val_epoch`` whose
confusion, summed over the ranks, counts one process's pixels; its bf16
labels held per pixel by the M and SP phases' rule (``label_moves``:
moved only where one process's top-two gap is within 4e of its bf16
logits' distance from its f32 ones, TF32 off, and no farther from the f32
labels than one process's), the same ``val_epoch`` in f32 on the ranks
(no step) labelled as one process does but for at most
``DP_LABEL_FLIPS`` of the pixels, one process's own bf16 val_epoch again
at B = 8 and at a rank's batch of 4 printed as witnesses; then 2 steps,
K3's backward 60 a rank and step). Every rank's launches count in the kernels line. The D2
numbers are host-staged gloo collectives on one shared card, not a
multi-card figure.

Channel tensor parallelism (``parallel/tp.py``),
after D2, on gloo ranks sharing the card (``--dp-rank`` with the spec's
model size): first K3's forward and backward at a model rank's shapes
(``C/2`` of each gate, B = 2 at 440x640, bf16 and f32) against their
plain versions; then M2 (data 1 x model 2, one launch of two ranks, global
B = 2, both rows on each rank): M2-pretrain (the flagship pretrain step
with its 55 wide convs sharded, bf16 1 + 3 steps with the per-rank step,
the bytes gathered and summed over the model group a step, the seconds of
those exchanges in the last step, the sharded parameter bytes, the peak
and the idle share of a profiled step; a checkpoint loaded into one
process and compared tensor by tensor with the ranks' gathered
parameters; and f32 with TF32 off against two one-process runs and the
f64 step, ``dp_f32_errors``, step 2's losses within ``TP_LOSS2_REL``),
M2-pretrain-recon (T8-pretrain-recon's step likewise, the student's
running statistics) and M2-finetune (F8's fine-tune from M2-pretrain's
checkpoint through ``Trainer``: a padded ``val_epoch``, 2 steps, K3's
backward 60 a rank and step on ``C/2``; in f32 the labels are one
process's, in bf16 a rank may label otherwise only where one process's
top-two gap is within the bf16 forward's own error against f32, and is
no farther from the f32 labels than one process); then DM4-pretrain
(data 2 x model 2, four ranks, global B = 4): the f32 step against D2's
f32 references (the same job), then bf16 1 + 2 steps. A model axis's
ranks are held bitwise equal in their parameters, gathered whole (which
within a model group shows that the gathers and the replicated
gradients' broadcast ran, and across data indexes holds each shard's
replicas together); their losses, computed by each, may round apart.

Spatial partitioning (``parallel/spatial.py``): beside the C/2 check,
K3's forward and backward at a model rank's band of E2VID's levels and K2
at its band of the 440x640 maps (B = 2, M = 2), each against its plain
version and beside its bound and its library call; beside the M phases
the SP phases, ``tp_jobs(spatial=True)`` on M2's and DM4's jobs (their
pretrain and recon one-process runs and f64 steps reused, DSP4's bf16 one
DM4's): SP2-pretrain,
SP2-pretrain-recon and SP2-finetune (data 1 x model 2, each rank a band
of the image rows of every activation; per rank the halo and image-sum
bytes a step and the exchanges' ms; the f32 fine-tune's ``val_epoch``
dumps, gathered whole, against one process's) and DSP4-pretrain (data 2
x model 2). The bf16 recon job's running statistics are held to
``DP_BF16_STATS_REL`` but for the tie-prone ``SP_BF16_TIES``, which are
printed. The M and SP phases' model sets draw their weights once a
process (``cache_weight_draws``).

The settings are built in code from those YAMLs' values, since PyYAML may be
absent where the card is (the bench, run as its own process, reads the
flagship YAML).

Phases: device, build (one nvcc per source, started together; a kernel that
spills registers fails the run), K1 vs plain (NW = 8, also launched into a
NaN-filled grid), K1's edge cases (shuffled chunks, malformed descriptors,
padding chunks, an empty window, a ragged frame, more than 256 chunks a
tile, each into a NaN-filled grid), K3 vs plain and
PyTorch's fused LSTM cell (B = 1 and 8 at 440x640, B = 8 and 1 at 200x352),
K3 backward vs plain and the cell's backward (B = 8, bf16 and f32, and with
a missing gradient), K3 forward and backward at C/2 and at a band (B = 2),
K2 vs plain (with the image structure and flat; the pretrain steps' and
DDD17 pretrain's shapes) and at a band,
serving (S=1 with the plain gate path, S=1 with K3, S=8 with K3), a
serving trace, an f32 reference check of the
CUDA server against the CPU server, the host packer (C++ against numpy,
flagship and DDD17 batches), packing one flagship batch, K1 vs plain
at NW = 160, the export (streaming S = 1 and 8, batch B = 8, T = 20),
serving through the streaming artifacts, the batch artifact, training, a training trace, an f32 reference check of the CUDA
train step against the CPU one, the fine-tune with its trace, an f32
reference check of a small fine-tune step on CUDA against the CPU, packing
one DDD17 batch, K4 vs plain (NW = 1 and 160, both polarity modes, each
also into a NaN-filled grid), K4's edge cases (shuffled chunks,
misaligned descriptors and ones beyond the clamp, zero and oversized
counts, times beyond t_range and negative, padding chunks, an empty
window, a ragged frame, each into a NaN-filled grid), the DDD17 linear
probe, DDD17 serving, the DDD17 artifact served, K5 vs plain (NW = 160, its binning passes against
theirs, its splat into a NaN-filled grid, edge cases), K6 vs plain
(NW = 160, both polarity modes, its binning passes against theirs, its
splat into a NaN-filled grid, edge cases), the DSEC grid-wire trainer
(K5, the host voxelizer, each at 1 and 4 workers, and the histogram), the
DDD17 linear probe from disk (K6 and the host voxelizer, each at 1 and 4
workers), L-raw-wire, T8-pretrain-recon, F8-finetune-recon,
U8-uda-recon (each with its trace, spans and K2's time), the
``frame2recon`` reference, D2 (the ranks, then D2-pretrain,
D2-pretrain-recon, D2-finetune), the rank phases (D1, M2 and SP2 started
together, the released checkpoints and the offline phases run beside
them, then DM4 and DSP4, one after the other; then the reports: D1-nccl, M2-pretrain, M2-pretrain-recon,
M2-finetune, DM4-pretrain, SP2-pretrain, SP2-pretrain-recon,
SP2-finetune, DSP4-pretrain), the MFU probe, the bench, and the summary (the tenth slice's phases sit beside the paths they extend: the
trace after training, the s2d fine-tune, its weight gradients and the
DSEC dumps after the fine-tune, the s2d reference after the fine-tune
reference, the DDD17 dumps after the linear probe). K1, K4, K5 and K6 are
the tile-owner splats of ``csrc/tile_splat.cuh``. The kernels'
launch counters are zeroed before each main-path run and read after it. Any
failure raises and the script exits non-zero. The last line is ``{"ok":
true, "device": {...}}``; before it come a ``{"host": [...]}`` line, a
``{"kernels": [...]}`` line and the ``nvidia-smi`` name and power limit.

No JAX and nothing of the JAX package is imported. Needs one CUDA card,
``nvcc`` (CUDA_HOME or /usr/local/cuda) and a host C++ compiler (``CXX``,
else ``c++`` or ``g++``).
"""
import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
K1_REL_TOL = 1e-5           # kernel vs plain, of max|plain|: atomics order
K3_ABS_SLACK = 1e-6         # K3: one bf16 ulp plus this near zero
K3_SHAPES = ((220, 320, 64), (110, 160, 128), (55, 80, 256))  # 440x640
K3_DDD17_SHAPES = ((100, 176, 64), (50, 88, 128), (25, 44, 256))  # 200x352
K3_SENSOR_SHAPES = ((240, 320, 64), (120, 160, 128), (60, 80, 256))  # 480x640
REF_REL_TOL = 1e-3          # f32 server, CUDA vs CPU, of max|logits|
K2_REL_TOL = 1e-5           # K2 sums vs plain, of max|plain|: atomics order
K2_FLUSH_BYTES = 1 << 30    # K2's flush: ~0.35 ms of device work, longer
                            # than its wrapper's host work (K2 is read
                            # behind the 256 MB one too)
TRAIN_LOSS_REL_TOL = 1e-3   # f32 train step, CUDA vs CPU, each loss
TRAIN_GRAD_REL_TOL = 1e-3   # ... gradients of the head's plain convs
TRAIN_INORM_GRAD_REL_TOL = 1e-1  # ... of its instance-normalized convs
TRAIN_STEPS = 6             # train steps driven on the flagship batch
DOWNSTREAM_STEPS = 4        # ... on the fine-tune and linear-probe batches
RECON_DOWNSTREAM_STEPS = 3  # ... on the frame2recon fine-tune and UDA
K3_BWD_F32_REL_TOL = 1e-5   # K3 backward in f32, of max|plain|: exp() differs
                            # in the last bits between kernel and PyTorch and
                            # 1 - tanh^2, 1 - g^2 cancel, so the error of a
                            # small gradient is set by its factors' size
K4_REL_TOL = 1e-5           # K4 vs plain, of max|plain|: atomics order
K56_REL_TOL = 1e-5          # K5, K6 vs plain, of max|plain|: atomics order
GRID_STEPS = 3              # train steps through the DSEC grid-wire loader
GRID_WORKERS = (1, 4)       # num_cpu_workers of the grid cells' runs
HOST_GRID_REL_TOL = 1e-5    # host-voxelized grid vs K5's / K6's, of max
RECON_GRAD_L2_TOL = 6e-2    # f32 frame2recon step, CUDA vs CPU, each
                            # gradient tensor's relative L2 error
RECON_GRAD_MEDIAN_TOL = 1e-2  # ... its median over the tensors
S2D_REL_TOL = 1e-4          # f32 s2d form vs the standard form on the card,
                            # of each tensor's max (latents, loss, E2VID's
                            # gradients of a projection of its latents)
S2D_RELU_GRAD_REL_TOL = 1e-1  # ... E2VID's gradients through its ReLUs
S2D_F64_GRAD_REL_TOL = 1e-8  # ... the same gradients with E2VID in f64
EXPORT_LOGIT_REL_TOL = 1e-3  # artifact vs the live module it was traced
                            # from, bf16 on the card, of max|logits|: the
                            # same kernels in the same order (measured 0)
EXPORT_WINDOWS = 20         # windows served through each DSEC artifact
EXPORT_DDD17_WINDOWS = 10   # ... through the DDD17 one
BENCH_TIMEOUT_S = 600       # python -m openess_tpu_torch.bench at full width
BENCH_KEYS = (              # keys its line must carry
    "native_host_events_per_s", "pretrain_step_ms_b8", "device_samples_per_s",
    "pretrain_step_ms_b8_teacher_os8", "eval_fwd_ms_b8",
    "train_flops_per_step", "mfu_pct", "streaming_window_ms",
    "streaming_window_ms_s4", "streaming_window_ms_s8",
    "streaming_streams_at_20hz", "host_chunk_pack_ms_b8",
    "host_grid_voxelize_ms_b8", "host_assembly_ms_b8", "host_threads",
    "h2d_put_ms_b8", "pipeline_step_ms_b8_measured", "device_kind",
    "power_limit_w")
RECON_F32_ABS_TOL = 1e-4    # reconstruction, f32 K3 vs f32 plain gates
RECON_BF16_ABS_TOL = 2e-2   # ... bf16 K3 vs f32 plain gates ([0, 1] image)
MASKCLIP_REL_TOL = 1e-3     # MaskCLIP f32 logits, CUDA vs CPU, of max
FCCLIP_REL_TOL = 1e-3       # FC-CLIP f32 class scores / text, CUDA vs CPU
RAW_LOADER_EPOCHS = 6       # L-raw-wire: epochs of 4 batches compared
DP_STEPS = 3                # timed steps of the D phases, after 1 warm-up
D2_STEPS = 2                # ... of D2's bf16 recon job and fine-tune epoch
                            # (cut from 3 to make room for the M phases)
DP_BF16_LOSS_REL = 2e-2     # D2 bf16: each step's losses, 2 ranks vs 1
DP_F32_BATCH = 4            # global batch of the D2 f32 checks (2 a rank)
DP_F32_LOSS_REL = 1e-5      # D2 f32, TF32 off: step 1's losses
DP_F32_GRAD_L2 = 1e-4       # ... the gradients after step 1, rel. L2
DP_F32_STATS_REL = 1e-4     # ... BatchNorm running statistics, of max
DP_BF16_STATS_REL = 5e-2    # D2 bf16: running statistics after step 1,
                            # of max (bf16 convolutions round otherwise at
                            # B = 4 than at 8)
DP_NONDET_FACTOR = 4        # D1 where the step does not repeat bit for
                            # bit: its distance from the one-process step
                            # against two one-process runs' distance
DP_ZERO_GRAD = 1e-9         # D2 f32: a gradient tensor zero to rounding,
                            # of the whole f64 gradient's norm
DP_F64_FACTOR = 2           # ... the ranks' gradient error against the f64
                            # step, against the one process's
DP_EVENT_F32_GRAD_L2 = 4e-3  # ... all gradients, ranks vs one process, on
                            # the event path (the head's instance-normalized
                            # convs: the one-process step against itself
                            # 1.04e-3 to 1.21e-3, K1's f32 atomics)
DP_RECON_F32_GRAD_L2 = 2e-3  # ... on frame2recon (measured 6.2e-4: the
                            # train-mode BatchNorms' sums in another order)
DP_LABEL_FLIPS = 1e-5       # the fine-tunes' val_epoch (D2, M2, SP2): the
                            # share of pixels whose f32 label may differ
                            # from one process's, and whose bf16 label may
                            # move where one process's top-two gap is beyond
                            # 4e (e its bf16 logits' distance from f32)
DP_RANK_TIMEOUT_S = 900     # a D launch's ranks, every job included
VIS_FILES = ("confusion", "confusion_norm", "semseg_pred_gt",
             "event_preview", "pca_latent")  # the JAX trainer's dumps


def flagship_settings(**overrides):
    """The flagship YAML's settings, built in code."""
    from openess_tpu_torch.config.settings import Settings

    log_dir = "log/pretrain_frame2voxel_fcclip_slic"
    s = Settings(
        dataset_name_b="DSEC_events", dataset_path_b="data/DSEC",
        img_size_b=(440, 640), nr_events_data_b=20, delta_t_per_data_b=50,
        nr_events_window_b=100000, event_representation_b="voxel_grid",
        nr_temporal_bins_b=5, semseg_num_classes=11, batch_size_b=8,
        task_loss=("dice", "cross_entropy"), log_dir=log_dir,
        ckpt_dir=os.path.join(log_dir, "checkpoints"),
        text_embeddings_path="maskclip_weights/event_ViT16_clip_text_dsec.pth",
        maskclip_checkpoint="maskclip_weights/ViT16_clip_backbone.pth",
        visual_projs_path="maskclip_weights/ViT16_clip_weights.pth",
        output_stride=32, config_option="frame2voxel", if_pretraining=True,
        superpixel_sources="sp_slic_rgb", superpixel_size=100,
        compute_dtype="bfloat16",
    )
    return dataclasses.replace(s, **overrides)


def finetune_settings(**overrides):
    """``configs/finetunes/DSEC/slic/frame2recon_fcclip_slic_100.yaml`` run
    as ``frame2voxel`` (its DeepLabV3 student is not on the event path),
    built in code."""
    from openess_tpu_torch.config.settings import Settings

    log_dir = "log/finetune/dsec_frame2recon_fcclip_slic_100"
    s = Settings(
        num_cpu_workers=4, unfrozen_e2vid=True,
        dataset_name_b="DSEC_events", dataset_path_b="data/DSEC",
        img_size_b=(440, 640), nr_events_data_b=20, delta_t_per_data_b=50,
        nr_events_window_b=100000, event_representation_b="voxel_grid",
        nr_temporal_bins_b=5, semseg_num_classes=11, batch_size_b=8,
        lr_voxel=1e-5, lr_recon=1e-5, lr_frame=1e-5, num_epochs=1000,
        task_loss=("dice", "cross_entropy"), log_dir=log_dir,
        ckpt_dir=os.path.join(log_dir, "checkpoints"),
        load_pretrained_weights=True, skip_ratio=100,
        text_embeddings_path="maskclip_weights/event_ViT16_clip_text_dsec.pth",
        maskclip_checkpoint="maskclip_weights/ViT16_clip_backbone.pth",
        visual_projs_path="maskclip_weights/ViT16_clip_weights.pth",
        output_stride=32, config_option="frame2voxel", if_finetuning=True,
        if_switchable_train=True, if_spatial_contrastive=False,
        if_dense_clip_supervision=False, superpixel_sources="sp_slic_rgb",
        superpixel_size=100, compute_dtype="bfloat16",
    )
    return dataclasses.replace(s, **overrides)


def ddd17_probe_settings(**overrides):
    """``configs/linear_probe/DDD17/frame2voxel_fcclip_slic.yaml`` with
    ``if_pretraining`` off (the shipped file leaves it on, which dispatches
    to pretrain), built in code."""
    from openess_tpu_torch.config.settings import Settings

    log_dir = "log/linear_prob_frame2voxel_fcclip_slic"
    s = Settings(
        dataset_name_b="DDD17_events", dataset_path_b="data/DDD17",
        img_size_b=(200, 346), nr_events_data_b=20, delta_t_per_data_b=50,
        nr_events_window_b=32000, event_representation_b="voxel_grid",
        nr_temporal_bins_b=5, semseg_num_classes=6, batch_size_b=8,
        task_loss=("dice", "cross_entropy"), log_dir=log_dir,
        ckpt_dir=os.path.join(log_dir, "checkpoints"),
        text_embeddings_path="maskclip_weights/ddd17_ViT16_clip_text.pth",
        maskclip_checkpoint="maskclip_weights/ViT16_clip_backbone.pth",
        visual_projs_path="maskclip_weights/ViT16_clip_weights.pth",
        output_stride=32, pretrained_backbone="*********************",
        config_option="frame2voxel", if_pretraining=False,
        superpixel_sources="sp_slic_rgb", superpixel_size=25,
        if_linear_probing=True, compute_dtype="bfloat16",
    )
    return dataclasses.replace(s, **overrides)


def recon_pretrain_settings(**overrides):
    """``configs/pretrain/DSEC/frame2recon_fcclip_slic.yaml``, built in
    code: the flagship YAML with the DeepLabV3 student on
    reconstructions."""
    log_dir = "log/pretrain_frame2recon_fcclip_slic"
    s = flagship_settings(config_option="frame2recon", log_dir=log_dir,
                          ckpt_dir=os.path.join(log_dir, "checkpoints"))
    return dataclasses.replace(s, **overrides)


def uda_recon_settings(**overrides):
    """``configs/linear_probe/DSEC/frame2recon_fcclip_sam.yaml`` as
    shipped, built in code: its ``if_linear_probing`` sits outside the
    ``clip`` section, so it dispatches to UDA (the ``openess`` task) on
    ``frame2recon``, with the contrastive and dense-CLIP losses off."""
    log_dir = "log/linear_prob_frame2recon_fcclip_sam"
    s = flagship_settings(
        config_option="frame2recon", log_dir=log_dir,
        ckpt_dir=os.path.join(log_dir, "checkpoints"),
        pretrained_backbone="*********************", if_pretraining=False,
        superpixel_sources="sp_sam_rgb", if_spatial_contrastive=False,
        if_dense_clip_supervision=False)
    return dataclasses.replace(s, **overrides)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, flush, iters=20, warmup=3):
    """Median device milliseconds of ``fn()`` by CUDA events. Before each
    timed call the 256 MB ``flush`` buffer is zeroed: that evicts the 50 MB
    L2, and it keeps the device busy for ~0.1 ms while the host enqueues
    ``fn``'s launches, so the events time the device work and not the
    host's launch latency."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_moved, ops, ops_per_s):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase(name):
    print(f"\n== {name} (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


def ptxas_kernels(lib_path):
    """``[(kernel, registers, spill bytes stored + loaded)]`` from the
    ``-Xptxas -v`` log that ``ops/_build`` keeps beside a library; names
    demangled by ``c++filt`` where the machine has it."""
    import re
    import shutil

    with open(os.path.splitext(lib_path)[0] + ".log") as f:
        log = f.read()
    rows, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append([name, int(m.group(1)), spills])
            name, spills = None, 0
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True).stdout.split("\n")
        for r, d in zip(rows, out):
            d = d.replace("(anonymous namespace)::", "").split("(")[0]
            r[0] = d.strip() or r[0]
    for r in rows:  # what c++filt left mangled: the last name of _ZN...E
        m = re.match(r"_ZN?((?:\d+\w*?)+)E", r[0])
        parts, rest = [], m.group(1) if m else ""
        while rest[:1].isdigit():
            n = re.match(r"\d+", rest).group()
            parts.append(rest[len(n):len(n) + int(n)])
            rest = rest[len(n) + int(n):]
        r[0] = parts[-1] if parts else r[0]
    return [tuple(r) for r in rows]


def k3_library_fwd(torch, gates, pc):
    """PyTorch's fused LSTM cell on K3's forward inputs, the library
    yardstick (timed, used nowhere in the port): its gate order is i, f, g,
    o, its hidden-side gates are zero here, no biases. Returns the call and
    the ``(h, c)`` it gives, as ``[pixels, C]``."""
    c = pc.shape[-1]
    n = pc.numel() // c
    lg = torch.cat([gates[..., :2 * c], gates[..., 3 * c:],
                    gates[..., 2 * c:3 * c]], -1).reshape(n, 4 * c)
    zeros, cx = torch.zeros_like(lg), pc.reshape(n, c)
    run = lambda: torch.ops.aten._thnn_fused_lstm_cell(lg, zeros, cx)
    h, cy, _ = run()
    return run, (h, cy)


def k3_library_bwd(torch, gates, pc, dh, dcn):
    """PyTorch's fused LSTM cell backward on K3's backward inputs (its
    forward's workspace made first), the library yardstick. Returns the
    call and ``(dgates, dprev_cell)`` reordered to K3's layout, as
    ``[pixels, 4C]`` and ``[pixels, C]``."""
    c = pc.shape[-1]
    n = pc.numel() // c
    lg = torch.cat([gates[..., :2 * c], gates[..., 3 * c:],
                    gates[..., 2 * c:3 * c]], -1).reshape(n, 4 * c)
    cx = pc.reshape(n, c)
    _, cy, work = torch.ops.aten._thnn_fused_lstm_cell(
        lg, torch.zeros_like(lg), cx)
    del lg
    gh, gc = dh.reshape(n, c), dcn.reshape(n, c)
    run = lambda: torch.ops.aten._thnn_fused_lstm_cell_backward_impl(
        gh, gc, cx, cy, work, False)
    lgates, lcx, _ = run()
    lgates = torch.cat([lgates[:, :2 * c], lgates[:, 3 * c:],
                        lgates[:, 2 * c:3 * c]], -1)
    return run, (lgates, lcx)


def block_superpixels(b, h, w, rows=10, cols=10):
    """Grid-block superpixels ``[b, h, w]`` int32 with ids below
    ``rows * cols``: spatially coherent, as SLIC gives and the synthetic
    dataset builds."""
    ry = np.minimum((np.arange(h) * rows) // h, rows - 1)
    rx = np.minimum((np.arange(w) * cols) // w, cols - 1)
    sp = (ry[:, None] * cols + rx[None, :]).astype(np.int32)
    return np.broadcast_to(sp, (b, h, w)).copy()


def k2_times(torch, k2, dev, flushes, rows, ids, total, rpi, spi, tag):
    """K2 on ``rows`` by ``ids`` through the image structure
    (``rows_per_image``, ``segments_per_image``: the call
    ``segment_mean_pool`` makes) and flat, each held to the plain version
    (sums within ``K2_REL_TOL`` of the largest, counts exact); the first
    timed beside the plain version, the library call (``index_add_`` of
    the f32 cast plus a ``bincount``, timed here, used nowhere in the
    port) and the byte bound, and printed with each time's share of the
    bound. ``flushes``: the ``K2_FLUSH_BYTES`` one (``ms``: the device
    work, done after the wrapper's host work is) and the 256 MB one of the
    other kernels (``ms_256mb``: the host work charged where it outlasts
    the flush; K2's times before its redesign were read behind it).
    Returns ``{ms, ms_256mb, plain_ms, library_ms, bound_ms, bound_by,
    max_abs_err}``."""
    idl = ids.long()
    d = rows.shape[1]
    run_k = lambda: k2.segment_pool_sums(rows, ids, total,
                                         rows_per_image=rpi,
                                         segments_per_image=spi)
    run_f = lambda: k2.segment_pool_sums(rows, ids, total)
    run_p = lambda: k2.segment_pool_sums_plain(rows, ids, total)
    run_l = lambda: (
        torch.zeros((total, d), device=dev).index_add_(0, idl, rows.float()),
        torch.bincount(idl, minlength=total),
    )
    sp_, cp = run_p()
    sl, cl = run_l()
    scale = sp_.abs().max().item()
    lib_err = (sl - sp_).abs().max().item()
    errs = {}
    for name, run in (("image", run_k), ("flat", run_f)):
        sk, ck = run()
        torch.cuda.synchronize()
        errs[name] = (sk - sp_).abs().max().item()
        counts_ok = bool(torch.equal(ck, cp)) and bool(
            torch.equal(cl.float(), cp))
        if errs[name] > K2_REL_TOL * scale or not counts_ok:
            raise AssertionError(
                f"K2 ({name} call) disagrees with its plain version [{tag}]: "
                f"{errs[name]}, counts {'equal' if counts_ok else 'DIFFER'}")
    ms_k = cuda_ms(torch, run_k, flushes[0])
    ms_s = cuda_ms(torch, run_k, flushes[1])
    ms_p = cuda_ms(torch, run_p, flushes[0], iters=5, warmup=1)
    ms_l = cuda_ms(torch, run_l, flushes[0], iters=5, warmup=1)
    nbytes = (rows.numel() * rows.element_size() + ids.numel() * 4
              + total * d * 4 + total * 4)
    b_ms, b_by = bound(nbytes, rows.numel(), F32_OPS_PER_S)
    print(f"K2 [{tag}] max|kernel-plain| {errs['image']:.3e} with the image "
          f"structure, {errs['flat']:.3e} flat (max|plain| {scale:.2f}, "
          f"bound {K2_REL_TOL:.0e} x max), counts equal OK; kernel_ms "
          f"{ms_k:.4f} ({b_ms / ms_k:.0%} of the bound), behind 256 MB "
          f"{ms_s:.4f} ({b_ms / ms_s:.0%}); plain_ms {ms_p:.4f}; library_ms "
          f"{ms_l:.4f} (index_add_ + bincount, {b_ms / ms_l:.0%}, "
          f"max|lib-plain| {lib_err:.3e}); bound_ms {b_ms:.4f} ({b_by}; "
          f"{nbytes / 1e6:.1f} MB)")
    return dict(ms=ms_k, ms_256mb=ms_s, plain_ms=ms_p, library_ms=ms_l,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=max(errs.values()))


def k2_phase(torch, k2, dev, flushes):
    """K2 against its plain version at the train steps' shape, on block
    superpixels and on per-pixel random ids, bf16 (the voxel pretrain's
    features and the teacher's) and f32 (the DeepLabV3 student's features
    on pretrain ``frame2recon``), and at DDD17 pretrain's (``[8,200,352,
    256]``, ``superpixel_size`` 25, bf16, block superpixels); each call
    with the image structure and flat (:func:`k2_times`); the backward
    gather against autograd of the plain version. Returns the kernel row
    (bf16, block superpixels, with the other times beside)."""
    phase("K2 segment_pool_sums vs plain ([8,440,640,256], S = 100 an "
          "image; DDD17's [8,200,352,256], S = 25 an image)")
    B, H, W, D, S = 8, 440, 640, 256, 100
    gen = torch.Generator(device=dev).manual_seed(1205)
    seg = {
        "block": torch.from_numpy(block_superpixels(B, H, W)).to(dev),
        "random": torch.randint(0, S, (B, H, W), generator=gen, device=dev,
                                dtype=torch.int32),
    }
    row, worst = {}, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        feats = torch.randn((B, H, W, D), generator=gen,
                            device=dev).to(dtype)
        rows = feats.view(-1, D)
        for pattern, sp in seg.items():
            ids, total = k2.global_segment_ids(sp, S)
            tag = f"{str(dtype).split('.')[-1]}, {pattern} ids"
            got = k2_times(torch, k2, dev, flushes, rows, ids, total, H * W,
                           S, tag)
            worst = max(worst, got.pop("max_abs_err"))
            # the keys of earlier rows kept: bf16 block superpixels bare
            sfx = {(torch.bfloat16, "block"): "",
                   (torch.bfloat16, "random"): "_random_ids",
                   (torch.float32, "block"): "_f32",
                   (torch.float32, "random"): "_f32_random_ids"}[
                       (dtype, pattern)]
            if sfx:
                got.pop("bound_by")
            row.update({(f"{k}{sfx}" if k.startswith("ms") else
                         k.replace("_ms", f"_ms{sfx}")): v
                        for k, v in got.items()})
        # backward: the gather, against autograd of the plain version
        ids, total = k2.global_segment_ids(seg["block"], S)
        ids[:1000] = -1  # skipped pixels must read a zero row
        cot = torch.randn((total, D), generator=gen, device=dev)
        grads = []
        for fn in (lambda f: k2.segment_pool_sums(
                       f, ids, total, rows_per_image=H * W,
                       segments_per_image=S),
                   lambda f: k2.segment_pool_sums_plain(f, ids, total)):
            leaf = rows.detach().clone().requires_grad_(True)
            sums, _ = fn(leaf)
            (sums * cot).sum().backward()
            grads.append(leaf.grad)
        torch.cuda.synchronize()
        same = bool(torch.equal(grads[0], grads[1]))
        print(f"K2 [{str(dtype).split('.')[-1]}] backward gather vs autograd "
              f"of plain: dtype {grads[0].dtype}, "
              f"{'identical' if same else 'DIFFERS'}; skipped rows zero: "
              f"{bool((grads[0][:1000] == 0).all())}")
        if not same or grads[0].dtype != dtype:
            raise AssertionError("K2 backward disagrees with the plain one")
        del feats, rows, grads, leaf, sums
    # DDD17 pretrain: 200x352 after the crop, superpixel_size 25
    B, H, W, S = 8, 200, 352, 25
    sp = torch.from_numpy(block_superpixels(B, H, W, 5, 5)).to(dev)
    rows = torch.randn((B * H * W, D), generator=gen,
                       device=dev).to(torch.bfloat16)
    ids, total = k2.global_segment_ids(sp, S)
    got = k2_times(torch, k2, dev, flushes, rows, ids, total, H * W, S,
                   "DDD17 [8,200,352,256], bf16, block ids")
    worst = max(worst, got.pop("max_abs_err"))
    got.pop("bound_by")
    row.update({(f"{k}_ddd17" if k.startswith("ms") else
                 k.replace("_ms", "_ms_ddd17")): v for k, v in got.items()})
    del rows
    return dict(
        name="K2 segment_pool_sums (superpixel pooling)", route="cuda",
        source="openess_tpu_torch/csrc/segment_pool.cu",
        replaces="openess_tpu/ops/segment_pool.py:82",
        max_abs_err=worst,
        check=f"ok: max|kernel-plain| <= {K2_REL_TOL:g} x max|plain|, counts "
              "equal, with the image structure and flat; bf16 (the voxel "
              "pretrain's features, the teacher's) and f32 (the DeepLabV3 "
              "student's on pretrain frame2recon), block and random ids, "
              "and DDD17 pretrain's shape; ms is bf16 on block "
              "superpixels with the image structure behind the 1 GiB "
              "flush, ms_256mb behind the 256 MB one, ms_f32 f32", **row,
    )


def flagship_events(s, batch=8, seed=0):
    """``(rng, (x, y, p, t, valid))``: the flagship batch's ``batch * T``
    windows of K uniform events on the 480x640 sensor, float64 times
    sorted, all valid; ``rng`` continues for the rest of the batch."""
    rng = np.random.default_rng(seed)
    nw, K = batch * s.nr_events_data_b, s.nr_events_window_b
    x = rng.uniform(0, 639, (nw, K)).astype(np.float32)
    y = rng.uniform(0, 479, (nw, K)).astype(np.float32)
    p = rng.integers(0, 2, (nw, K)).astype(np.float32)
    t = np.sort(rng.uniform(0, 5e4, (nw, K)), axis=1)
    return rng, (x, y, p, t, np.ones((nw, K), bool))


def flagship_batch(s, k1=None, batch=8, seed=0):
    """One synthetic flagship batch on the host (numpy): uniform events on
    the 480x640 sensor packed onto the wire by the C++ packer on every
    core, random frames, block superpixels, and pseudo-labels constant per
    superpixel block drawn from a skewed class distribution (so a few steps
    can lower the pseudo-label loss by learning the class prior). Returns
    ``(batch, pack seconds)``. ``k1`` is not used (older callers pass the
    K1 module)."""
    from openess_tpu_torch.data.device_voxelize import pack_wire_batch
    from openess_tpu_torch.native import chunk_events_windows_host

    H, W = (int(v) for v in s.img_size_b)
    T, C = s.nr_events_data_b, s.semseg_num_classes
    rng, events = flagship_events(s, batch, seed)
    t0 = time.perf_counter()
    wire = chunk_events_windows_host(*events, height=480, width=640,
                                     t16=s.wire_t16,
                                     n_threads=os.cpu_count())
    pack_s = time.perf_counter() - t0
    sp = block_superpixels(batch, H, W)
    pl = block_labels(rng, batch, H, W, C)
    out = {
        "frame": rng.uniform(0, 1, (batch, H, W, 3)).astype(np.float32),
        "label": rng.integers(0, C, (batch, H, W)).astype(np.int32),
        "pl": pl,
        "superpixel": sp,
    }
    out.update(pack_wire_batch(wire, batch, T))
    return out, pack_s


def host_row(host, **row):
    """Append one row of host numbers (the ``{"host": [...]}`` line), with
    the host's core count, and return it."""
    row["cores"] = os.cpu_count()
    host.append(row)
    return row


def packer_phase(smi, host):
    """The C++ packer against the numpy chunker at the two training
    batches: the flagship's (160 windows x 100 000 events, 480x640, the
    v2 time wire) and DDD17's (160 x 32 000 integer pixels, 260x346), the
    C++ packer on one thread and on every core, the numpy chunker once, in
    the same run. The wires must be bit-identical (the C++ wire trimmed,
    the numpy one sliced to its width, nothing cut but empty chunks)."""
    from openess_tpu_torch.native import chunk_events_windows_host
    from openess_tpu_torch.ops.voxelize_chunked import chunk_events_batch

    phase("host packer: C++ vs numpy (flagship and DDD17 training batches)")
    cores = os.cpu_count()
    flag = flagship_settings()
    probe = ddd17_probe_settings()
    _, windows = ddd17_windows(probe)
    b, t = len(windows), probe.nr_events_data_b
    ddd = [np.stack([w[i] for w in windows]).reshape(b * t, -1)
           for i in range(5)]
    ddd[3] = ddd[3].astype(np.float64)
    cases = (
        ("flagship", flagship_events(flag)[1],
         dict(height=480, width=640, t16=flag.wire_t16)),
        ("DDD17", tuple(ddd), dict(height=260, width=346, t16=probe.wire_t16,
                                   integer_coords=True)),
    )
    for name, events, kw in cases:
        ms = {}
        for n in sorted({1, cores}):
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                wire = chunk_events_windows_host(*events, n_threads=n, **kw)
                runs.append((time.perf_counter() - t0) * 1e3)
            ms[n] = float(np.median(runs))
        t0 = time.perf_counter()
        ref = chunk_events_batch(*events, **kw)
        numpy_ms = (time.perf_counter() - t0) * 1e3
        nbc, cap = wire[0].shape[1], ref[0].shape[1]
        same = not ref[4][:, nbc:].any() and all(
            g.dtype == r.dtype
            and np.array_equal(g, r[:, :nbc] if r.ndim > 1 else r)
            for g, r in zip(wire, ref))
        nw, k = events[0].shape
        print(f"{name} [{nw} windows x {k} events, {kw['height']}x"
              f"{kw['width']}]: C++ 1 thread {ms[1]:.1f} ms, {cores} threads "
              f"{ms[cores]:.1f} ms; numpy {numpy_ms:.1f} ms "
              f"({numpy_ms / ms[cores]:.0f}x the C++ on every core); trimmed "
              f"chunk axis {nbc} of {cap}; C++ and numpy wires "
              f"{'bit-identical' if same else 'DIFFER'}; host cores {cores}; "
              f"on {smi}")
        host_row(host, name=f"packer {name}", windows=nw, events=k,
                 cpp_ms_1_thread=ms[1], cpp_ms_all_cores=ms[cores],
                 numpy_ms=numpy_ms, nbc=nbc, nbc_cap=cap, bit_identical=same)
        if not same:
            raise AssertionError(f"the C++ packer's {name} wire differs "
                                 "from the numpy chunker's")
        del ref, wire


def nan_prefilled(torch, launch_into, ref):
    """``launch_into(grid)`` on a grid of ``ref``'s shape filled with NaN
    first: the tile-owner splats write every cell, so a NaN left anywhere
    shows. Returns ``(max|grid - ref|, grid)``, inf where a NaN is left.
    Not a launch of the main path."""
    grid = torch.full_like(ref, float("nan"))
    launch_into(grid)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(grid).all()):
        return float("inf"), grid
    return (grid - ref).abs().max().item(), grid


def k1_edge_wire(rng, case, t16):
    """A small K1 wire for one edge case, with its frame ``(H, W)``: chunks
    shuffled along the chunk axis, malformed and unaligned descriptors,
    all-padding chunks (``counts == 0``) past the 256 a block reads at a
    time, an empty window, a ragged 100x150 synthetic frame, an odd width
    (100x151: the splat's 4-byte stores), or 16-event chunks, so that one
    tile meets more than 256 of them."""
    from openess_tpu_torch.ops import voxelize_chunked as k1

    H, W = {"ragged": (100, 150), "odd width": (100, 151)}.get(case,
                                                               (48, 96))
    chunk = 16 if case == "many chunks" else 256
    n = 5000
    x = rng.uniform(-1.5, W + 0.5, (3, n)).astype(np.float32)
    y = rng.uniform(-1.5, H + 0.5, (3, n)).astype(np.float32)
    p = rng.integers(0, 2, (3, n)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (3, n)), axis=1)
    wire = list(k1.chunk_events_batch(x, y, p, t, rng.random((3, n)) < 0.9,
                                      height=H, width=W, chunk=chunk,
                                      t16=t16))
    nbc = wire[0].shape[1]
    if case == "shuffled":
        for w in range(3):
            perm = rng.permutation(nbc)
            for a in wire[:6]:
                a[w] = a[w][perm]
    elif case == "malformed":
        h_pad, w_pad = k1.padded_grid(H, W)
        r0 = rng.integers(-20, h_pad + 20, (3, nbc))
        c0 = rng.integers(-20, w_pad + 20, (3, nbc))
        wire[5] = ((r0 & 0xFFFF) | (c0 << 16)).astype(np.int32)
    elif case == "padding chunks":
        wire = list(k1.pad_wire_chunks(tuple(wire), 300))
    elif case == "empty window":
        wire[4][1] = 0
    return tuple(wire), H, W


def k1_edge_phase(torch, k1, dev):
    """K1 against its plain version on the wires a tile owner must not
    assume away, both time wires, each launched into a NaN-filled grid.
    Returns the largest error relative to max|plain|."""
    phase("K1 edge cases (tile owner): NaN-filled output, shuffled chunks, "
          "malformed descriptors, padding chunks, an empty window, a ragged "
          "100x150 frame, >256 chunks a tile, an odd width")
    rng = np.random.default_rng(11)
    worst = 0.0
    for case in ("shuffled", "malformed", "padding chunks", "empty window",
                 "ragged", "many chunks", "odd width"):
        for t16 in (False, True):
            wire, H, W = k1_edge_wire(rng, case, t16)
            args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in wire)
            ref = k1.voxelize_chunked_trilinear_plain(
                *args, num_bins=5, height=H, width=W)
            err, got = nan_prefilled(
                torch, lambda g: k1.voxelize_chunked_trilinear_into(g, *args),
                ref)
            rel = err / ref.abs().max().item()
            # the empty window's grid is exactly zero
            empty_ok = case != "empty window" or not bool(got[1].any())
            print(f"  [{case}, {'v2 uint16' if t16 else 'v1 f32'} wire, "
                  f"{H}x{W}, {args[0].shape[1]} chunks] max|kernel-plain| "
                  f"{rel:.3e} of max {'OK' if rel <= K1_REL_TOL else 'FAIL'}")
            if not rel <= K1_REL_TOL or not empty_ok:
                raise AssertionError(f"K1 edge case {case}: {rel}")
            worst = max(worst, rel)
    return dict(edge_cases_rel_err=worst)


def k1_nw160_phase(torch, k1, dev, flush, host_batch):
    """K1 against its plain version on the whole flagship batch (NW = 160
    windows, a 983 MB f32 grid): the shape the train step launches."""
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire

    phase("K1 vs plain at NW = 160 (one flagship batch, 480x640)")
    d = upload_wire(host_batch, dev)
    args = tuple(d[k].reshape((-1,) + d[k].shape[2:]) for k in WIRE_KEYS)
    run_k = lambda: k1.voxelize_chunked_trilinear(
        *args, num_bins=5, height=480, width=640)
    got = run_k()
    ref = k1.voxelize_chunked_trilinear_plain(
        *args, num_bins=5, height=480, width=640)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    per_window = (got - ref).abs().amax(dim=(1, 2, 3))
    del got
    nan_err, _ = nan_prefilled(
        torch, lambda g: k1.voxelize_chunked_trilinear_into(g, *args), ref)
    ok = max(err, nan_err) <= K1_REL_TOL * scale
    del ref
    ms_k = cuda_ms(torch, run_k, flush, iters=5, warmup=1)
    events = int(host_batch["ev_counts"].sum())
    nbytes = (events * 7 + sum(host_batch[k].nbytes for k in
                               ("ev_counts", "ev_r0", "ev_trange"))
              + args[0].shape[0] * 5 * 480 * 640 * 4)
    b_ms, b_by = bound(nbytes, events * 8 * 6, F32_OPS_PER_S)
    print(f"K1 [NW=160] grid {(args[0].shape[0], 5, 480, 640)} "
          f"max|kernel-plain| {err:.3e}, into a NaN-filled grid "
          f"{nan_err:.3e} "
          f"(max|plain| {scale:.3f}, bound {K1_REL_TOL:.0e} x max; last "
          f"window {per_window[-1].item():.3e}) {'OK' if ok else 'FAIL'}; "
          f"kernel_ms {ms_k:.4f} bound_ms {b_ms:.4f} ({b_by}; {events} "
          f"events, {nbytes / 1e6:.1f} MB)")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"NW=160: {err}, {nan_err}")
    return dict(ms_nw160=ms_k, bound_ms_nw160=b_ms,
                max_abs_err_nw160=max(err, nan_err))


class OneBatchDataset:
    """``steps * batch`` samples that all assemble into the same host batch:
    the trainer's epoch is ``steps`` steps on one batch."""

    def __init__(self, host_batch, steps):
        self.host_batch = host_batch
        self.n = steps * host_batch["label"].shape[0]

    def __len__(self):
        return self.n

    def get_batch(self, idx):
        return dict(self.host_batch)


def device_profile(torch, fn):
    """Run ``fn`` under the profiler; returns (device-side entries, wall
    seconds, device ms per ``train/<part>`` span)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries only (kernels, memsets, copies): the CPU ops
    # that launched them report the same device time again
    events = prof.key_averages()
    # the train step's record_function spans are not device work: keep
    # them apart (host-side entry: device time of the kernels launched
    # inside the span)
    avg = [e for e in events
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
           and not e.key.startswith("train/")]
    spans = {e.key: e.device_time_total / 1e3 for e in events
             if e.key.startswith("train/")
             and e.device_type != DeviceType.CUDA}
    return avg, wall, spans


def print_profile(avg, wall, n, unit, smi):
    busy_ms = sum(e.self_device_time_total for e in avg) / 1e3
    if busy_ms <= 0:
        print("device busy time: not measured (the profiler saw no device "
              "activity)")
        return
    print(f"device busy {busy_ms / n:.3f} ms per {unit} over {n} {unit}s; "
          f"wall {wall * 1e3 / n:.1f} ms per {unit} (profiled); idle "
          f"share {1 - busy_ms / (wall * 1e3):.3f}; on {smi}")
    print(f"top device kernels, ms per {unit}:")
    for e in sorted(avg, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f}  "
              f"x{e.count // n:<4d} {e.key[:90]}")


def print_spans(avg, spans, n):
    """Device ms per step by ``train/<part>`` span of ``training/steps``."""
    if not spans:
        return
    # the backward kernels are launched by the autograd thread, outside
    # the host-side span: the backward is what the other spans leave
    busy = sum(e.self_device_time_total for e in avg) / 1e3
    named = {k[len("train/"):]: v / n for k, v in spans.items()
             if k != "train/backward"}
    named["backward (the rest)"] = busy / n - sum(named.values())
    print("device ms per step by part of the step (kernels launched "
          "inside each span): " + ", ".join(
              f"{k} {v:.2f}"
              for k, v in sorted(named.items(), key=lambda kv: -kv[1])))


def train_phase(torch, dev, smi, settings, host_batch, zero_counts,
                read_counts, ckpt_dir):
    """The flagship pretrain frame2voxel trainer at full width: an epoch of
    ``TRAIN_STEPS`` steps on one batch through ``Trainer.train_epoch``,
    timed steps, an eval step, a checkpoint served by ``StreamServer``, and
    a profile. The checkpoint stays in ``ckpt_dir`` for the stages after
    pretraining. Returns the kernels' launch counts of the epoch."""
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.metrics import MetricsSemseg
    from openess_tpu_torch.serve_stream import StreamServer, synthetic_windows
    from openess_tpu_torch.training import checkpoint as ckpt
    from openess_tpu_torch.training.trainer import Trainer, to_device

    phase("train: pretrain frame2voxel at full width, bf16 "
          "(openess_tpu_torch.training.trainer.Trainer)")
    B = host_batch["frame"].shape[0]
    s = dataclasses.replace(settings, batch_size_b=B, save_checkpoint=False)
    if B != settings.batch_size_b:
        print(f"B = {settings.batch_size_b} did not fit the card's memory: "
              f"running at B = {B}")
    print(f"settings: the flagship YAML's values with e2vid_fused_gates on; "
          f"B={B}, T={s.nr_events_data_b}, teacher_os={s.teacher_os}, "
          f"fold_bn={s.teacher_fold_bn}, superpixel_size={s.superpixel_size}, "
          f"{s.compute_dtype}; random weights, seed 0; augmentation "
          f"{'on' if s.data_augmentation_train else 'off'}")
    torch.cuda.reset_peak_memory_stats()
    data = OneBatchDataset(host_batch, TRAIN_STEPS)
    trainer = Trainer(s, data, data, seed=0, device=dev)
    sb, mset = trainer.sb, trainer.mset
    frozen = {
        f"{name}.{k}": v.clone()
        for name in ("front_sensor_b", "model_frame")
        for k, v in mset.modules[name].state_dict().items()
        if not k.startswith("decoder_conv")
    }
    head0 = {k: v.clone() for k, v in
             mset.modules["back_end"].state_dict().items()}

    # the first step (cuDNN algorithm choice, allocator growth) is run
    # apart; its loss is the run's starting point
    batch = to_device(host_batch, dev)
    t0 = time.perf_counter()
    try:
        first = {k: float(v) for k, v in sb.train_step(batch, 0).items()}
    except torch.cuda.OutOfMemoryError:
        # the one allowed retreat: the width stays, the batch halves
        if B == 1:
            raise
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"out of memory at B = {B} (peak {peak:.2f} GiB); halving B")
        del trainer, sb, mset, batch, frozen, head0
        torch.cuda.empty_cache()
        half = {k: v[:B // 2] for k, v in host_batch.items()}
        return train_phase(torch, dev, smi, settings, half, zero_counts,
                           read_counts, ckpt_dir)
    torch.cuda.synchronize()
    print(f"step 0 (warm-up, {time.perf_counter() - t0:.2f} s): {first}")

    zero_counts()
    t0 = time.perf_counter()
    avg_losses = trainer.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"Trainer.train_epoch: {TRAIN_STEPS} steps in {epoch_s:.2f} s "
          f"({epoch_s * 1e3 / TRAIN_STEPS:.1f} ms per step, host clock, "
          f"batch upload included); epoch-average losses {avg_losses}; "
          "launches " + " ".join(f"{k} {v}" for k, v in counts.items()))

    # timed steps on the resident batch: CUDA events per step
    hist, events = [], []
    for _ in range(TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses = sb.train_step(batch, 0)
        b.record()
        hist.append(losses)
        events.append((a, b))
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in events])
    hist = [{k: float(v) for k, v in h.items()} for h in hist]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train step p50 {np.percentile(ms, 50):.1f} ms p95 "
          f"{np.percentile(ms, 95):.1f} ms over {len(ms)} steps (CUDA "
          f"events, batch resident); peak memory "
          f"{peak:.2f} GiB (torch.cuda.max_memory_allocated) at B={B}; on "
          f"{smi}")
    dense = [first["dense_clip_loss"]] + [h["dense_clip_loss"] for h in hist]
    print("dense_clip_loss: step 0 " + f"{dense[0]:.4f}, timed steps "
          + " ".join(f"{v:.4f}" for v in dense[1:]))
    print("contrastive_nce_loss: timed steps "
          + " ".join(f"{h['contrastive_nce_loss']:.4f}" for h in hist))
    sd = {f"{n}.{k}": v for n in ("front_sensor_b", "model_frame")
          for k, v in mset.modules[n].state_dict().items()}
    head1 = mset.modules["back_end"].state_dict()
    moved = sum(int(not torch.equal(head0[k], head1[k])) for k in head0
                if k != "text_embeddings")
    checks = {
        "every loss finite": all(np.isfinite(v) for h in [first] + hist
                                 for v in h.values())
        and all(np.isfinite(v) for v in avg_losses.values()),
        "loss keys": set(first) == {"contrastive_nce_loss",
                                    "dense_clip_loss", "total_loss"},
        "dense_clip_loss fell": dense[-1] < dense[0],
        "frozen parameters unchanged": all(
            torch.equal(v, sd[k]) for k, v in frozen.items()),
        "head parameters moved": moved == len(head0) - 1,
        "text embeddings unchanged": torch.equal(
            head0["text_embeddings"], head1["text_embeddings"]),
        "K1 once per step": counts["K1"] == TRAIN_STEPS,
        "K3 60 per step": counts["K3"] == 60 * TRAIN_STEPS,
        "K2 twice per step": counts["K2"] == 2 * TRAIN_STEPS,
        "no K3 backward, K4, K5, K6": counts["K3_bwd"] == counts["K4"]
        == counts["K5"] == counts["K6"] == 0,
        "optimizer steps": sb.step == 1 + 2 * TRAIN_STEPS,
    }
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")

    phase("eval step, checkpoint, and the checkpoint served")
    pred, loss = sb.eval_step(batch)
    metrics = MetricsSemseg(s.semseg_num_classes, s.semseg_ignore_label,
                            s.semseg_class_names)
    metrics.update_batch(pred, batch["label"])
    summary = metrics.get_metrics_summary()
    H, W = (int(v) for v in s.img_size_b)
    eval_ok = {
        "pred shape": tuple(pred.shape) == (B, H, W),
        "pred range": 0 <= int(pred.min()) and int(pred.max())
        < s.semseg_num_classes,
        "eval loss finite": bool(torch.isfinite(loss)),
        "mIoU in [0, 100]": 0.0 <= summary["miou"] <= 100.0,
        "confusion counts every pixel": summary["cm"].sum() == B * H * W,
    }
    print(f"eval_step: loss {float(loss):.4f}, mIoU {summary['miou']:.2f} "
          f"acc {summary['acc']:.2f} against random labels; "
          + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                      for k, v in eval_ok.items()))
    if not all(eval_ok.values()):
        raise AssertionError(f"eval checks failed: {eval_ok}")
    path = ckpt.save_checkpoint(ckpt_dir, mset, trainer.optimizer, sb.step, 0)
    size_mb = os.path.getsize(path) / 1e6
    server = StreamServer(s, streams=1, device=dev, seed=1,
                          checkpoint=ckpt_dir)
    x, y, p, t = next(iter(synthetic_windows(1, 100_000, 480, 640)))
    wire = upload_wire(server.pack(x, y, p, t), dev)
    _, labels, logits = server.step(server.initial_state(), wire)
    sb._set_mode(False)
    with torch.no_grad():
        want, _ = sb._event_path(wire)  # one window from a zero state
    err = (logits.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    agree = (labels == want.argmax(-1).to(torch.uint8)).float().mean().item()
    ok = err <= 2e-2 * scale and agree >= 0.99
    print(f"checkpoint {size_mb:.1f} MB written, restored into a server "
          f"built from another seed, one window served: max|served-"
          f"trainer| logits {err:.3e} of max {scale:.3f} (bound 2e-2 x max: "
          f"bf16, the server holds the head in bf16, the trainer casts f32 "
          f"weights per call), label agreement {agree:.5f} (bound 0.99) "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the served checkpoint disagrees with the "
                             "trainer's own event path")
    del server

    phase("train trace: device busy time and idle share")
    n = 3
    avg, wall, spans = device_profile(
        torch, lambda: [sb.train_step(batch, 0) for _ in range(n)])
    print_profile(avg, wall, n, "step", smi)
    print_spans(avg, spans, n)
    trace_phase(torch, sb, batch)
    return counts


def train_reference_phase(torch, dev):
    """One f32 train step at 440x640, B = 1, T = 2 on CUDA (K1, K3, K2)
    against the same step on the CPU (plain versions), same seed."""
    from openess_tpu_torch.ops import voxelize_chunked as k1
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder
    from openess_tpu_torch.training.trainer import to_device

    phase("train reference: f32 step on CUDA (K1, K3, K2) vs on the CPU "
          "(plain), 440x640, B=1, T=2, teacher_os=4")
    s = flagship_settings(
        compute_dtype="float32", e2vid_fused_gates=True, batch_size_b=1,
        nr_events_data_b=2, data_augmentation_train=False)
    host_batch, _ = flagship_batch(s, k1, batch=1, seed=1)
    out = {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        mset = build_models(s, seed=0, device=d)
        sb = StepBuilder(s, mset, make_optimizer(s, mset), 1)
        sb._set_mode(True)
        total, losses = sb.compute_losses(
            sb._with_windows(to_device(host_batch, d)), 0)
        total.backward()
        grads = {k: p.grad.detach().cpu() for k, p in
                 mset.modules["back_end"].named_parameters()}
        dc = mset.modules["model_frame"].decoder_conv
        grads["model_frame.decoder_conv.weight"] = dc.weight.grad.cpu()
        out[d.type] = ({k: float(v.detach()) for k, v in losses.items()},
                       grads)
        if d.type == "cuda":
            torch.cuda.synchronize()
        print(f"  {d.type}: {time.perf_counter() - t0:.1f} s, losses "
              f"{out[d.type][0]}")
        del mset, sb, total, losses
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    worst_loss = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
    plain = inorm = 0.0
    for k in gc:
        scale = gc[k].abs().max().item()
        rel = (gg[k] - gc[k]).abs().max().item() / max(scale, 1e-30)
        if k.startswith("decoder_scale"):
            if k.endswith("weight"):  # biases before a norm: zero gradient
                inorm = max(inorm, rel)
        else:
            plain = max(plain, rel)
    ok = (worst_loss <= TRAIN_LOSS_REL_TOL and plain <= TRAIN_GRAD_REL_TOL
          and inorm <= TRAIN_INORM_GRAD_REL_TOL)
    print(f"max rel |cuda-cpu|: losses {worst_loss:.3e} (bound "
          f"{TRAIN_LOSS_REL_TOL:.0e}); gradients of decoder_ch256/512 and "
          f"the teacher's decoder_conv {plain:.3e} of each tensor's max "
          f"(bound {TRAIN_GRAD_REL_TOL:.0e}); of the instance-normalized "
          f"convs' weights {inorm:.3e} (bound "
          f"{TRAIN_INORM_GRAD_REL_TOL:.0e}: their f32 backward is "
          f"ill-conditioned at random init, on any device) "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CUDA train step disagrees with the CPU one")


def k3_fwd_check(torch, k3, gates, pc):
    """K3's forward against its plain version on the same inputs: ``(max
    abs error, the error in units of its bound)`` over ``h`` and ``c``, the
    bound one bf16 ulp of the larger value plus ``K3_ABS_SLACK``."""
    err, ulps = 0.0, 0.0
    for a, b in zip(k3.fused_lstm_gates(gates, pc),
                    k3.fused_lstm_gates_plain(gates, pc)):
        diff = (a.float() - b.float()).abs()
        mag = torch.maximum(a.float().abs(), b.float().abs())
        err = max(err, diff.max().item())
        ulps = max(ulps, (diff / (mag * 2.0 ** -7 + K3_ABS_SLACK))
                   .max().item())
    return err, ulps


def k3_bwd_error(torch, got, ref, bf16):
    """K3's backward against its plain version: ``(max abs error, the error
    in units of its bound)`` over ``dgates`` and ``dprev_cell``, the bound
    one bf16 ulp of the larger value plus ``K3_ABS_SLACK`` in bf16 and
    ``K3_BWD_F32_REL_TOL`` of the plain result's max in f32."""
    err, ulps = 0.0, 0.0
    for a, b in zip(got, ref):
        diff = (a.float() - b.float()).abs()
        err = max(err, diff.max().item())
        if bf16:
            mag = torch.maximum(a.float().abs(), b.float().abs())
            tol = mag * 2.0 ** -7 + K3_ABS_SLACK
        else:
            tol = K3_BWD_F32_REL_TOL * b.abs().max()
        ulps = max(ulps, (diff / tol).max().item())
    return err, ulps


def k3_b8_phase(torch, k3, dev, flush):
    """K3 at the other shapes the main paths launch it. The forward against
    its plain version at B = 8 on the 440x640 levels (a train step, serving
    eight streams) and on the 200x352 levels of DDD17 at B = 8 (the linear
    probe) and B = 1 (serving), each with its time, the library's and the
    bound; the backward against its plain version in bf16 and f32 at B = 8,
    with a missing ``dh`` or ``dc_next`` too, and the library's backward
    beside it; every time beside its bound. Returns ``(forward numbers,
    backward row)``."""
    B = 8
    phase("K3 forward vs plain at B = 8 (the train step's shapes, with time "
          "and bound) and at the DDD17 shapes")
    gen = torch.Generator(device=dev).manual_seed(1205)
    fwd, fwd_err = {}, 0.0  # (frame, b) -> [kernel, library, bound] sums
    for frame, shapes, batches in (("440x640", K3_SHAPES, (B,)),
                                   ("200x352", K3_DDD17_SHAPES, (B, 1))):
        for b, (h, w, c) in ((b, hwc) for b in batches for hwc in shapes):
            gates = (torch.randn((b, h, w, 4 * c), generator=gen, device=dev)
                     * 2).to(torch.bfloat16)
            pc = torch.randn((b, h, w, c), generator=gen,
                             device=dev).to(torch.bfloat16)
            err, ulps = k3_fwd_check(torch, k3, gates, pc)
            ok = ulps <= 1.0
            ms_k = cuda_ms(torch, lambda: k3.fused_lstm_gates(gates, pc),
                           flush)
            run_l, _ = k3_library_fwd(torch, gates, pc)
            ms_l = cuda_ms(torch, run_l, flush)
            nbytes = b * h * w * 7 * c * 2
            b_ms, _ = bound(nbytes, b * h * w * c * 30, F32_OPS_PER_S)
            print(f"K3 fwd [{frame} {b}x{h}x{w}x{c}] max|kernel-plain| "
                  f"{err:.3e} = {ulps:.3f} bf16 ulp (bound 1 ulp + "
                  f"{K3_ABS_SLACK:.0e}) {'OK' if ok else 'FAIL'}; kernel_ms "
                  f"{ms_k:.4f} library_ms {ms_l:.4f} (_thnn_fused_lstm_cell) "
                  f"bound_ms {b_ms:.4f} ({nbytes / 1e6:.1f} MB; kernel at "
                  f"{b_ms / ms_k:.0%} of it, library at {b_ms / ms_l:.0%})")
            if not ok:
                raise AssertionError(
                    f"K3 disagrees with its plain version: {ulps}")
            fwd_err = max(fwd_err, err)
            fwd.setdefault((frame, b), np.zeros(3))[:] += (ms_k, ms_l, b_ms)
            del gates, pc, run_l
    for (frame, b), (ms_k, ms_l, b_ms) in fwd.items():
        print(f"K3 fwd [{frame}, B = {b}] sum over the three levels: kernel "
              f"{ms_k:.4f} ms, library {ms_l:.4f}, bound {b_ms:.4f} (kernel "
              f"at {b_ms / ms_k:.0%} of it)")

    phase("K3 fused_lstm_gates backward vs plain (B = 8, 440x640 ConvLSTMs)")
    row, worst = None, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        size = 2 if dtype == torch.bfloat16 else 4
        sums = np.zeros(4)
        lib_ok = True
        for h, w, c in K3_SHAPES:
            gates = (torch.randn((B, h, w, 4 * c), generator=gen, device=dev)
                     * 2).to(dtype)
            pc, dh, dcn = (torch.randn((B, h, w, c), generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(3))
            run_k = lambda: k3.fused_lstm_gates_bwd(gates, pc, dh, dcn)
            run_p = lambda: k3.fused_lstm_gates_bwd_plain(gates, pc, dh, dcn)
            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            err, ulps = k3_bwd_error(torch, got, ref, bf16)
            # a missing gradient (None: the last window's cell state has no
            # consumer) against the plain version on zeros
            zero = torch.zeros_like(pc)
            missing = {}
            for label, g_h, g_c in (("dc_next=None", dh, None),
                                    ("dh=None", None, dcn)):
                e, u = k3_bwd_error(
                    torch, k3.fused_lstm_gates_bwd(gates, pc, g_h, g_c),
                    k3.fused_lstm_gates_bwd_plain(
                        gates, pc, zero if g_h is None else g_h,
                        zero if g_c is None else g_c), bf16)
                missing[label] = u
                err, ulps = max(err, e), max(ulps, u)
            del zero
            ms_none = cuda_ms(
                torch, lambda: k3.fused_lstm_gates_bwd(gates, pc, dh, None),
                flush)
            ok = ulps <= 1.0
            # library yardstick: the backward of PyTorch's fused LSTM cell
            # on the same data (its gate order is i, f, g, o; timed here,
            # used nowhere in the port)
            n = B * h * w
            ms_l, lib_err = None, None
            try:
                run_l, (lgates, lcx) = k3_library_bwd(torch, gates, pc, dh,
                                                      dcn)
                lib_err = max(
                    (lgates.float() - ref[0].reshape(n, 4 * c).float())
                    .abs().max().item(),
                    (lcx.float() - ref[1].reshape(n, c).float())
                    .abs().max().item())
                del lgates, lcx
                ms_l = cuda_ms(torch, run_l, flush, iters=10)
                del run_l
            except (RuntimeError, AttributeError, TypeError) as e:
                lib_ok = False
                print(f"  library backward not driven on this data: "
                      f"{type(e).__name__}: {str(e)[:200]}")
            ms_k = cuda_ms(torch, run_k, flush)
            ms_p = cuda_ms(torch, run_p, flush, iters=5, warmup=1)
            nbytes = n * 12 * c * size
            b_ms, _ = bound(nbytes, n * c * 60, F32_OPS_PER_S)
            lib = ("none" if ms_l is None else
                   f"{ms_l:.4f} (_thnn_fused_lstm_cell_backward_impl, "
                   f"max|lib-plain| {lib_err:.3e})")
            print(f"K3 bwd [{str(dtype).split('.')[-1]} {B}x{h}x{w}x{c}] "
                  f"max|kernel-plain| {err:.3e} = {ulps:.3f} of the bound "
                  f"({'1 bf16 ulp + 1e-6' if bf16 else '1e-5 x max|plain|'}; "
                  + ", ".join(f"{k} {v:.3f}" for k, v in missing.items())
                  + f") {'OK' if ok else 'FAIL'}; kernel_ms {ms_k:.4f} "
                  f"(dc_next=None {ms_none:.4f}) plain_ms {ms_p:.4f} "
                  f"library_ms {lib} bound_ms {b_ms:.4f} "
                  f"({nbytes / 1e6:.1f} MB; kernel at {b_ms / ms_k:.0%} of "
                  f"it" + ("" if ms_l is None else
                           f", library at {b_ms / ms_l:.0%}") + ")")
            if not ok:
                raise AssertionError(
                    f"K3 backward disagrees with its plain version: {ulps}")
            worst = max(worst, err) if dtype == torch.bfloat16 else worst
            sums += (ms_k, ms_p, ms_l or 0.0, b_ms)
            del gates, pc, dh, dcn, got, ref
        print(f"K3 bwd [{str(dtype).split('.')[-1]}, B = {B}] sum over the "
              f"three levels: kernel {sums[0]:.4f} ms, library "
              f"{f'{sums[2]:.4f}' if lib_ok else 'none'}, bound "
              f"{sums[3]:.4f} (kernel at {sums[3] / sums[0]:.0%} of it)")
        if dtype == torch.bfloat16:
            row = dict(ms=sums[0], plain_ms=sums[1],
                       library_ms=sums[2] if lib_ok else None,
                       bound_ms=sums[3], bound_by="bytes")
        else:
            row.update(ms_f32=sums[0], plain_ms_f32=sums[1],
                       library_ms_f32=sums[2] if lib_ok else None,
                       bound_ms_f32=sums[3])
    k3_cell_trace(torch, dev)
    dsec, ddd17, ddd17_1 = (fwd[k] for k in (("440x640", B), ("200x352", B),
                                              ("200x352", 1)))
    return dict(ms_b8=dsec[0], library_ms_b8=dsec[1], bound_ms_b8=dsec[2],
                ms_ddd17=ddd17[0], library_ms_ddd17=ddd17[1],
                bound_ms_ddd17=ddd17[2], ms_ddd17_b1=ddd17_1[0],
                library_ms_ddd17_b1=ddd17_1[1], bound_ms_ddd17_b1=ddd17_1[2],
                max_abs_err=fwd_err), dict(
        name="K3 fused_lstm_gates backward (3 ConvLSTMs per window, B = 8)",
        route="cuda", source="openess_tpu_torch/csrc/lstm_gates.cu",
        replaces="openess_tpu/ops/lstm_gates.py:88", max_abs_err=worst,
        check="ok: |kernel-plain| <= 1 bf16 ulp + 1e-6 (f32: 1e-5 x max|plain|"
              "), 3 shapes at B = 8; ms is the bf16 sum over the three",
        **row,
    )


def k3_cell_trace(torch, dev):
    """One ConvLSTM cell (C = 64 at 220x320, B = 8, bf16 compute, f32
    parameters) forward and backward under the profiler: which device
    kernels run around K3, so that a layout copy of ``gates`` or ``dgates``
    (288 MB each here) between the gates conv and the kernels shows, and
    fails the run."""
    from openess_tpu_torch.models.e2vid import CL, ConvLSTMCell, nchw

    print("one ConvLSTM cell under autograd (B=8, 220x320, C=64): device "
          "kernels of forward + backward")
    gen = torch.Generator(device=dev).manual_seed(7)
    cell = ConvLSTMCell(64, 64, 3, fused_gates=True).to(dev)
    rand = lambda: torch.randn((8, 64, 220, 320), generator=gen,
                               device=dev).to(torch.bfloat16).contiguous(
                                   memory_format=CL)
    x, wgt = rand().requires_grad_(True), rand()
    h0 = nchw(torch.zeros((8, 220, 320, 64), dtype=torch.bfloat16,
                          device=dev))

    def run():
        hidden, _ = cell(x, (h0, h0))
        (hidden * wgt).sum().backward()

    run()  # cuDNN algorithm choice
    avg, _, _ = device_profile(torch, run)
    for e in sorted(avg, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms x{e.count:<3d} "
              f"{e.key[:150]}")
    # the cell's own torch.cat is a copy by design; anything else that
    # copies more than a weight cast would be a layout copy
    copies = [e for e in avg if "copy" in e.key.lower()
              and "CatArray" not in e.key and e.self_device_time_total > 50]
    print(f"  copy kernels above 0.05 ms, the cell's own cat apart: "
          f"{[e.key[:60] for e in copies] or 'none'}")
    if copies:
        raise AssertionError(
            "a layout copy runs between the gates conv and K3: "
            f"{[e.key[:150] for e in copies]}")


def block_labels(rng, batch, h, w, classes, rows=10, cols=10):
    """Labels ``[batch, h, w]`` int32, constant per block of a rows x cols
    grid, drawn from a skewed class distribution: a few steps can lower the
    loss on them by learning the class prior."""
    sp = block_superpixels(batch, h, w, rows, cols)
    prior = 1.0 / (1.0 + np.arange(classes)) ** 2
    block_class = rng.choice(classes, size=(batch, rows * cols),
                             p=prior / prior.sum())
    return np.take_along_axis(block_class, sp.reshape(batch, -1),
                              axis=1).reshape(batch, h, w).astype(np.int32)


def ddd17_windows(s, batch=8, seed=0):
    """``(rng, windows)``: one synthetic DDD17 batch's padded windows,
    uniform integer-pixel events on the 260x346 sensor cut into T windows
    by ``data/ddd17.split_event_windows`` as the loader cuts them."""
    from openess_tpu_torch.data import ddd17

    rng = np.random.default_rng(seed)
    T, K = s.nr_events_data_b, s.nr_events_window_b
    windows = []
    for _ in range(batch):
        ev = np.stack([
            rng.integers(0, ddd17.WIDTH, T * K),
            rng.integers(0, ddd17.HEIGHT, T * K),
            np.sort(rng.integers(0, 10 ** 9, T * K)),
            rng.integers(0, 2, T * K),
        ], axis=1)
        windows.append(ddd17.split_event_windows(ev, T, K,
                                                 s.fixed_duration_b))
    return rng, windows


def ddd17_batch(s, batch=8, seed=0):
    """One synthetic DDD17 batch on the host: :func:`ddd17_windows` packed
    onto the wire by ``data/ddd17.wire_batch`` (the C++ packer) as the
    loader would, with block labels at 200x352. Returns ``(batch, seconds
    to cut and pack the windows)``."""
    from openess_tpu_torch.data import ddd17

    H, W = (int(v) for v in s.img_size_b)
    t0 = time.perf_counter()
    rng, windows = ddd17_windows(s, batch, seed)
    out = ddd17.wire_batch(s, windows)
    pack_s = time.perf_counter() - t0
    out["label"] = block_labels(rng, batch, H, W, s.semseg_num_classes)
    return out, pack_s


def k4_edge_wire(rng, case, t16, nw=3, n=5000, chunk=256):
    """A small K4 wire of ``nw`` windows of ``n`` events for one edge case,
    with its frame ``(H, W)``: chunks shuffled, descriptors at misaligned
    rows or columns (a chunk at r0 = 8 meets two row tiles), descriptors
    beyond the clamp, zero counts and counts above the chunk, times beyond
    ``t_range`` (tn >= bins) or negative (f32 time wire), all-padding
    chunks past the 256 a block reads at a time, an empty window, a ragged
    37x150 frame, or an odd width (37x151: the splat's 4-byte stores)."""
    from openess_tpu_torch.ops import voxelize_chunked as k1

    H, W = {"ragged": (37, 150), "odd width": (37, 151)}.get(case, (48, 300))
    x = rng.integers(-2, W + 2, (nw, n)).astype(np.float32)
    y = rng.integers(-2, H + 2, (nw, n)).astype(np.float32)
    p = rng.integers(0, 2, (nw, n)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (nw, n)), axis=1)
    wire = [np.array(a) for a in k1.chunk_events_batch(
        x, y, p, t, rng.random((nw, n)) < 0.9, height=H, width=W,
        chunk=chunk, integer_coords=True, t16=t16)]
    nbc = wire[0].shape[1]
    if case == "shuffled":
        for w in range(nw):
            perm = rng.permutation(nbc)
            for a in wire[:6]:
                a[w] = a[w][perm]
    elif case == "misaligned":
        r0 = (wire[5] & 0xFFFF) + rng.choice([0, 8, -8, 3], (nw, nbc))
        c0 = (wire[5] >> 16) + rng.choice([0, 64, -40], (nw, nbc))
        wire[5] = ((np.clip(r0, 0, None) & 0xFFFF)
                   | (np.clip(c0, 0, None) << 16)).astype(np.int32)
    elif case == "beyond clamp":
        h_pad, w_pad = k1.padded_grid_bilinear(H, W)
        r0 = rng.integers(h_pad - 20, h_pad + 40, (nw, nbc))
        c0 = rng.integers(w_pad - 150, w_pad + 300, (nw, nbc))
        wire[5] = ((r0 & 0xFFFF) | (c0 << 16)).astype(np.int32)
    elif case == "counts":
        wire[4][0, ::3] = 0
        wire[4][1, ::2] = chunk + 40  # above the chunk: every slot counts
    elif case == "time range":
        wire[6] = (wire[6] * 0.6).astype(np.float32)
        if not t16:
            wire[3][:, ::2] *= -1.0
    elif case == "padding chunks":
        wire = list(k1.pad_wire_chunks(tuple(wire), 300))
    elif case == "empty window":
        wire[4][1] = 0
    return tuple(wire), H, W


K4_EDGE_CASES = ("shuffled", "misaligned", "beyond clamp", "counts",
                 "time range", "padding chunks", "empty window", "ragged",
                 "odd width")


def k4_edge_phase(torch, k1, dev):
    """K4 against its plain version on the wires a tile owner must not
    assume away, both time wires and both polarity modes, each launched
    into a NaN-filled grid. Returns the largest error relative to
    max|plain|."""
    phase("K4 edge cases (tile owner): NaN-filled output, shuffled chunks, "
          "misaligned descriptors, descriptors beyond the clamp, zero and "
          "oversized counts, times beyond t_range and negative, padding "
          "chunks, an empty window, a ragged 37x150 frame, an odd width")
    rng = np.random.default_rng(12)
    worst = 0.0
    for case in K4_EDGE_CASES:
        for t16 in (False, True):
            wire, H, W = k4_edge_wire(rng, case, t16)
            args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in wire)
            for separate in (False, True):
                ref = k1.voxelize_chunked_bilinear_t_plain(
                    *args, num_bins=5, height=H, width=W,
                    separate_pol=separate)
                err, got = nan_prefilled(
                    torch, lambda g: k1.voxelize_chunked_bilinear_t_into(
                        g, *args, separate_pol=separate), ref)
                rel = err / ref.abs().max().item()
                empty_ok = case != "empty window" or not bool(got[1].any())
                print(f"  [{case}, {'v2 uint16' if t16 else 'v1 f32'} "
                      f"wire, {'separate' if separate else 'signed'}, "
                      f"{H}x{W}, {args[0].shape[1]} chunks] "
                      f"max|kernel-plain| {rel:.3e} of max "
                      f"{'OK' if rel <= K4_REL_TOL and empty_ok else 'FAIL'}")
                if not rel <= K4_REL_TOL or not empty_ok:
                    raise AssertionError(f"K4 edge case {case}: {rel}")
                worst = max(worst, rel)
    return worst


def k4_phase(torch, k1, dev, flush, host_batch):
    """K4 against its plain version at the shapes the DDD17 paths launch
    it: one window (serving) and the whole batch (NW = 160, the train
    step), signed and with separate polarities, each also launched into a
    NaN-filled grid, and on the edge cases. Returns the kernel row (the
    signed NW = 160 launch: what the linear-probe step does)."""
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire

    phase("K4 voxelize_chunked_bilinear_t vs plain (260x346, 32k ev/window)")
    d = upload_wire(host_batch, dev)
    full = tuple(d[k].reshape((-1,) + d[k].shape[2:]) for k in WIRE_KEYS)
    row, worst = {}, 0.0
    for nw in (1, full[0].shape[0]):
        args = tuple(a[:nw].contiguous() for a in full)
        events = int(args[4].sum())
        for separate in (False, True):
            kw = dict(num_bins=5, height=260, width=346,
                      separate_pol=separate)
            run_k = lambda: k1.voxelize_chunked_bilinear_t(*args, **kw)
            run_p = lambda: k1.voxelize_chunked_bilinear_t_plain(*args, **kw)
            got, ref = run_k(), run_p()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            nan_err, _ = nan_prefilled(
                torch, lambda g: k1.voxelize_chunked_bilinear_t_into(
                    g, *args, separate_pol=separate), ref)
            scale = ref.abs().max().item()
            total = got.sum().item()
            ok = max(err, nan_err) <= K4_REL_TOL * scale and scale > 0
            ms_k = cuda_ms(torch, run_k, flush, iters=10)
            ms_p = cuda_ms(torch, run_p, flush, iters=5, warmup=1)
            nbytes = (events * 7 + sum(a.numel() * a.element_size()
                                       for a in args[4:]) + got.numel() * 4)
            b_ms, b_by = bound(nbytes, events * 2 * 8, F32_OPS_PER_S)
            tag = f"NW={nw}, {'separate' if separate else 'signed'} polarity"
            print(f"K4 [{tag}] grid {tuple(got.shape)} max|kernel-plain| "
                  f"{err:.3e}, into a NaN-filled grid {nan_err:.3e} "
                  f"(max|plain| {scale:.3f}, bound {K4_REL_TOL:.0e} x max; "
                  f"grid sum {total:.1f}) {'OK' if ok else 'FAIL'}; "
                  f"kernel_ms {ms_k:.4f} plain_ms {ms_p:.4f} bound_ms "
                  f"{b_ms:.4f} ({b_by}; {events} events, "
                  f"{nbytes / 1e6:.1f} MB; kernel at {b_ms / ms_k:.0%} of "
                  "it)")
            if not ok:
                raise AssertionError(
                    f"K4 disagrees with its plain version [{tag}]: {err}, "
                    f"{nan_err}")
            worst = max(worst, err, nan_err)
            if nw > 1 and not separate:
                row.update(ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None)
            else:
                sfx = f"_nw{nw}" + ("_separate" if separate else "")
                row.update({f"ms{sfx}": ms_k, f"plain_ms{sfx}": ms_p,
                            f"bound_ms{sfx}": b_ms})
            del got, ref
    row["edge_cases_rel_err"] = k4_edge_phase(torch, k1, dev)
    return dict(
        name="K4 voxelize_chunked_bilinear_t (DDD17)", route="cuda",
        source="openess_tpu_torch/csrc/voxelize_chunked.cu",
        replaces="openess_tpu/ops/voxelize_chunked.py:353",
        max_abs_err=worst,
        check=f"ok: max|kernel-plain| <= {K4_REL_TOL:g} x max|plain|, NW = 1 "
              "and 160, signed and separate polarities, each also into a "
              "NaN-filled grid, and on the edge cases; ms is signed at "
              "NW = 160", **row,
    )


def downstream_phase(torch, dev, smi, title, settings, host_batch, expect,
                     trains, zero_counts, read_counts, loaded=None,
                     stats=None):
    """A downstream stage at full width through ``Trainer``: a warm-up
    step, an epoch of ``DOWNSTREAM_STEPS`` steps on one batch through
    ``train_epoch`` (launch counts per step held to ``expect``), timed
    steps, and a profile. ``trains(key)`` says which state-dict entries must
    change; every other one must stay bit for bit. ``loaded`` maps entries
    to the values they must hold before the first step (a checkpoint's).
    ``stats``, when given, receives the step's p50 and p95, the device's
    busy ms per step and the cuDNN weight-gradient kernels' ms per step.
    Returns the epoch's launch counts."""
    from openess_tpu_torch.training.trainer import Trainer, to_device

    phase(title)
    B = host_batch["label"].shape[0]
    s = dataclasses.replace(settings, batch_size_b=B, save_checkpoint=False)
    if B != settings.batch_size_b:
        print(f"B = {settings.batch_size_b} did not fit the card's memory: "
              f"running at B = {B}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = OneBatchDataset(host_batch, DOWNSTREAM_STEPS)
    trainer = Trainer(s, data, data, seed=0, device=dev)
    sb, mset = trainer.sb, trainer.mset
    state0 = {f"{n}.{k}": v.clone() for n, sd in mset.state_dict().items()
              for k, v in sd.items()}
    n_train = sum(p.numel() for m in mset.modules.values()
                  for p in m.parameters() if p.requires_grad)
    print(f"task {mset.task}, {s.dataset_name_b} at "
          f"{tuple(s.img_size_b)}, B={B}, T={s.nr_events_data_b}, "
          f"{s.nr_events_window_b} events per window, "
          f"{s.semseg_num_classes} classes, {s.compute_dtype}, K3 gates "
          f"{'on' if s.e2vid_fused_gates else 'off'}, lr_voxel {s.lr_voxel}, "
          f"augmentation {'on' if s.data_augmentation_train else 'off'}; "
          f"{n_train} trainable parameters in "
          f"{sum(trains(k) for k in state0)} tensors")
    if loaded is not None:
        same = all(torch.equal(state0[k], v.to(state0[k].dtype).to(dev))
                   for k, v in loaded.items())
        print(f"  {len(loaded)} tensors loaded from the pretrain checkpoint: "
              f"{'equal to the file' if same else 'DIFFER from the file'}")
        if not same or not loaded:
            raise AssertionError("the pretrain checkpoint was not loaded")

    batch = to_device(host_batch, dev)
    # the loss on the batch as it is (eval mode, no augmentation), before
    # and after the steps: the train steps' own losses are taken on randomly
    # flipped copies and move by more than a small learning rate does
    eval0 = float(sb.eval_step(batch)[1])
    t0 = time.perf_counter()
    try:
        first = {k: float(v) for k, v in sb.train_step(batch, 0).items()}
    except torch.cuda.OutOfMemoryError:
        # the one allowed retreat: the width stays, the batch halves
        if B == 1:
            raise
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"out of memory at B = {B} (peak {peak:.2f} GiB); halving B")
        del trainer, sb, mset, batch, state0
        torch.cuda.empty_cache()
        half = {k: v[:B // 2] for k, v in host_batch.items()}
        return downstream_phase(torch, dev, smi, title, settings, half,
                                expect, trains, zero_counts, read_counts,
                                loaded, stats)
    torch.cuda.synchronize()
    print(f"step 0 (warm-up, {time.perf_counter() - t0:.2f} s): {first}")

    n = DOWNSTREAM_STEPS
    zero_counts()
    t0 = time.perf_counter()
    avg_losses = trainer.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"Trainer.train_epoch: {n} steps in {epoch_s:.2f} s "
          f"({epoch_s * 1e3 / n:.1f} ms per step, host clock, batch upload "
          f"included); epoch-average losses {avg_losses}; launches "
          + " ".join(f"{k} {v}" for k, v in counts.items()))

    hist, events = [], []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses = sb.train_step(batch, 0)
        b.record()
        hist.append(losses)
        events.append((a, b))
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in events])
    hist = [first] + [{k: float(v) for k, v in h.items()} for h in hist]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train step p50 {np.percentile(ms, 50):.1f} ms p95 "
          f"{np.percentile(ms, 95):.1f} ms over {len(ms)} steps (CUDA "
          f"events, batch resident); peak memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) at B={B}; on {smi}")
    print("semseg_loss: step 0 " + f"{hist[0]['semseg_loss']:.4f}, epoch "
          f"average {avg_losses['semseg_loss']:.4f}, timed steps "
          + " ".join(f"{h['semseg_loss']:.4f}" for h in hist[1:]))
    pred, loss = sb.eval_step(batch)
    eval1 = float(loss)
    print(f"eval_step loss on the same batch: {eval0:.4f} before the "
          f"{sb.step} steps, {eval1:.4f} after")
    state1 = {f"{n_}.{k}": v for n_, sd in mset.state_dict().items()
              for k, v in sd.items()}
    moved = {k for k in state0 if not torch.equal(state0[k], state1[k])}
    want = {k for k in state0 if trains(k)}
    checks = {
        "every loss finite": all(np.isfinite(v) for h in hist
                                 for v in h.values())
        and all(np.isfinite(v) for v in avg_losses.values()),
        "loss keys": set(first) == {"semseg_loss", "total_loss"},
        "eval loss fell": eval1 < eval0,
        f"the {len(want)} trainable tensors moved": want <= moved,
        "everything else unchanged": moved <= want,
        "optimizer steps": sb.step == 1 + 2 * n,
    }
    for k, per_step in expect.items():
        checks[f"{k} {per_step} per step"] = counts[k] == per_step * n
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{title}: checks failed: {checks}")

    H, W = (int(v) for v in s.img_size_b)
    ok = (tuple(pred.shape) == (B, H, W) and bool(torch.isfinite(loss))
          and 0 <= int(pred.min()) and int(pred.max()) < s.semseg_num_classes)
    print(f"eval_step: pred {tuple(pred.shape)}, loss {float(loss):.4f} "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{title}: eval step failed")

    print("trace: device busy time and idle share")
    n = 2
    avg, wall, spans = device_profile(
        torch, lambda: [sb.train_step(batch, 0) for _ in range(n)])
    print_profile(avg, wall, n, "step", smi)
    print_spans(avg, spans, n)
    if stats is not None:
        stats.update(
            p50=float(np.percentile(ms, 50)), p95=float(np.percentile(ms, 95)),
            busy=sum(e.self_device_time_total for e in avg) / 1e3 / n,
            wgrad=sorted(((e.key, e.self_device_time_total / 1e3 / n,
                           e.count // n) for e in avg if "wgrad" in e.key),
                         key=lambda r: -r[1]))
    return counts


def finetune_reference_phase(torch, dev):
    """One f32 fine-tune step with ``unfrozen_e2vid`` at 64x96, B = 2,
    T = 3 on CUDA (K1, K3 forward and backward) against the same step on
    the CPU (plain versions, autograd through the plain gates)."""
    from openess_tpu_torch.data.synthetic import SyntheticESS
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder
    from openess_tpu_torch.training.trainer import to_device

    phase("fine-tune reference: f32 step on CUDA (K1, K3, K3 backward) vs "
          "on the CPU (plain), 64x96, B=2, T=3")
    s = finetune_settings(
        dataset_name_b="synthetic_events", img_size_b=(64, 96),
        semseg_num_classes=6, nr_events_data_b=3, batch_size_b=2,
        compute_dtype="float32", e2vid_fused_gates=True,
        load_pretrained_weights=False, data_augmentation_train=False)
    ds = SyntheticESS(num_samples=2, height=64, width=96, num_classes=6,
                      num_windows=3)
    host_batch = ds.raw_wire_batch([0, 1])
    out = {}
    for d in (dev, torch.device("cpu")):
        mset = build_models(s, seed=0, device=d)
        sb = StepBuilder(s, mset, make_optimizer(s, mset), 1)
        sb._set_mode(True)
        total, losses = sb.compute_losses(
            sb._with_windows(to_device(host_batch, d)), 0)
        total.backward()
        out[d.type] = (
            float(losses["semseg_loss"].detach()),
            {f"{n}.{k}": p.grad.detach().cpu()
             for n, m in mset.modules.items()
             for k, p in m.named_parameters()})
        del mset, sb, total, losses
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    e2vid = plain = 0.0
    for k in gc:
        scale = gc[k].abs().max().item()
        rel = (gg[k] - gc[k]).abs().max().item() / max(scale, 1e-30)
        if k.startswith("front_sensor_b."):
            if scale <= 0:
                raise AssertionError(f"no gradient reached {k}")
            e2vid = max(e2vid, rel)
        elif k.startswith("back_end.decoder_ch"):
            plain = max(plain, rel)
    ok = (loss_rel <= TRAIN_LOSS_REL_TOL and plain <= TRAIN_GRAD_REL_TOL
          and e2vid <= TRAIN_INORM_GRAD_REL_TOL)
    print(f"max rel |cuda-cpu|: semseg_loss {loss_rel:.3e} (bound "
          f"{TRAIN_LOSS_REL_TOL:.0e}); gradients of decoder_ch256/512 "
          f"{plain:.3e} of each tensor's max (bound "
          f"{TRAIN_GRAD_REL_TOL:.0e}); of E2VID's 14 tensors, all non-zero, "
          f"{e2vid:.3e} (bound {TRAIN_INORM_GRAD_REL_TOL:.0e}: they pass "
          f"the head's instance norms) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CUDA fine-tune step disagrees with the "
                             "CPU one")


def serving_row(host, name, r, smi, budget_ms=50.0):
    """Print and keep a served stream's latency: p50 and p95 per window
    and its pack, upload and device medians, against the 20 Hz budget."""
    lat = r.latency_ms
    p50, p95 = (float(np.percentile(lat, q)) for q in (50, 95))
    pack = float(np.median(r.pack_ms))
    print(f"  p50 {p50:.2f} ms p95 {p95:.2f} ms per window "
          f"({'within' if p95 <= budget_ms else 'over'} the {budget_ms:.0f} "
          f"ms budget at p95): pack {pack:.2f} (C++ packer, 1 thread) "
          f"upload {np.median(r.upload_ms):.2f} device "
          f"{np.median(r.device_ms):.2f} (p95 "
          f"{np.percentile(r.device_ms, 95):.2f}) ms; host cores "
          f"{os.cpu_count()}; on {smi}")
    host_row(host, name=f"serving {name}", windows=r.windows, p50_ms=p50,
             p95_ms=p95, pack_ms=pack,
             upload_ms=float(np.median(r.upload_ms)),
             device_ms=float(np.median(r.device_ms)), budget_ms=budget_ms)


def ddd17_serving_phase(torch, dev, smi, zero_counts, read_counts, host):
    """The streaming server on the DDD17 settings, S = 1, K3 gates: K4
    once and K3 three times per window."""
    from openess_tpu_torch.models.e2vid import initial_stream_state
    from openess_tpu_torch.serve_stream import (
        StreamServer,
        report,
        serve,
        synthetic_windows,
    )

    phase("serving DDD17: openess_tpu_torch.serve_stream at full width, "
          "bf16, S=1")
    s = ddd17_probe_settings(e2vid_fused_gates=True)
    server = StreamServer(s, streams=1, device=dev)
    n = 10
    zero_counts()
    r = serve(server, synthetic_windows(n, s.nr_events_window_b,
                                        server.sensor_h, server.sensor_w))
    torch.cuda.synchronize()
    got = read_counts()
    for line in report(r, 20.0, dev):
        print("  " + line)
    serving_row(host, "S1 DDD17, K3 gates", r, smi)
    print("  launches " + " ".join(f"{k} {v}" for k, v in got.items()))
    want = initial_stream_state(1, 200, 352, dtype=torch.bfloat16, device=dev)
    checks = {
        "sensor 260x346, integer pixels": (server.sensor_h, server.sensor_w)
        == (260, 346) and server.integer_coords,
        "logits finite": bool(torch.isfinite(r.logits).all()),
        "logits shape": tuple(r.logits.shape) == (1, 200, 352, 6),
        "labels uint8 [1,200,352]": r.labels.dtype == np.uint8
        and r.labels.shape == (1, 200, 352),
        "labels in [0, 6)": int(r.labels.max()) < 6,
        "carried state shapes": len(r.carry) == len(want) and all(
            a.shape == b.shape and a.dtype == b.dtype
            for pa, pb in zip(r.carry, want) for a, b in zip(pa, pb)),
        "K4 once per window": got["K4"] == n,
        "K3 three per window": got["K3"] == 3 * n,
        "no other kernel": got["K1"] == got["K2"] == got["K3_bwd"]
        == got["K5"] == got["K6"] == 0,
    }
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"DDD17 serving checks failed: {checks}")
    return got


def dsec_windows(s, batch=8, seed=2):
    """The padded windows of one synthetic DSEC batch on the host, as
    ``DSECSequence.load_events`` returns them: per sample T windows of K
    events, rectified fractional coordinates (a few in (-1, 0)), polarity
    {0, 1}, float64 integer-microsecond times a minute into a recording,
    sorted, all valid."""
    rng = np.random.default_rng(seed)
    T, K = s.nr_events_data_b, s.nr_events_window_b
    windows = []
    for b in range(batch):
        t = 6e7 + b * 1e6 + np.sort(rng.integers(0, 10 ** 6, T * K))
        windows.append((
            rng.uniform(-1, 640, (T, K)).astype(np.float32),
            rng.uniform(-1, 480, (T, K)).astype(np.float32),
            rng.integers(0, 2, (T, K)).astype(np.float32),
            t.astype(np.float64).reshape(T, K), np.ones((T, K), bool)))
    return windows


def grid_edge_cases(torch, dev, run, plain, height, width, integer):
    """A kernel of the grid wire and its plain version on three windows of
    1000 slots: window 0 holds padding only (exact zeros), window 1 a single
    event (its weights sum to 1), window 2 events reaching past the frame,
    fractional negative coordinates (K5) or integer pixels outside the frame
    (K6), in a frame of ``height x width``. Returns the largest error
    relative to max|plain|."""
    rng = np.random.default_rng(5)
    nw, k, H, W = 3, 1000, height, width
    if integer:
        x = rng.integers(-3, W + 3, (nw, k)).astype(np.float32)
        y = rng.integers(-3, H + 3, (nw, k)).astype(np.float32)
    else:
        x = rng.uniform(-0.9, W, (nw, k)).astype(np.float32)
        y = rng.uniform(-0.9, H, (nw, k)).astype(np.float32)
        x[2, :300] = rng.uniform(-0.9, -0.1, 300)
        y[2, 300:600] = rng.uniform(-0.9, -0.1, 300)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = 6e7 + np.sort(rng.integers(0, 5 * 10 ** 4, (nw, k)), axis=1)
    valid = np.ones((nw, k), bool)
    valid[:2] = False
    valid[1, 7] = True
    x[1, 7], y[1, 7] = W // 2 + (0 if integer else 0.25), H // 2
    ev = tuple(torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(dev)
               for a in (x, y, p, t.astype(np.float32), valid))
    got, ref = run(ev, nw), plain(ev, nw)
    torch.cuda.synchronize()
    per = got.shape[0] // nw
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    checks = {
        "within the bound": err <= K56_REL_TOL,
        "padding window exactly zero": not bool(got[:per].any()),
        "single event weighs 1": abs(abs(got[per:2 * per].sum().item())
                                     - 1.0) <= 1e-6,
        "edge window reaches column 0": bool(got[2 * per:, :, 0].any()),
    }
    print(f"  edge cases at {H}x{W} (padding window, one event, "
          f"{'pixels outside the frame' if integer else 'fractional negative coordinates'}"
          f"): max|kernel-plain| {err:.3e} of max; " + ", ".join(
              f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"edge cases failed: {checks}")
    return err


def normalize_ms(torch, grid, flush):
    """Device milliseconds of ``normalize_event``'s unbiased normalization
    of a K5 batch ``[NW, 5, 480, 640]``, as the DSEC loader runs it (one
    call over the windows) and as a loop of one call per window."""
    from openess_tpu_torch.ops.voxelize import normalize_nonzero

    one = cuda_ms(torch, lambda: normalize_nonzero(
        grid, unbiased=True, dims=(1, 2, 3)), flush, iters=5, warmup=1)
    loop = cuda_ms(torch, lambda: torch.stack(
        [normalize_nonzero(w, unbiased=True) for w in grid]), flush,
        iters=3, warmup=1)
    print(f"normalize_event on the K5 batch {tuple(grid.shape)}: one call "
          f"{one:.4f} ms, a call per window {loop:.4f} ms (the shipped "
          "configs set normalize_event: false, so the main path skips it)")
    return one, loop


def sorted_within_slots(torch, k56, counts, offsets, binned):
    """K5's or K6's binned events of every run, ordered by slot, then by
    (x, y, tn, v): the card fills each run in any order, so two binnings
    agree when these agree."""
    rows, slot = k56.binned_rows(counts, offsets)
    b = binned[rows]
    order = torch.arange(rows.numel(), device=b.device)
    for col in (3, 2, 1, 0):
        order = order[torch.sort(b[order, col], stable=True).indices]
    order = order[torch.sort(slot[order], stable=True).indices]
    return b[order]


def k5_phase(torch, k56, dev, flush, windows):
    """K5 against its plain version on one DSEC grid-wire batch (NW = 160
    windows of 100 000 events at 480x640, the times cast to f32 on the host
    as the loader casts them) and on the edge cases; its binning passes
    against theirs (counts exactly, each slot's events as a multiset); its
    splat into a NaN-filled grid. Times the wrapper (raw events to the
    grid), the binning and the splat apart, and each pass by the profiler.
    Returns the row."""
    from openess_tpu_torch.ops.tile_splat import tile_plan
    from openess_tpu_torch.ops.voxelize import voxelize_windows_trilinear

    phase("K5 voxelize_windows_trilinear_mxu vs plain (NW = 160, 100k "
          "ev/window, 480x640)")
    nw = len(windows) * windows[0][0].shape[0]
    stacked = [np.stack([w[i] for w in windows]) for i in range(5)]
    stacked[3] = stacked[3].astype(np.float32)  # where the loader casts
    ev = [torch.from_numpy(a.reshape(-1)).to(dev) for a in stacked]
    del stacked
    kw = dict(num_bins=5, height=480, width=640)
    plan = tile_plan(5, 480, 640)
    run_k = lambda: k56.voxelize_windows_trilinear_mxu(*ev, num_windows=nw,
                                                        **kw)
    run_p = lambda: voxelize_windows_trilinear(*ev, num_windows=nw, **kw)
    run_b = lambda: k56.bin_events_trilinear(*ev, num_windows=nw, **kw)
    got, ref = run_k(), run_p()
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    del got
    counts, offsets, binned = run_b()
    nan_err, _ = nan_prefilled(torch, lambda g: k56.splat_binned_trilinear(
        counts, offsets, binned, g, num_windows=nw, plan=plan), ref)
    ok = max(err, nan_err) <= K56_REL_TOL * scale
    del ref
    pc, po, pb = k56.bin_events_trilinear_plain(*ev, num_windows=nw,
                                                plan=plan)
    kept = int(pc.sum())
    bin_checks = {
        "counts equal": bool(torch.equal(counts, pc)),
        "offsets equal": bool(torch.equal(offsets, po)),
        "each slot's events equal as a multiset": bool(torch.equal(
            sorted_within_slots(torch, k56, counts, offsets, binned),
            sorted_within_slots(torch, k56, pc, po, pb))),
    }
    del pc, po, pb
    print(f"K5 binning vs plain ({kept} of {ev[0].numel()} events kept, "
          f"{plan.slots(nw)} slots of {plan.tiles} {plan.rows}x{plan.cols} "
          "tiles x 4 categories a window): " + ", ".join(
              f"{k} {'ok' if v else 'FAIL'}" for k, v in bin_checks.items()))
    got = run_k()
    ms_n, ms_n_loop = normalize_ms(torch, got.view(nw, 5, 480, 640), flush)
    del got
    ms_w = cuda_ms(torch, run_k, flush, iters=10)
    ms_bin = cuda_ms(torch, run_b, flush, iters=10)
    grid = torch.empty((nw * 5, 480, 640), device=dev)
    ms_splat = cuda_ms(torch, lambda: k56.splat_binned_trilinear(
        counts, offsets, binned, grid, num_windows=nw, plan=plan), flush,
        iters=10)
    del grid
    # each pass's mean device time a launch (a call is the passes and the
    # scratch's zero fill)
    passes = pass_times(torch, run_k)
    ms_p = cuda_ms(torch, run_p, flush, iters=3, warmup=1)
    events = int(ev[4].sum())
    # the wrapper must read x, y, p, t and the bool valid (17 B a slot) and
    # write the grid; the splat alone reads its 16 B a kept event
    grid_bytes = nw * 5 * 480 * 640 * 4
    b_ms, b_by = bound(ev[0].numel() * 17 + grid_bytes, events * 8 * 6,
                       F32_OPS_PER_S)
    b_ms_splat, _ = bound(kept * 16 + grid_bytes, kept * 8 * 6,
                          F32_OPS_PER_S)
    # what binning moves beyond the bound: the scatter's second read of
    # the raw events, the binned events written and read again
    extra_ms = (ev[0].numel() * 17 + kept * 32) / HBM_BYTES_PER_S * 1e3
    print(f"K5 [NW={nw}] max|kernel-plain| {err:.3e}, the splat into a "
          f"NaN-filled grid {nan_err:.3e} (max|plain| {scale:.3f}, bound "
          f"{K56_REL_TOL:.0e} x max) {'OK' if ok else 'FAIL'}; the wrapper "
          f"(raw events to the grid) {ms_w:.4f} ms against bound_ms "
          f"{b_ms:.4f} ({b_by}; {events} valid events, 17 B a slot and the "
          f"grid); binning {ms_bin:.4f}, splat {ms_splat:.4f} against "
          f"{b_ms_splat:.4f}; binning's bytes beyond the bound {extra_ms:.4f}"
          f" ms ({extra_ms / b_ms:.0%} of it); passes (profiler, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
          + f"; plain_ms {ms_p:.4f}")
    if not ok or not all(bin_checks.values()):
        raise AssertionError(f"K5 disagrees with its plain version: {err}, "
                             f"{nan_err}, {bin_checks}")
    del ev, counts, offsets, binned
    # the main frame, and an odd width (the splat's 4-byte stores)
    edge = max(grid_edge_cases(
        torch, dev,
        lambda e, n: k56.voxelize_windows_trilinear_mxu(
            *e, num_windows=n, num_bins=5, height=h, width=w),
        lambda e, n: voxelize_windows_trilinear(
            *e, num_windows=n, num_bins=5, height=h, width=w),
        h, w, integer=False) for h, w in ((480, 640), (37, 151)))
    return dict(
        name="K5 voxelize_windows_trilinear_mxu (DSEC grid wire)",
        route="cuda", source="openess_tpu_torch/csrc/voxelize_grid.cu",
        replaces="openess_tpu/ops/voxelize_mxu.py:54",
        max_abs_err=max(err, nan_err), ms=ms_w, plain_ms=ms_p, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, ms_wrapper=ms_w,
        bound_ms_wrapper=b_ms, ms_binning=ms_bin,
        ms_splat=ms_splat, bound_ms_splat=b_ms_splat,
        binning_extra_bytes_ms=extra_ms, pass_ms=passes,
        normalize_ms=ms_n, normalize_ms_per_window_loop=ms_n_loop,
        edge_cases_rel_err=edge,
        check=f"ok: max|kernel-plain| <= {K56_REL_TOL:g} x max|plain| at "
              "NW = 160 (the splat also into a NaN-filled grid) and on the "
              "edge cases; the binning's counts and offsets equal the plain "
              "version's, each slot's events as a multiset; ms is the "
              "wrapper, raw events to the grid (17 B a slot and the grid in "
              "bound_ms), ms_splat the splat pass on binned events",
    )


def ddd17_events(rng, nw, k, spill=3):
    """Integer-pixel DDD17 events, ``spill`` pixels past each edge of the
    260x346 frame, times relative to each window's first event."""
    return (rng.integers(-spill, 346 + spill, (nw, k)).astype(np.float32),
            rng.integers(-spill, 260 + spill, (nw, k)).astype(np.float32),
            rng.integers(0, 2, (nw, k)).astype(np.float32),
            np.sort(rng.integers(0, 5 * 10 ** 4, (nw, k)),
                    axis=1).astype(np.float32),
            np.ones((nw, k), bool))


def pass_times(torch, run, n=5):
    """Each kernel's mean device milliseconds a launch over ``n`` calls of
    ``run`` (the profiler), by the kernel's short name."""
    avg, _, _ = device_profile(torch, lambda: [run() for _ in range(n)])
    return {e.key.replace("(anonymous namespace)::", "").replace(
        "void ", "").split("(")[0].split("<")[0].split("::")[-1]:
            e.self_device_time_total / e.count / 1e3 for e in avg}


def k6_phase(torch, k56, dev, flush):
    """K6 against its plain version at one DDD17 grid-wire batch's shape
    (NW = 160 windows of 32 000 integer-pixel events at 260x346, some
    outside the frame), signed and with separate polarities, and on the
    edge cases; its binning passes against theirs (counts and offsets
    exactly, each tile's events as a multiset); its splat into a
    NaN-filled grid. Times the wrapper (raw events to the grid), the
    binning and the splat apart, and each pass by the profiler. Returns the
    row (signed: what the linear probe launches)."""
    from openess_tpu_torch.ops.voxelize import voxel_grid_bilinear_t

    phase("K6 voxelize_windows_bilinear_t_mxu vs plain (NW = 160, 32k "
          "ev/window, 260x346)")
    nw, k = 160, 32000
    ev = [torch.from_numpy(a.reshape(-1)).to(dev)
          for a in ddd17_events(np.random.default_rng(6), nw, k)]
    row, worst = {}, 0.0
    for separate in (False, True):
        kw = dict(num_bins=5, height=260, width=346, separate_pol=separate)
        cout = 10 if separate else 5
        plan = k56.bilinear_t_plan(5, 260, 346, separate)
        run_k = lambda: k56.voxelize_windows_bilinear_t_mxu(
            *ev, num_windows=nw, **kw)
        run_p = lambda: voxel_grid_bilinear_t(
            *(a.view(nw, k) for a in ev), **kw).view(nw * cout, 260, 346)
        run_b = lambda: k56.bin_events_bilinear_t(*ev, num_windows=nw, **kw)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        del got
        counts, offsets, binned = run_b()
        splat_kw = dict(num_windows=nw, num_bins=5, separate_pol=separate,
                        plan=plan)
        nan_err, _ = nan_prefilled(
            torch, lambda g: k56.splat_binned_bilinear_t(
                counts, offsets, binned, g, **splat_kw), ref)
        ok = max(err, nan_err) <= K56_REL_TOL * scale and scale > 0
        del ref
        pc, po, pb = k56.bin_events_bilinear_t_plain(
            *ev, num_windows=nw, num_bins=5, plan=plan)
        kept = int(pc.sum())
        bin_checks = {
            "counts equal": bool(torch.equal(counts, pc)),
            "offsets equal": bool(torch.equal(offsets, po)),
            "each tile's events equal as a multiset": bool(torch.equal(
                sorted_within_slots(torch, k56, counts, offsets, binned),
                sorted_within_slots(torch, k56, pc, po, pb))),
        }
        del pc, po, pb
        ms_w = cuda_ms(torch, run_k, flush, iters=10)
        ms_bin = cuda_ms(torch, run_b, flush, iters=10)
        grid = torch.empty((nw * cout, 260, 346), device=dev)
        ms_splat = cuda_ms(torch, lambda: k56.splat_binned_bilinear_t(
            counts, offsets, binned, grid, **splat_kw), flush, iters=10)
        del grid
        passes = pass_times(torch, run_k)
        ms_p = cuda_ms(torch, run_p, flush, iters=3, warmup=1)
        events = int((ev[4] & (ev[0] >= 0) & (ev[0] < 346) & (ev[1] >= 0)
                      & (ev[1] < 260)).sum())
        grid_bytes = nw * cout * 260 * 346 * 4
        # the wrapper must read x, y, p, t and the bool valid (17 B a slot)
        # and write the grid; the splat alone reads its 16 B a kept event
        b_ms, b_by = bound(ev[0].numel() * 17 + grid_bytes, events * 2 * 8,
                           F32_OPS_PER_S)
        b_ms_splat, _ = bound(kept * 16 + grid_bytes, kept * 2 * 8,
                              F32_OPS_PER_S)
        extra_ms = (ev[0].numel() * 17 + kept * 32) / HBM_BYTES_PER_S * 1e3
        tag = "separate" if separate else "signed"
        print(f"K6 binning vs plain [{tag}] ({kept} of {ev[0].numel()} "
              f"events kept, {plan.slots(nw)} slots of {plan.tiles} "
              f"{plan.rows}x{plan.cols} tiles a window): " + ", ".join(
                  f"{k_} {'ok' if v else 'FAIL'}"
                  for k_, v in bin_checks.items()))
        print(f"K6 [NW={nw}, {tag} polarity] max|kernel-plain| {err:.3e}, "
              f"the splat into a NaN-filled grid {nan_err:.3e} (max|plain| "
              f"{scale:.3f}, bound {K56_REL_TOL:.0e} x max) "
              f"{'OK' if ok else 'FAIL'}; the wrapper (raw events to the "
              f"grid) {ms_w:.4f} ms against bound_ms {b_ms:.4f} ({b_by}; "
              f"{events} events in the frame, 17 B a slot and the grid; "
              f"{b_ms / ms_w:.0%} of it); binning {ms_bin:.4f}, splat "
              f"{ms_splat:.4f} against {b_ms_splat:.4f}; binning's bytes "
              f"beyond the bound {extra_ms:.4f} ms; passes (profiler, ms): "
              + ", ".join(f"{k_} {v:.4f}" for k_, v in passes.items())
              + f"; plain_ms {ms_p:.4f}")
        if not ok or not all(bin_checks.values()):
            raise AssertionError(
                f"K6 disagrees with its plain version [{tag}]: {err}, "
                f"{nan_err}, {bin_checks}")
        worst = max(worst, err, nan_err)
        del counts, offsets, binned
        sfx = "_separate" if separate else ""
        if not separate:
            row.update(ms=ms_w, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
        row.update({f"ms_wrapper{sfx}": ms_w, f"bound_ms_wrapper{sfx}": b_ms,
                    f"ms_binning{sfx}": ms_bin, f"ms_splat{sfx}": ms_splat,
                    f"bound_ms_splat{sfx}": b_ms_splat,
                    f"binning_extra_bytes_ms{sfx}": extra_ms,
                    f"pass_ms{sfx}": passes})
        if separate:
            row.update(ms_separate=ms_w, plain_ms_separate=ms_p,
                       bound_ms_separate=b_ms)
        edge = max(grid_edge_cases(
            torch, dev,
            lambda e, n: k56.voxelize_windows_bilinear_t_mxu(
                *e, num_windows=n, **dict(kw, height=h, width=w)),
            lambda e, n: voxel_grid_bilinear_t(
                *(a.view(n, -1) for a in e), **dict(kw, height=h, width=w),
            ).reshape(n * cout, h, w),
            h, w, integer=True) for h, w in ((260, 346), (37, 151)))
        row[f"edge_cases_rel_err_{tag}"] = edge
    return dict(
        name="K6 voxelize_windows_bilinear_t_mxu (DDD17 grid wire)",
        route="cuda", source="openess_tpu_torch/csrc/voxelize_grid.cu",
        replaces="openess_tpu/ops/voxelize_mxu.py:169", max_abs_err=worst,
        check=f"ok: max|kernel-plain| <= {K56_REL_TOL:g} x max|plain|, "
              "NW = 160 signed and separate (the splat also into a "
              "NaN-filled grid), and the edge cases; the binning's counts "
              "and offsets equal the plain version's, each tile's events as "
              "a multiset; ms is the signed wrapper, raw events to the grid "
              "(17 B a slot and the grid in bound_ms), ms_splat the splat "
              "pass on binned events", **row,
    )


class GridWireDataset:
    """One DSEC batch's side channels and padded windows, made once on the
    host; ``get_batch`` turns the windows into the batch's event keys
    through ``data/dsec.event_batch`` (K5 on the card, or the host C++) as
    ``DSECDataset.get_batch`` does after reading them, and keeps each
    call's host milliseconds (K5 is queued, not waited for)."""

    def __init__(self, s, side, windows, steps, dev):
        from openess_tpu_torch.data.dsec import event_batch

        self.s, self.side, self.windows, self.dev = s, side, windows, dev
        self.event_batch = event_batch
        self.n = steps * len(windows)
        self.ms = []

    def __len__(self):
        return self.n

    def get_batch(self, idx):
        t0 = time.perf_counter()
        batch = dict(self.side)
        batch.update(self.event_batch(self.s, self.windows, self.dev))
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return batch


def timed_epoch(torch, trainer, get_ms):
    """``Trainer.train_epoch`` with the host clock around it and at each
    step's start; ``get_ms`` (the dataset's per-call list) is cleared
    first. Returns ``(losses, wall ms, ms between step starts after the
    first, steps)``."""
    starts, step = [], trainer.sb.train_step

    def stamped(batch, epoch):
        starts.append(time.perf_counter())
        return step(batch, epoch)

    trainer.sb.train_step = stamped
    get_ms.clear()
    t0 = time.perf_counter()
    avg = trainer.train_epoch()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    trainer.sb.train_step = step
    n = len(starts)
    steady = (starts[-1] - starts[0]) * 1e3 / max(n - 1, 1)
    return avg, wall, steady, n


def loader_and_step_ms(torch, dev, get_batch, sb, batch, reps=3):
    """In line and synchronized: ``get_batch`` (host work and any kernel it
    queues), the upload (``to_device``, pinned, non-blocking), and the
    train step on a resident ``batch`` by CUDA events; medians of
    ``reps``."""
    from openess_tpu_torch.training.trainer import to_device

    get, up, steps = [], [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        hb = get_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        to_device(hb, dev)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t1) * 1e3)
        get.append((t1 - t0) * 1e3)
        del hb
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        sb.train_step(batch, 0)
        b.record()
        b.synchronize()
        steps.append(a.elapsed_time(b))
    return (float(np.median(get)), float(np.median(up)),
            float(np.median(steps)))


def report_loader(cell, how, workers, wall, steady, n, get_ms, loader,
                  smi, host):
    """Print and keep the loader's numbers of one grid-wire run: ms per
    step through ``train_epoch`` (wall / steps, and between step starts
    after the first, which leaves out the first batch's assembly), the
    share of that wall time spent in ``get_batch`` (above 1 when workers
    assemble side by side), and the share of the in-line loader time
    (``get_batch`` and upload, synchronized) hidden behind the step:
    ``(step + loader - steady) / loader``."""
    get, up, step = loader
    total = get + up
    hidden = (step + total - steady) / total
    share = sum(get_ms) / wall
    print(f"[{cell}, event by {how}, num_cpu_workers {workers}] "
          f"Trainer.train_epoch: {n} steps in {wall:.0f} ms ({wall / n:.1f} "
          f"ms per step; {steady:.1f} between step starts after the "
          f"first); get_batch {np.median(get_ms):.1f} ms a call in the "
          f"workers = {share:.3f} of the epoch; in line: get_batch {get:.1f}"
          f" ms + upload {up:.1f} ms (synchronized), step {step:.1f} ms "
          f"(CUDA events, batch resident); share of the loader hidden "
          f"behind the step {hidden:.3f}; host cores {os.cpu_count()}; on "
          f"{smi}")
    return host_row(host, name=f"{cell} loader", event=how, workers=workers,
                    epoch_ms_per_step=wall / n, steady_ms_per_step=steady,
                    get_batch_ms=float(np.median(get_ms)),
                    get_batch_share=share, inline_get_batch_ms=get,
                    inline_upload_ms=up, step_ms=step,
                    loader_hidden_share=hidden)


def prefetch_vs_inline(torch, trainer, data):
    """The batches of one training epoch as ``Trainer`` delivers them (its
    ``PrefetchLoader``, on the plan of a copy of its shuffle generator)
    against the same indices assembled in line (``to_device(get_batch)``):
    ``(every key of every batch equal, max |difference| of ``event`` over
    max |in-line event|, the same between two in-line assemblies of the
    first batch, (eval loss gap, the in-line batch's own run-to-run loss
    spread, predictions equal, in-line predictions equal twice))``, the
    eval step run on the first batch each way."""
    import copy

    from openess_tpu_torch.data.pipeline import batch_indices
    from openess_tpu_torch.training.trainer import to_device

    plan = batch_indices(len(data), trainer.s.batch_size_b, shuffle=True,
                         rng=copy.deepcopy(trainer.np_rng), drop_last=True,
                         pad_last=False)
    equal, gap, first = True, 0.0, None
    for (idx, _), batch in zip(plan, trainer._batches(data, True)):
        inline = to_device(data.get_batch(idx), trainer.device)
        equal &= sorted(batch) == sorted(inline) and all(
            torch.equal(batch[k], inline[k]) for k in inline)
        ref = inline["event"].float()
        gap = max(gap, ((batch["event"].float() - ref).abs().max()
                        / ref.abs().max()).item())
        if first is None:
            first, plan_first = (batch, inline), idx
    again = to_device(data.get_batch(plan_first), trainer.device)["event"]
    ref = first[1]["event"].float()
    own = ((again.float() - ref).abs().max() / ref.abs().max()).item()
    sb = trainer.sb
    sb._set_mode(False)
    with torch.no_grad():
        (pa, la), (pb, lb), (pc, lc) = (
            sb.eval_step(b) for b in (first[1], first[1], first[0]))
    return equal, gap, own, ((lc - la).abs().item(), (lb - la).abs().item(),
                             torch.equal(pa, pc), torch.equal(pa, pb))


def check_prefetch(torch, trainer, data, how, workers, row, checks):
    """Run :func:`prefetch_vs_inline`, print it, keep it in ``row`` and
    add its checks: batches bit-identical when the host made ``event``
    (K5 and K6 sum with atomics, so two launches may differ in the last
    bits: within ``K56_REL_TOL`` there), and, for identical batches, the
    eval step's loss within its own run-to-run spread."""
    same, gap, own, (loss_gap, spread, preds, det) = prefetch_vs_inline(
        torch, trainer, data)
    print(f"  PrefetchLoader ({workers} workers) vs in line, one epoch's "
          f"batches: {'bit-identical' if same else 'differ'} (event max "
          f"gap {gap:.3e} of max; two in-line assemblies of the first "
          f"{own:.3e}); eval step on the first: loss gap "
          f"{loss_gap:.3e} (in line twice {spread:.3e}), predictions "
          f"{'equal' if preds else 'differ'} (in line twice "
          f"{'equal' if det else 'differ'})")
    row.update(prefetch_bit_identical=same, prefetch_event_gap=gap,
               inline_event_gap=own, prefetch_eval_loss_gap=loss_gap,
               eval_loss_spread=spread)
    device = how in ("K5", "K6")
    checks["delivered batches equal in-line ones"] = (
        gap <= K56_REL_TOL if device else same)
    if same:
        checks["eval on them as on in-line ones"] = (
            loss_gap <= spread and (preds or not det))


def dsec_grid_phase(torch, dev, smi, windows, zero_counts, read_counts,
                    host, *, how="K5", workers=1, steps=GRID_STEPS):
    """The flagship pretrain trainer on the grid wire, the batch's windows
    turned into ``event`` inside the loader (``how``: K5 on the card with
    ``host_voxelize: false``, ``host_voxelize`` on the host, or the
    ``histogram``), ``steps`` steps through ``train_epoch`` with
    ``num_cpu_workers`` = ``workers`` (the ``PrefetchLoader``'s threads).
    The host grid is held against K5's on the same windows; with more
    than one worker the delivered batches against in-line assembly."""
    from openess_tpu_torch.data.dsec import event_batch
    from openess_tpu_torch.training.trainer import Trainer, to_device

    phase(f"train on the DSEC grid wire: pretrain frame2voxel at full width, "
          f"bf16, event by {how} in the loader, num_cpu_workers {workers} "
          "(Trainer, PrefetchLoader)")
    B = len(windows)
    s = flagship_settings(
        e2vid_fused_gates=True, wire_format="grid",
        host_voxelize=how != "K5", save_checkpoint=False, batch_size_b=B,
        num_cpu_workers=workers,
        event_representation_b="histogram" if how == "histogram"
        else "voxel_grid")
    T, C = s.nr_events_data_b, s.input_channels_b
    H, W = (int(v) for v in s.img_size_b)
    rng = np.random.default_rng(3)
    side = {
        "frame": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        "label": rng.integers(0, 11, (B, H, W)).astype(np.int32),
        "pl": block_labels(rng, B, H, W, 11),
        "superpixel": block_superpixels(B, H, W),
        "sam_feat": np.ones((B, 64, 64, 256), np.float32),
    }
    print("the padded windows come from this script, not from a DSEC tree: "
          "reading events.h5 needs h5py, which the card machine lacks "
          "(PERF.md); they go through data/dsec.event_batch, the part of "
          "DSECDataset.get_batch after the file reads")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = GridWireDataset(s, side, windows, steps, dev)
    trainer = Trainer(s, data, None, seed=0, device=dev)
    sb = trainer.sb
    zero_counts()
    batch = to_device(data.get_batch(None), dev)
    ev = batch["event"]
    first = {k: float(v) for k, v in sb.train_step(batch, 0).items()}
    torch.cuda.synchronize()
    warm = read_counts()
    print(f"step 0 (warm-up): {first}; the batch's event "
          f"{tuple(ev.shape)} {ev.dtype} on {ev.device}, launches "
          + " ".join(f"{k} {v}" for k, v in warm.items()))
    gap = None
    if how == "host_voxelize":
        k5 = event_batch(dataclasses.replace(s, host_voxelize=False),
                         windows, dev)["event"]
        gap = ((ev - k5).abs().max() / k5.abs().max()).item()
        print(f"host-voxelized grid vs K5's on the same windows: max|host - "
              f"K5| {gap:.3e} of max|K5| (bound {HOST_GRID_REL_TOL:.0e})")
        del k5

    zero_counts()
    avg, wall, steady, n = timed_epoch(torch, trainer, data.ms)
    counts = read_counts()
    loader = loader_and_step_ms(torch, dev, lambda: data.get_batch(None),
                                sb, batch)
    row = report_loader("T8-pretrain-grid", how, workers, wall, steady, n,
                        data.ms, loader, smi, host)
    row["host_vs_device_grid_rel"] = gap
    print(f"  losses {avg}; launches "
          + " ".join(f"{k} {v}" for k, v in counts.items()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  peak memory {peak:.2f} GiB at B={B}")
    k5 = how == "K5"
    checks = {
        "every loss finite": all(np.isfinite(v) for v in first.values())
        and all(np.isfinite(v) for v in avg.values()),
        f"event planar [B, T, {C}, 440, 640] f32 on the card":
        tuple(ev.shape) == (B, T, C, H, W) and ev.dtype == torch.float32
        and ev.device.type == "cuda",
        "K5 once per batch" if k5 else "K5 never":
        counts["K5"] == (n if k5 else 0) and warm["K5"] == int(k5),
        "K1 never": counts["K1"] == warm["K1"] == 0,
        "K3 60 per step": counts["K3"] == 60 * n,
        "K2 twice per step": counts["K2"] == 2 * n,
        "no K3 backward, K4, K6":
        counts["K3_bwd"] == counts["K4"] == counts["K6"] == 0,
    }
    if gap is not None:
        checks["host grid within the bound of K5's"] = gap <= HOST_GRID_REL_TOL
    if workers > 1:
        check_prefetch(torch, trainer, data, how, workers, row, checks)
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"DSEC grid-wire checks failed: {checks}")
    del trainer, data, batch, ev
    return counts


def write_ddd17_tree(root, rng, need, images=5, gap=50_000):
    """A DDD17 tree (dir0..dir5) in the real dataset's layout, written with
    numpy and PIL: per recording ``images`` masks (200x346, 6 classes in
    blocks), frames (200x352), pseudo-labels and SLIC superpixels (25 ids)
    under their names (dir0 and dir1 name them apart), memmapped events with
    ``need`` events before the first image and ``gap`` between images, and
    the 50 ms index map."""
    from PIL import Image

    for d in range(6):
        path = os.path.join(root, f"dir{d}")
        for sub in ("segmentation_masks", "index", "images_aligned",
                    "pl_fcclip_rgb", "sp_slic_rgb"):
            os.makedirs(os.path.join(path, sub))
        n = need + gap * images
        t = np.sort(rng.integers(0, 10 ** 9, n)).astype(np.int64)
        xyp = np.stack([rng.integers(0, 346, n), rng.integers(0, 260, n),
                        rng.integers(0, 2, n)], -1).astype(np.int16)
        t.reshape(-1, 1).tofile(os.path.join(path, "events.dat.t"))
        xyp.tofile(os.path.join(path, "events.dat.xyp"))
        idx = need + gap * np.arange(images)
        before = np.searchsorted(t, t[idx] - 50_000)
        np.save(os.path.join(path, "index", "index_50ms.npy"),
                np.stack([t[idx], idx, before], -1))
        quirk = d in (0, 1)
        for i in range(1, images + 1):
            mask = block_labels(rng, 1, 200, 346, 6)[0].astype(np.uint8)
            frame = (rng.uniform(0, 255, (200, 352, 3))).astype(np.uint8)
            sp = block_superpixels(1, 200, 346, 5, 5)[0].astype(np.uint8)
            stem = f"{i:08d}"
            Image.fromarray(mask).save(os.path.join(
                path, "segmentation_masks", f"segmentation_{stem}.png"))
            Image.fromarray(frame).save(os.path.join(
                path, "images_aligned",
                f"img_{stem}.png" if quirk else f"00{stem}.png"))
            Image.fromarray(mask).save(os.path.join(
                path, "pl_fcclip_rgb",
                f"segmentation_{stem}.png" if quirk else f"00{stem}.png"))
            Image.fromarray(sp).save(os.path.join(
                path, "sp_slic_rgb", f"img_{stem}_slic_25.png" if quirk
                else f"00{stem}_slic_25.png"))


def ddd17_disk_phase(torch, dev, smi, zero_counts, read_counts, root, host,
                     *, how="K6", workers=1):
    """The DDD17 linear probe read from the tree under ``root`` on the grid
    wire: ``build_datasets`` -> ``Trainer.train_epoch`` -> ``val_epoch``,
    ``event`` made in the loader by K6 (``host_voxelize: false``) or on the
    host (``how="host_voxelize"``; held against K6's batch), with
    ``num_cpu_workers`` = ``workers``; with more than one worker the
    delivered batches against in-line assembly."""
    from openess_tpu_torch.data.loaders import build_datasets
    from openess_tpu_torch.training.trainer import Trainer, to_device

    phase(f"linear probe on DDD17 read from disk, grid wire, at full width, "
          f"bf16, event by {how} in the loader, num_cpu_workers {workers} "
          "(build_datasets, Trainer, PrefetchLoader)")
    k6 = how == "K6"
    s = ddd17_probe_settings(dataset_path_b=root, wire_format="grid",
                             host_voxelize=not k6, e2vid_fused_gates=True,
                             save_checkpoint=False, num_cpu_workers=workers)
    train, val = build_datasets(s, dev)
    load_ms = []
    read = train.get_batch

    def timed(idx):
        t1 = time.perf_counter()
        out = read(idx)
        load_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    train.get_batch = timed
    torch.cuda.empty_cache()
    trainer = Trainer(s, train, val, seed=0, device=dev)
    sb, mset = trainer.sb, trainer.mset
    idx = np.arange(s.batch_size_b)
    zero_counts()
    batch = to_device(train.get_batch(idx), dev)
    ev = batch["event"]
    first = {k: float(v) for k, v in sb.train_step(batch, 0).items()}
    torch.cuda.synchronize()
    print(f"train {len(train)} masks ({len(train) // s.batch_size_b} steps "
          f"of {s.batch_size_b}), val {len(val)}; step 0 (warm-up): {first}; "
          f"the batch's event {tuple(ev.shape)} {ev.dtype} on {ev.device}")
    gap = None
    if not k6:
        ref_ds = build_datasets(dataclasses.replace(s, host_voxelize=False),
                                dev)[0]
        ref = ref_ds.get_batch(idx)["event"]
        gap = ((ev - ref).abs().max() / ref.abs().max()).item()
        print(f"host-voxelized batch vs K6's on the same masks: max|host - "
              f"K6| {gap:.3e} of max|K6| (bound {HOST_GRID_REL_TOL:.0e}; "
              "both resized 346 -> 352 and cropped)")
        del ref_ds, ref
    state0 = {f"{m}.{k}": v.clone()
              for m, sd in mset.state_dict().items()
              for k, v in sd.items()}
    zero_counts()
    avg, wall, steady, n = timed_epoch(torch, trainer, load_ms)
    counts = read_counts()
    state1 = {f"{m}.{k}": v for m, sd in mset.state_dict().items()
              for k, v in sd.items()}
    moved = {k for k in state0 if not torch.equal(state0[k], state1[k])}
    loader = loader_and_step_ms(torch, dev, lambda: read(idx), sb, batch)
    row = report_loader("L8-probe-DDD17-disk", how, workers, wall, steady, n,
                        load_ms, loader, smi, host)
    row["host_vs_device_grid_rel"] = gap
    print(f"  losses {avg}; launches "
          + " ".join(f"{k} {v}" for k, v in counts.items()))
    zero_counts()
    summary = trainer.val_epoch()
    torch.cuda.synchronize()
    val_counts = read_counts()
    print(f"Trainer.val_epoch: mIoU {summary['miou']:.2f} acc "
          f"{summary['acc']:.2f} over {len(val)} masks in "
          f"{-(-len(val) // s.batch_size_b)} padded batches; launches "
          + " ".join(f"{k} {v}" for k, v in val_counts.items()))
    n_val = -(-len(val) // s.batch_size_b)
    checks = {
        "every loss finite": all(np.isfinite(v) for v in first.values())
        and all(np.isfinite(v) for v in avg.values()),
        "event planar [B, T, 5, 200, 352] f32 on the card":
        tuple(ev.shape) == (s.batch_size_b, s.nr_events_data_b, 5, 200,
                            352)
        and ev.dtype == torch.float32 and ev.device.type == "cuda",
        "only linear_probe.* moved": bool(moved) and all(
            ".linear_probe." in k for k in moved),
        "K6 once per batch" if k6 else "K6 never":
        counts["K6"] == (n if k6 else 0)
        and val_counts["K6"] == (n_val if k6 else 0),
        "K4 never": counts["K4"] == val_counts["K4"] == 0,
        "K3 60 per batch": counts["K3"] == 60 * n
        and val_counts["K3"] == 60 * n_val,
        "no K1, K2, K3 backward, K5": all(
            c[k] == 0 for c in (counts, val_counts)
            for k in ("K1", "K2", "K3_bwd", "K5")),
        "mIoU in [0, 100]": 0.0 <= summary["miou"] <= 100.0,
    }
    if gap is not None:
        checks["host grid within the bound of K6's"] = gap <= HOST_GRID_REL_TOL
    if workers > 1:
        train.get_batch = read
        check_prefetch(torch, trainer, train, how, workers, row, checks)
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"DDD17 from-disk checks failed: {checks}")
    del trainer, train, val, batch, ev
    return {k: counts[k] + val_counts[k] for k in counts}


def recon_batch(s, batch=8, seed=3):
    """One synthetic ``frame2recon`` batch on the host: random frames and
    reconstructions, block superpixels, and labels and pseudo-labels
    constant per block from a skewed class distribution."""
    rng = np.random.default_rng(seed)
    H, W = (int(v) for v in s.img_size_b)
    C = s.semseg_num_classes
    return {
        "frame": rng.uniform(0, 1, (batch, H, W, 3)).astype(np.float32),
        "recon": rng.uniform(0, 1, (batch, H, W, 3)).astype(np.float32),
        "label": block_labels(rng, batch, H, W, C),
        "pl": block_labels(rng, batch, H, W, C),
        "superpixel": block_superpixels(batch, H, W),
    }


def k2_ms_per_step(avg, n):
    """Device ms per step of K2's kernel in a profile of ``n`` steps."""
    return sum(e.self_device_time_total for e in avg
               if "segment_sums" in e.key) / 1e3 / n


def recon_phase(torch, dev, smi, title, settings, host_batch, steps,
                expect, loss_keys, zero_counts, read_counts, loaded=None,
                ckpt_dir=None):
    """A ``frame2recon`` workload at full width through ``Trainer``: a
    warm-up step, an epoch of ``steps`` steps on one batch through
    ``train_epoch`` (launch counts per step held to ``expect``), timed
    steps, ``val_epoch`` (eval mode: ``student_fold_bn`` folds the trained
    trunk; in f32 the folded trunk, whose fold cache was filled before
    training, is held to the unfolded one), a profile with the spans
    and K2's time, and, given ``ckpt_dir``, a checkpoint. ``loaded`` maps
    state-dict entries to the values they must hold before the first step.
    Returns the epoch's launch counts."""
    from openess_tpu_torch.metrics import MetricsSemseg
    from openess_tpu_torch.training import checkpoint as ckpt
    from openess_tpu_torch.training.build import trainable_labels
    from openess_tpu_torch.training.trainer import Trainer, to_device

    phase(title)
    B = host_batch["label"].shape[0]
    H, W = (int(v) for v in settings.img_size_b)
    s = dataclasses.replace(settings, batch_size_b=B, save_checkpoint=False)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = steps
    data = OneBatchDataset(host_batch, n)
    trainer = Trainer(s, data, data, seed=0, device=dev)
    sb, mset = trainer.sb, trainer.mset
    trainable = {k for k, v in trainable_labels(mset, s).items()
                 if v != "frozen"}
    students = [k for k, r in mset.roles.items() if r == "deeplab"]
    state0 = {f"{m}.{k}": v.clone() for m, sd in mset.state_dict().items()
              for k, v in sd.items()}
    print(f"task {mset.task}, {s.config_option}, modules "
          f"{dict(mset.roles)}; {s.dataset_name_b} at {(H, W)}, B={B}, "
          f"{s.semseg_num_classes} classes, {s.compute_dtype}, "
          f"output_stride {s.output_stride} (os16 trunk), student_fold_bn "
          f"{s.student_fold_bn}, teacher_os {s.teacher_os}, superpixel_size "
          f"{s.superpixel_size}, contrastive {s.if_spatial_contrastive}, "
          f"dense CLIP {s.if_dense_clip_supervision}, lr_recon {s.lr_recon}, "
          f"augmentation {'on' if s.data_augmentation_train else 'off'}; "
          f"random weights, seed 0; {len(trainable)} trainable tensors")
    if loaded is not None:
        same = all(torch.equal(state0[k], v.to(state0[k].dtype).to(dev))
                   for k, v in loaded.items())
        print(f"  {len(loaded)} tensors loaded from the pretrain checkpoint: "
              f"{'equal to the file' if same else 'DIFFER from the file'}")
        if not same or not loaded:
            raise AssertionError("the pretrain checkpoint was not loaded")

    batch = to_device(host_batch, dev)
    student = mset.modules["model_recon"]

    def f32_eval_logits(fold):
        """``model_recon``'s eval logits on the batch in f32, folded or
        not: the check of the fold cache, free of bf16 rounding."""
        student.dtype = student.backbone.dtype = torch.float32
        student.backbone.fold_bn = fold
        try:
            with torch.no_grad():
                return student(batch["recon"])[0]
        finally:
            student.dtype = student.backbone.dtype = mset.dtype
            student.backbone.fold_bn = s.student_fold_bn

    f32_eval_logits(True)  # fills the fold cache from the untrained trunk
    t0 = time.perf_counter()
    first = {k: float(v) for k, v in sb.train_step(batch, 0).items()}
    torch.cuda.synchronize()
    print(f"step 0 (warm-up, {time.perf_counter() - t0:.2f} s): {first}")

    zero_counts()
    t0 = time.perf_counter()
    avg_losses = trainer.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    counts = read_counts()
    print(f"Trainer.train_epoch: {n} steps in {epoch_s:.2f} s "
          f"({epoch_s * 1e3 / n:.1f} ms per step, host clock, batch upload "
          f"included); epoch-average losses {avg_losses}; launches "
          + " ".join(f"{k} {v}" for k, v in counts.items()))

    hist, events = [], []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses = sb.train_step(batch, 0)
        b.record()
        hist.append(losses)
        events.append((a, b))
    torch.cuda.synchronize()
    ms = np.array([a.elapsed_time(b) for a, b in events])
    hist = [first] + [{k: float(v) for k, v in h.items()} for h in hist]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train step p50 {np.percentile(ms, 50):.1f} ms p95 "
          f"{np.percentile(ms, 95):.1f} ms over {len(ms)} steps (CUDA "
          f"events, batch resident); peak memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) at B={B}; on {smi}")
    for key in sorted(loss_keys - {"total_loss"}):
        print(f"{key}: step 0 {hist[0][key]:.4f}, timed steps "
              + " ".join(f"{h[key]:.4f}" for h in hist[1:]))
    state1 = {f"{m}.{k}": v for m, sd in mset.state_dict().items()
              for k, v in sd.items()}
    moved = {k for k in state0 if not torch.equal(state0[k], state1[k])}
    stats = {k for k in state0 if k.split(".")[0] in students
             and "running_" in k}
    checks = {
        "every loss finite": all(np.isfinite(v) for h in hist
                                 for v in h.values())
        and all(np.isfinite(v) for v in avg_losses.values()),
        "loss keys": set(first) == loss_keys,
        f"the {len(trainable)} trainable tensors moved": trainable <= moved,
        f"the students' {len(stats)} running statistics moved":
        stats <= moved,
        "everything else unchanged": moved <= trainable | stats,
        "optimizer steps": sb.step == 1 + 2 * n,
    }
    for k, per_step in expect.items():
        checks[f"{k} {per_step} per step"] = counts[k] == per_step * n
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{title}: checks failed: {checks}")

    # eval: the folded trunk after training (its fold cache was filled
    # before the first step) against the unfolded one, in f32
    logits_f, logits_u = f32_eval_logits(True), f32_eval_logits(False)
    err = (logits_f - logits_u).abs().max().item()
    scale = logits_u.abs().max().item()
    with torch.no_grad():
        _, feats = sb._predict(batch)
    t0 = time.perf_counter()
    summary = trainer.val_epoch()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    eval_ok = {
        "features f32 [B,H,W,256]": feats.dtype == torch.float32
        and tuple(feats.shape) == (B, H, W, 256),
        "f32 folded trunk within 1e-3 x max of the unfolded":
        err <= 1e-3 * scale,
        "mIoU in [0, 100]": 0.0 <= summary["miou"] <= 100.0,
        "confusion counts every pixel":
        summary["cm"].sum() == len(data) * H * W,
    }
    print(f"val_epoch ({len(data)} samples, {val_s:.2f} s): mIoU "
          f"{summary['miou']:.2f} acc {summary['acc']:.2f} against block "
          f"labels; f32 folded vs unfolded trunk after training: "
          f"max|diff| logits {err:.3e} of max {scale:.3f}; " + ", ".join(
              f"{k} {'ok' if v else 'FAIL'}" for k, v in eval_ok.items()))
    if not all(eval_ok.values()):
        raise AssertionError(f"{title}: eval checks failed: {eval_ok}")
    if ckpt_dir is not None:
        path = ckpt.save_checkpoint(ckpt_dir, mset, trainer.optimizer,
                                    sb.step, 0)
        print(f"checkpoint {os.path.getsize(path) / 1e6:.1f} MB written")

    print("trace: device busy time and idle share")
    k = 3
    avg, wall, spans = device_profile(
        torch, lambda: [sb.train_step(batch, 0) for _ in range(k)])
    print_profile(avg, wall, k, "step", smi)
    print_spans(avg, spans, k)
    print(f"K2 segment_pool_sums: {counts['K2'] // n} launches a step, "
          f"{k2_ms_per_step(avg, k):.3f} device ms a step; on {smi}")
    del trainer, sb, mset, batch
    torch.cuda.empty_cache()
    return counts


def small_residual_scales(mset, seed=7):
    """Each DeepLabV3 bottleneck's ``bn3`` scale from U(0.02, 0.06): at the
    identity init the f32 backward of a train-mode ResNet-50 explodes
    (measured on the CPU against f64), and no bound could tell a wrong
    gradient from rounding (``tests/test_torch_recon_train.py``)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in mset.modules.items():
            if mset.roles[name] != "deeplab":
                continue
            for mod_name, mod in m.backbone.named_modules():
                if mod_name.endswith("bn3"):
                    w = torch.empty(mod.weight.shape).uniform_(
                        0.02, 0.06, generator=gen)
                    mod.weight.copy_(w.to(mod.weight.device))


def recon_reference_phase(torch, dev):
    """One f32 pretrain ``frame2recon`` step at 64x96, B = 2 (teacher at
    output stride 4, SAM distillation on) on CUDA (K2 on the student's f32
    and the teacher's features) against the same step on the CPU (plain
    versions), same seed, dropout off."""
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder
    from openess_tpu_torch.training.trainer import to_device

    phase("frame2recon reference: f32 pretrain step on CUDA (K2) vs on the "
          "CPU (plain), 64x96, B=2")
    s = recon_pretrain_settings(
        compute_dtype="float32", img_size_b=(64, 96), batch_size_b=2,
        data_augmentation_train=False, if_sam_distillation=True,
        superpixel_size=100)
    host = recon_batch(s, batch=2, seed=5)
    host["sam_feat"] = np.random.default_rng(6).normal(
        0, 1, (2, 64, 64, 256)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        mset = build_models(s, seed=0, device=d)
        small_residual_scales(mset)
        mset.modules["model_recon"].classifier.ASPP.dropout_rate = 0.0
        sb = StepBuilder(s, mset, make_optimizer(s, mset), 1)
        sb._set_mode(True)
        total, losses = sb.compute_losses(to_device(host, d), 0)
        total.backward()
        out[d.type] = (
            {k: float(v.detach()) for k, v in losses.items()},
            {f"{n}.{k}": p.grad.detach().cpu()
             for n, m in mset.modules.items()
             for k, p in m.named_parameters() if p.grad is not None},
            {f"{n}.{k}": v.cpu() for n, m in mset.modules.items()
             for k, v in m.state_dict().items() if "running_" in k})
        del mset, sb, total, losses
    (lg, gg, sg), (lc, gc, sc) = out["cuda"], out["cpu"]
    worst_loss = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
    errs = [((gg[k] - gc[k]).norm() / gc[k].norm()).item() for k in gc]
    stats = max(((sg[k] - v).abs().max() / v.abs().max()).item()
                for k, v in sc.items())
    ok = (worst_loss <= TRAIN_LOSS_REL_TOL and stats <= TRAIN_LOSS_REL_TOL
          and max(errs) <= RECON_GRAD_L2_TOL
          and float(np.median(errs)) <= RECON_GRAD_MEDIAN_TOL
          and set(gg) == set(gc) and set(lc) == {
              "contrastive_nce_loss", "dense_clip_loss",
              "sam_distillation_loss", "total_loss"})
    print(f"losses {lc}")
    print(f"max rel |cuda-cpu|: losses {worst_loss:.3e} (bound "
          f"{TRAIN_LOSS_REL_TOL:.0e}); running statistics {stats:.3e} of "
          f"each tensor's max (bound {TRAIN_LOSS_REL_TOL:.0e}); gradients of "
          f"{len(errs)} tensors, relative L2: median "
          f"{float(np.median(errs)):.3e} (bound {RECON_GRAD_MEDIAN_TOL:.0e}),"
          f" worst {max(errs):.3e} (bound {RECON_GRAD_L2_TOL:.0e}: the f32 "
          f"backward through 60 train-mode BatchNorms of batch 2, as the "
          f"CPU tests hold the port to JAX) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the CUDA frame2recon step disagrees with the "
                             "CPU one")


def trace_phase(torch, sb, batch):
    """``--profile``'s trace (``utils/profiling.trace``) of two T8-pretrain
    steps: the file is written and holds K1's, K3's and K2's kernels; and
    whether K1's kernel, launched through ``ctypes``, falls inside the
    ``train/voxelize`` span (by its launch on the host, and on the
    device's timeline)."""
    from openess_tpu_torch.utils.profiling import trace

    phase("--profile: two T8-pretrain steps under utils/profiling.trace")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        with trace(d):
            for _ in range(2):
                sb.train_step(batch, 0)
            torch.cuda.synchronize()
        files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
        if len(files) != 1:
            raise AssertionError(f"--profile wrote {os.listdir(d)}")
        path = os.path.join(d, files[0])
        size_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    print(f"trace {files[0]}: {size_mb:.1f} MB, {len(events)} events, "
          f"{time.perf_counter() - t0:.1f} s with the write")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {"K1": "chunk_tile_splat", "K3": "lstm_gates_fwd",
             "K2": "segment_sums"}
    found = {k: sum(v in e.get("name", "") for e in kernels)
             for k, v in names.items()}
    print("kernels in the trace: " + ", ".join(
        f"{k} ({names[k]}) x{n}" for k, n in found.items()))
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    cpu_spans = [e for e in events if e.get("name") == "train/voxelize"
                 and e.get("cat") == "user_annotation"]
    gpu_spans = [e for e in events if e.get("name") == "train/voxelize"
                 and e.get("cat") == "gpu_user_annotation"]
    k1 = [e for e in kernels if names["K1"] in e.get("name", "")]
    on_host = on_device = 0
    for e in k1:
        launch = launches.get(e.get("args", {}).get("correlation"))
        on_host += launch is not None and any(
            sp["ts"] <= launch["ts"] <= sp["ts"] + sp["dur"]
            for sp in cpu_spans)
        on_device += any(g["ts"] <= e["ts"] and e["ts"] + e["dur"]
                         <= g["ts"] + g["dur"] for g in gpu_spans)
    print(f"K1's {len(k1)} kernels: {on_host} launched inside a host "
          f"train/voxelize span ({len(cpu_spans)} spans), {on_device} inside "
          f"a device-side train/voxelize span ({len(gpu_spans)} spans)")
    if not all(found.values()):
        raise AssertionError(f"kernels missing from the trace: {found}")


def s2d_wgrad_phase(torch, dev, smi):
    """The weight gradients of E2VID's head and enc0, standard and s2d, at
    the fine-tune step's shapes (B = 8, 440x640, bf16 channels-last, 20
    windows a step), each alone under the profiler: which cuDNN kernels
    run and their device ms per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from openess_tpu_torch.models.e2vid import s2d_kernel

    phase("E2VID head and enc0 weight gradients, standard and s2d (B = 8, "
          "440x640, bf16; 20 windows a step)")
    cl = torch.channels_last
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = {}
    for layer, cin, cout, stride in (("head", 5, 32, 1), ("enc0", 32, 64, 2)):
        w5 = torch.randn((cout, cin, 5, 5), device=dev, generator=gen) * 0.1
        for form in ("standard", "s2d"):
            if form == "standard":
                x = torch.randn((8, cin, 440, 640), device=dev,
                                generator=gen)
                w, pad = w5, 2
            else:
                x = torch.randn((8, 4 * cin, 220, 320), device=dev,
                                generator=gen)
                w, pad, stride = s2d_kernel(w5, layer == "head"), 1, 1
            x = x.to(torch.bfloat16).contiguous(memory_format=cl)
            w = w.to(torch.bfloat16).contiguous(memory_format=cl)
            out = torch.nn.functional.conv2d(x, w, None, stride, pad)
            go = torch.randn(out.shape, device=dev, generator=gen).to(
                torch.bfloat16).contiguous(memory_format=cl)

            def wgrad():
                torch.ops.aten.convolution_backward(
                    go, x, w, None, [stride] * 2, [pad] * 2, [1, 1], False,
                    [0, 0], 1, [False, True, False])

            for _ in range(3):
                wgrad()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    wgrad()
                torch.cuda.synchronize()
            dev_rows = [e for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0]
            total = sum(e.self_device_time_total for e in dev_rows) / 1e3
            rows[(layer, form)] = total
            print(f"{layer} {form}: x {tuple(x.shape)} w {tuple(w.shape)}: "
                  f"{total:.2f} ms for 20 weight gradients; kernels: "
                  + "; ".join(f"{e.key[:100]} x{e.count // 20} "
                              f"{e.self_device_time_total / 1e3:.2f} ms"
                              for e in sorted(dev_rows, key=lambda e:
                                              -e.self_device_time_total)))
            del x, w, out, go
    print("s2d against standard, ms per step (20 windows): " + ", ".join(
        f"{layer} {rows[(layer, 'standard')]:.2f} -> "
        f"{rows[(layer, 's2d')]:.2f}" for layer in ("head", "enc0"))
          + f"; on {smi}")
    return rows


def s2d_reference_phase(torch, dev, height=440, width=640):
    """E2VID's s2d form against its standard form, both on the card in f32
    (TF32 off, K3's gates), at full width on a small batch (B = 2, T = 3)
    fed the same voxel windows, then the gradients of the latent
    projection again in f64 (within ``S2D_F64_GRAD_REL_TOL``). Within ``S2D_REL_TOL`` of each tensor's
    max: the latents and the fine-tune step's loss; and the head's and
    enc0's convolutions alone on the step's first window (their outputs
    and the gradients of a positive random projection of them to the 5x5
    parameters, through ``s2d_kernel``'s gather on the card). E2VID's
    gradients through the whole recurrence, of a projection of the
    latents and of the step's loss, are bounded by
    ``S2D_RELU_GRAD_REL_TOL``: a ReLU input that rounds to the other side
    of zero in one form flips one pixel's term, and a gradient that is a
    cancelling sum over ~1e6 pixels moves by ~1/sqrt(N) of its max for
    each flip."""
    import torch.nn.functional as F

    from openess_tpu_torch.data.synthetic import SyntheticESS
    from openess_tpu_torch.models.e2vid import (
        normalize_event_window,
        s2d_kernel,
    )
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder
    from openess_tpu_torch.training.trainer import to_device

    phase(f"s2d reference: f32 fine-tune step with unfrozen_e2vid on the "
          f"card, s2d against standard ({height}x{width}, B=2, T=3)")
    ds = SyntheticESS(num_samples=2, height=height, width=width,
                      num_classes=11, num_windows=3, events_per_window=100_000)
    host = ds.raw_wire_batch([0, 1])
    out, batch = {}, None
    for s2d in (False, True):
        s = finetune_settings(
            dataset_name_b="synthetic_events", img_size_b=(height, width),
            nr_events_data_b=3,
            batch_size_b=2, compute_dtype="float32", e2vid_fused_gates=True,
            load_pretrained_weights=False, data_augmentation_train=False,
            e2vid_s2d=s2d)
        mset = build_models(s, seed=0, device=dev)
        e2vid = mset.modules["front_sensor_b"]
        sb = StepBuilder(s, mset, make_optimizer(s, mset), 1)
        sb._set_mode(True)
        if batch is None:  # K1 once: both forms get the same windows
            batch = sb._with_windows(to_device(host, dev))
        total, losses = sb.compute_losses(batch, 0)
        total.backward()
        step = {k: p.grad.clone() for k, p in e2vid.named_parameters()}
        e2vid.zero_grad()
        _, latent = e2vid(batch["event"])
        gen = torch.Generator(device=dev).manual_seed(3)
        sum(torch.randn(v.shape, generator=gen, device=dev).mul(v).sum()
            for _, v in sorted(latent.items())).backward()
        probe = {k: p.grad.clone() for k, p in e2vid.named_parameters()}
        out[s2d] = (float(losses["semseg_loss"].detach()),
                    {k: v.detach() for k, v in latent.items()}, step, probe)
        unet = e2vid.unetrecurrent
        del mset, sb, total, losses

    # the two rewritten convolutions alone, on the first window
    x = normalize_event_window(batch["event"][:, 0]).contiguous(
        memory_format=torch.channels_last)
    head, enc0 = unet.head.conv2d, unet.encoders[0].conv.conv2d
    with torch.no_grad():
        h = F.relu(head(x))
    layers = {}
    for name, conv, inp, s2d_out in (("head", head, x, True),
                                     ("enc0", enc0, h, False)):
        w = conv.weight.detach().clone().requires_grad_(True)
        b = conv.bias.detach().clone().requires_grad_(True)
        std = F.conv2d(inp, w, b, conv.stride, conv.padding)
        y = F.conv2d(F.pixel_unshuffle(inp, 2), s2d_kernel(w, s2d_out),
                     b.repeat_interleave(4) if s2d_out else b, padding=1)
        alt = F.pixel_shuffle(y, 2) if s2d_out else y
        # positive weights: a random-sign projection makes each bias
        # gradient a cancelling sum over ~1e5 pixels, whose f32 rounding
        # alone is ~eps * sqrt(N) of it
        r = torch.rand(std.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(4)) + 0.5
        grads = [torch.autograd.grad((r * o).sum(), (w, b))
                 for o in (std, alt)]
        layers[name] = (
            {"out": std.detach(), "weight": grads[0][0], "bias": grads[0][1]},
            {"out": alt.detach(), "weight": grads[1][0], "bias": grads[1][1]})

    def rel(a, b):
        return max((b[k] - a[k]).abs().max().item()
                   / max(a[k].abs().max().item(), 1e-30) for k in a)

    (la, lat_a, st_a, pr_a), (lb, lat_b, st_b, pr_b) = out[False], out[True]
    errs = {"latents": rel(lat_a, lat_b), "loss": abs(lb - la) / abs(la)}
    for name, (a, b) in layers.items():
        errs[f"{name} alone: output and gradients"] = rel(a, b)
    relu = {"E2VID gradients of a latent projection": rel(pr_a, pr_b),
            "E2VID gradients of the step's loss": rel(st_a, st_b)}
    ok = (all(v <= S2D_REL_TOL for v in errs.values())
          and all(v <= S2D_RELU_GRAD_REL_TOL for v in relu.values()))
    print("max rel |s2d-standard|: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f" (bound {S2D_REL_TOL:.0e} of each tensor's max); "
        + ", ".join(f"{k} {v:.3e}" for k, v in relu.items())
        + f" (through the ReLUs; bound {S2D_RELU_GRAD_REL_TOL:.0e}) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(
            f"s2d disagrees with the standard form: {errs} {relu}")

    # the latent projection's gradients again with E2VID in f64 on the same
    # windows (plain gates: K3 takes bf16 and f32): a ReLU input lands on
    # the other side of zero in one form only at an exact tie, so the forms
    # agree to f64 rounding. The windows are normalized once, outside, for
    # both forms: the normalization's statistics accumulate in f32, in each
    # form's own order
    e2vid = e2vid.double()
    e2vid.normalize = False
    for enc in e2vid.unetrecurrent.encoders:
        enc.recurrent_block.fused_gates = False
    x = batch["event"].double()
    x = torch.stack([normalize_event_window(x[:, t])
                     for t in range(x.shape[1])], dim=1)
    grads = {}
    for s2d in (False, True):
        e2vid.s2d = s2d
        e2vid.zero_grad()
        _, latent = e2vid(x)
        gen = torch.Generator(device=dev).manual_seed(3)
        sum(torch.randn(v.shape, generator=gen, device=dev,
                        dtype=torch.float64).mul(v).sum()
            for _, v in sorted(latent.items())).backward()
        grads[s2d] = {k: p.grad.clone() for k, p in e2vid.named_parameters()}
    err64 = rel(grads[False], grads[True])
    ok = err64 <= S2D_F64_GRAD_REL_TOL
    print(f"f64 (E2VID in float64, plain gates, the same windows): max rel "
          f"|s2d-standard| E2VID gradients of a latent projection "
          f"{err64:.3e} (bound {S2D_F64_GRAD_REL_TOL:.0e}; f32 above "
          f"{relu['E2VID gradients of a latent projection']:.3e}) "
          f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"s2d disagrees with the standard form in "
                             f"f64: {err64}")


def dumps_phase(torch, dev, title, settings, host_batch, key, zero_counts,
                read_counts):
    """``Trainer.val_epoch`` with ``vis_dir`` on one batch: the five PNGs of
    the JAX trainer exist and decode; the raw-wire batch is voxelized by
    ``key`` (K1 or K4) once for the eval step, once for the viz step and
    once for the event previews. Returns the launch counts."""
    from PIL import Image

    from openess_tpu_torch.training.trainer import Trainer

    phase(title)
    with tempfile.TemporaryDirectory() as d:
        s = dataclasses.replace(settings, vis_dir=d, save_checkpoint=False,
                                load_pretrained_weights=False)
        data = OneBatchDataset(host_batch, 1)
        trainer = Trainer(s, data, data, seed=0, device=dev)
        zero_counts()
        t0 = time.perf_counter()
        summary = trainer.val_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        found = {}
        for name in VIS_FILES:
            path = os.path.join(d, f"{name}_e000.png")
            if os.path.exists(path):
                with Image.open(path) as im:
                    found[name] = np.asarray(im).shape
    print(f"val_epoch {wall:.2f} s with the dumps, mIoU "
          f"{summary['miou']:.2f}; PNGs: " + ", ".join(
              f"{k} {v}" for k, v in found.items()) + "; launches "
          + " ".join(f"{k} {v}" for k, v in counts.items()))
    checks = {
        "five PNGs, each decodes": set(found) == set(VIS_FILES)
        and all(len(v) == 3 for v in found.values()),
        f"{key} 3 (eval, viz, previews)": counts[key] == 3,
    }
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{title}: checks failed: {checks}")
    return counts


def randomized(torch, sd, seed):
    """Every float tensor of ``sd`` drawn anew (running variances
    positive), the integer trackers kept."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point():
            r = torch.randn(v.shape, generator=g) * 0.05
            out[k] = r.abs() + 0.5 if k.endswith("running_var") else r
        else:
            out[k] = v.clone()
    return out


def released_phase(torch, dev):
    """Random weights written in the four released layouts
    (``E2VID_lightweight.pth.tar``, an OpenESS ``Epoch_N.pt``, a DINO
    ResNet-50 under ``module.``, the CLIP text ``.pth``), converted by
    ``python -m openess_tpu_torch.convert_checkpoints``, loaded through
    ``checkpoint.pretrained_file`` into CUDA model sets (the flagship
    pretrain's and the ``frame2recon`` student's), every tensor equal to
    the file's; one window served from the converted file."""
    from openess_tpu_torch import convert_checkpoints
    from openess_tpu_torch.models.deeplabv3 import DeepLabV3TextSeg
    from openess_tpu_torch.models.e2vid import E2VIDReconstructor
    from openess_tpu_torch.models.image_teacher import (
        DilationFeatureExtractor,
    )
    from openess_tpu_torch.models.semseg_e2vid import SemSegE2VID
    from openess_tpu_torch.serve_stream import StreamServer, serve
    from openess_tpu_torch.serve_stream import synthetic_windows as windows
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.checkpoint import load_pretrained_params

    phase("released checkpoints: four layouts -> convert_checkpoints -> "
          "pretrained_file on the card -> one window served")
    torch.manual_seed(0)
    e2vid = randomized(torch, E2VIDReconstructor().state_dict(), 1)
    r50 = randomized(torch, DilationFeatureExtractor().encoder.state_dict(),
                     4)
    r50 = {"module." + k: v for k, v in r50.items()}
    r50["module.fc.weight"] = torch.randn(1000, 2048)
    layouts = {
        "E2VID_lightweight.pth.tar": {
            "arch": "E2VIDRecurrent", "model": {"num_bins": 5},
            "state_dict": e2vid},
        "Epoch_29.pt": {
            "front_sensor_b": e2vid,
            "model_recon": randomized(
                torch, DeepLabV3TextSeg(11).state_dict(), 2),
            "back_end": randomized(
                torch, SemSegE2VID(input_c=256, num_classes=11).state_dict(),
                3),
            "epoch": 29},
        "dino_resnet50.pth": {"state_dict": r50},
        "text.pth": torch.randn(11, 512),
    }
    with tempfile.TemporaryDirectory() as d:
        paths = {k: os.path.join(d, k) for k in layouts}
        for k, obj in layouts.items():
            torch.save(obj, paths[k])
        out = os.path.join(d, "converted.pt")
        t0 = time.perf_counter()
        convert_checkpoints.main([
            "--openess_ckpt", paths["Epoch_29.pt"],
            "--e2vid", paths["E2VID_lightweight.pth.tar"],
            "--teacher_r50", paths["dino_resnet50.pth"],
            "--text_pth", paths["text.pth"],
            "--text_out", os.path.join(d, "text.npy"), "--out", out])
        convert_s = time.perf_counter() - t0
        held = torch.load(out, weights_only=True)["models"]
        checks, loaded = {}, 0
        for title, settings in (
                ("pretrain frame2voxel", flagship_settings(
                    e2vid_fused_gates=True, pretrained_file=out)),
                ("frame2recon student", finetune_settings(
                    config_option="frame2recon", pretrained_file=out))):
            mset = build_models(settings, seed=5, device=dev)
            taken = load_pretrained_params(settings.pretrained_file, mset,
                                           exclude_substrings=(
                                               "linear_probe",))
            same = True
            for name, module in mset.modules.items():
                own = module.state_dict()
                for k, v in held.get(name, {}).items():
                    if k in own:
                        same &= f"{name}.{k}" in taken and torch.equal(
                            own[k].cpu(), v.to(own[k].dtype))
            checks[f"{title}: every converted tensor loaded, equal"] = same
            loaded += len(taken)
            del mset
        server = StreamServer(flagship_settings(e2vid_fused_gates=True), 1,
                              dev, checkpoint=out)
        r = serve(server, windows(2, 100_000, 480, 640))
        torch.cuda.synchronize()
        checks["served logits finite"] = bool(torch.isfinite(r.logits).all())
        checks["labels in [0, 11)"] = int(r.labels.max()) < 11
        checks["text .npy"] = np.array_equal(
            np.load(os.path.join(d, "text.npy")),
            layouts["text.pth"].numpy())
    print(f"converted in {convert_s:.1f} s: modules {sorted(held)}; "
          f"{loaded} tensors loaded through pretrained_file; served window "
          f"p50 {np.percentile(r.latency_ms, 50):.1f} ms")
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"released checkpoints: checks failed: {checks}")


def bench_phase(torch):
    """``python -m openess_tpu_torch.bench`` once at full width, in its own
    process; its JSON line is printed on a line of its own and its keys
    and MFU checked."""
    phase("bench: python -m openess_tpu_torch.bench (full width, own "
          "process)")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "openess_tpu_torch.bench"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        print(r.stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"the bench exited with {r.returncode}")
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} JSON lines")
    out = json.loads(lines[0])
    print(f"bench ran {wall:.1f} s; its line:")
    print(lines[0])
    extra = out["extra"]
    missing = [k for k in BENCH_KEYS if k not in extra]
    checks = {
        "metric and unit": out["metric"] == "voxelize_throughput"
        and out["unit"] == "events/s",
        "keys": not missing,
        "value > 0, vs_baseline > 1": out["value"] > 0
        and out["vs_baseline"] > 1,
        "0 < mfu_pct <= 100": extra.get("mfu_pct") is not None
        and 0 < extra["mfu_pct"] <= 100,
        "device_kind is this card": extra.get("device_kind")
        == torch.cuda.get_device_name(0),
    }
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items())
        + (f"; missing {missing}" if missing else ""))
    if not all(checks.values()):
        raise AssertionError(f"bench: checks failed: {checks}")
    return out


def export_artifact(torch, dev, s, out_dir, name, *, streaming):
    """Export the flagship-width serving step (``streaming``) or batch
    step of ``s`` on the card with seeded random weights (seed 0, the live
    server's), write it under ``out_dir`` and report the export time, the
    artifact's size and its ``lstm_gates_fwd`` nodes. Returns the
    artifact's path, the live module it was traced from and the
    numbers."""
    from openess_tpu_torch import export_model as em
    from openess_tpu_torch.training.build import build_models

    mset = build_models(s, seed=0, device=dev, event_path_only=True)
    t0 = time.perf_counter()
    if streaming:
        module, args = em.build_streaming_fn(s, mset)
    else:
        module, x = em.build_infer_fn(s, mset)
        args = (x,)
    ep = em.export(module, args)
    export_s = time.perf_counter() - t0
    path = os.path.join(out_dir, f"{name}.pt2")
    nodes = em.count_gate_nodes(ep)
    size = em.save_artifact(ep, path, dict(
        kind="streaming" if streaming else "batch", device=str(dev)))
    t0 = time.perf_counter()
    em.load_artifact(path, dev)
    load_s = time.perf_counter() - t0
    row = dict(name=f"export {name}", export_s=export_s, load_s=load_s,
               mb=size / 1e6, lstm_gates_fwd_nodes=nodes,
               inputs=[list(shape) + [str(dtype)] for shape, dtype
                       in em.input_specs(ep)[-1:]])
    print(f"{name}: exported in {export_s:.1f} s (torch.export on the card, "
          f"host time), {size / 1e6:.1f} MB, loaded in {load_s:.2f} s, "
          f"{nodes} lstm_gates_fwd nodes, window/event input "
          f"{row['inputs'][0]}")
    return path, module, row


def export_serving_phase(torch, dev, smi, host, s, art_path, S, n,
                         zero_counts, read_counts, voxel_key):
    """``serve_stream --artifact`` against the live server (the same
    seed-0 weights) on ``n`` synthetic windows at ``S`` streams: first
    window by window from zero states on each window's one packed wire
    (labels equal, logits within ``EXPORT_LOGIT_REL_TOL`` of the max),
    then each through ``serve`` (p50 and p95, the artifact's launches:
    the voxelizer ``voxel_key`` once and K3 three times a window)."""
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.serve_stream import (
        StreamServer,
        serve,
        synthetic_windows,
    )

    live = StreamServer(s, S, dev)
    art = StreamServer(s, S, dev, artifact=art_path)
    wins = list(synthetic_windows(n, s.nr_events_window_b, live.sensor_h,
                                  live.sensor_w))
    cl, ca = live.initial_state(), art.initial_state()
    equal, gap, scale = 0, 0.0, 0.0
    for win in wins:
        wire = upload_wire(live.pack(*win), dev)
        cl, ll, gl = live.step(cl, wire)
        ca, la, ga = art.step(ca, wire)
        equal += bool(torch.equal(la, ll))
        gap = max(gap, (ga.float() - gl.float()).abs().max().item())
        scale = max(scale, gl.float().abs().max().item())
    zero_counts()
    ra = serve(art, wins)
    torch.cuda.synchronize()
    got = read_counts()
    rl = serve(live, wins)
    torch.cuda.synchronize()
    print(f"[artifact, S={S}] window by window against the live server: "
          f"labels equal in {equal} of {n} windows, max|logits diff| "
          f"{gap:.3e} of max {scale:.3f} (bound {EXPORT_LOGIT_REL_TOL:g} x "
          f"max)")
    serving_row(host, f"S{S} {s.dataset_name_b}, artifact", ra, smi)
    print(f"[live, S={S}, the same windows]")
    serving_row(host, f"S{S} {s.dataset_name_b}, live beside the artifact",
                rl, smi)
    print("  artifact launches " + " ".join(f"{k} {v}"
                                             for k, v in got.items()))
    others = [k for k in got if k not in (voxel_key, "K3")]
    checks = {
        "labels equal every window": equal == n,
        "logits within the bound": gap <= EXPORT_LOGIT_REL_TOL * scale,
        "labels uint8": ra.labels.dtype == np.uint8,
        f"{voxel_key} once per window": got[voxel_key] == n,
        "K3 three per window": got["K3"] == 3 * n,
        "no other kernel": all(got[k] == 0 for k in others),
    }
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"artifact serving checks failed: {checks}")
    return got


def export_batch_phase(torch, dev, settings, module, art_path, host_batch,
                       flush, zero_counts, read_counts):
    """The batch artifact (B = 8, T = 20) against ``StepBuilder.infer``,
    the module it was traced from, on one flagship grid batch (the packed
    batch voxelized by K1): labels equal, logits within
    ``EXPORT_LOGIT_REL_TOL`` of the max; both timed by CUDA events."""
    from openess_tpu_torch.data.device_voxelize import (
        upload_wire,
        voxelize_wire,
    )
    from openess_tpu_torch.export_model import load_artifact

    phase("export: the batch artifact against eager StepBuilder.infer "
          "(B=8, T=20, 440x640, bf16)")
    with torch.no_grad():
        event = voxelize_wire(settings, upload_wire(
            {k: v for k, v in host_batch.items() if k.startswith("ev_")},
            dev)).float()
    run = load_artifact(art_path, dev)[0].module()
    with torch.no_grad():
        pl, ll = module(event)
        zero_counts()
        pa, la = run(event)
        torch.cuda.synchronize()
        got = read_counts()
        gap = (la.float() - ll.float()).abs().max().item()
        scale = ll.float().abs().max().item()
        ms_a = cuda_ms(torch, lambda: run(event), flush, iters=5, warmup=1)
        ms_e = cuda_ms(torch, lambda: module(event), flush, iters=5,
                       warmup=1)
    equal = bool(torch.equal(pa, pl))
    print(f"labels equal {equal}; max|logits diff| {gap:.3e} of max "
          f"{scale:.3f} (bound {EXPORT_LOGIT_REL_TOL:g} x max); artifact "
          f"{ms_a:.2f} ms, eager {ms_e:.2f} ms a batch (CUDA events); "
          f"launches " + " ".join(f"{k} {v}" for k, v in got.items()))
    ok = (equal and gap <= EXPORT_LOGIT_REL_TOL * scale and got["K3"] == 60
          and all(v == 0 for k, v in got.items() if k != "K3"))
    if not ok:
        raise AssertionError("the batch artifact disagrees with eager "
                             f"inference: {equal} {gap} {got}")
    return got, dict(name="export batch B8 T20 DSEC, run", artifact_ms=ms_a,
                     eager_ms=ms_e)


def k3_dispatch_us(torch, k3, gates, pc, n=300):
    """Host microseconds a call of K3's forward through its op
    (``fused_lstm_gates``: the check, the dispatcher, the op's CUDA
    implementation) and of that implementation called directly, each over
    ``n`` back-to-back calls after a warm-up: what the ``torch.library``
    route adds to a launch."""
    out = {}
    for name, fn in (
            ("op", lambda: k3.fused_lstm_gates(gates, pc)),
            ("direct", lambda: k3._lstm_gates_fwd_cuda(gates, pc))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    return out


def seeded_e2vid_file(torch, path, seed=0):
    """Random E2VID_lightweight weights (torch's default initialization
    under ``seed``) written in the released ``.pth.tar`` layout."""
    from openess_tpu_torch.models.e2vid import E2VIDReconstructor

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = E2VIDReconstructor().state_dict()
    torch.save({"arch": "E2VIDRecurrent", "model": {"num_bins": 5},
                "state_dict": sd}, path)
    return path


def offline_recon_dsec_phase(torch, dev, smi, e2vid_path, zero_counts,
                             read_counts):
    """O-recon-DSEC: ``generate_reconstructions.reconstruct_label`` (the
    DSEC tree mode's work for one label) at 480x640 on three labels' padded
    windows (``dsec_windows``: 20 x 100 000 uniform events, as
    ``DSECSequence.load_events`` gives them), bf16 with K3's gates; then the same
    windows through f32 reconstructors with K3 and with the plain gates,
    compared before quantization."""
    from openess_tpu_torch import generate_reconstructions as gr
    from openess_tpu_torch.ops import lstm_gates as k3

    phase("O-recon-DSEC: generate_reconstructions' per-label work at "
          "480x640, 20 windows x 100k events, bf16, K3 gates (3 labels)")
    gen = torch.Generator(device=dev).manual_seed(1212)
    k3_ulps = 0.0
    for h, w, c in K3_SENSOR_SHAPES:  # the shapes this path gives K3
        gates = (torch.randn((1, h, w, 4 * c), generator=gen, device=dev)
                 * 2).to(torch.bfloat16)
        pc = torch.randn((1, h, w, c), generator=gen,
                         device=dev).to(torch.bfloat16)
        k3_ulps = max(k3_ulps, k3_fwd_check(torch, k3, gates, pc)[1])
    print(f"K3 vs plain at the 480x640 levels, B = 1, bf16: {k3_ulps:.3f} of "
          f"the bound (1 bf16 ulp + {K3_ABS_SLACK:.0e})")
    weights = gr.e2vid_weights(e2vid_path)
    recon = gr.build_reconstructor(weights, dev)
    labels = dsec_windows(flagship_settings(), batch=3, seed=12)
    rows, imgs = [], []
    zero_counts()
    for ev in labels:
        times = {}
        t0 = time.perf_counter()
        img, rgb = gr.reconstruct_label(recon, *ev, 480, 640, times)
        rows.append(dict(total=(time.perf_counter() - t0) * 1e3,
                         **{k: v * 1e3 for k, v in times.items()}))
        imgs.append(img)
    counts = read_counts()
    for i, r in enumerate(rows):
        print(f"label {i}: {r['total']:.1f} ms (host voxelize "
              f"{r['voxelize']:.1f}, E2VID to the image {r['e2vid']:.1f}, "
              f"post-process {r['post']:.1f}) [{smi}]")
    per = {k: v / len(labels) for k, v in counts.items()}
    print(f"launches per reconstructed image: {per}")
    f32 = {fused: gr.build_reconstructor(weights, dev, torch.float32, fused)
           for fused in (True, False)}
    err_k3 = err_bf16 = 0.0
    for ev, img in zip(labels, imgs):
        ref, _ = gr.reconstruct_label(f32[False], *ev, 480, 640)
        got, _ = gr.reconstruct_label(f32[True], *ev, 480, 640)
        err_k3 = max(err_k3, float(np.abs(got - ref).max()))
        err_bf16 = max(err_bf16, float(np.abs(img - ref).max()))
    checks = {
        "K3 vs plain at 480x640 within 1 bf16 ulp": k3_ulps <= 1.0,
        "K3 60 per image, no other kernel": counts["K3"] == 60 * len(labels)
        and sum(counts.values()) == counts["K3"],
        "images in [0, 1], PNG uint8 [480, 640, 3]": all(
            0 <= im.min() <= im.max() <= 1 for im in imgs)
        and rgb.shape == (480, 640, 3) and rgb.dtype == np.uint8,
        f"f32 K3 vs f32 plain gates <= {RECON_F32_ABS_TOL:.0e}":
        err_k3 <= RECON_F32_ABS_TOL,
        f"bf16 K3 vs f32 plain gates <= {RECON_BF16_ABS_TOL:.0e}":
        err_bf16 <= RECON_BF16_ABS_TOL,
    }
    print(f"before quantization, max |difference| on [0, 1] images: f32 K3 "
          f"vs f32 plain {err_k3:.3e}, bf16 K3 vs f32 plain {err_bf16:.3e}")
    report_checks("O-recon-DSEC", checks)
    del recon, f32
    return counts


def report_checks(name, checks):
    print("  checks: " + ", ".join(
        f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{name}: checks failed: {checks}")


def event_text(path, rng, windows=20, per_window=30_000, height=480,
               width=640, window_s=0.05):
    """A ``t x y pol`` text stream (one header line) of ``windows`` windows
    of ``per_window`` uniform events, plus a short tail."""
    n = (windows + 1) * per_window
    t = np.sort(rng.uniform(0, (windows + 1) * window_s, n))
    x = rng.integers(0, width, n)
    y = rng.integers(0, height, n)
    p = rng.integers(0, 2, n)
    with open(path, "w") as f:
        f.write("t x y pol\n")
        f.write("".join(f"{a:.7f} {b} {c} {d}\n"
                        for a, b, c, d in zip(t, x, y, p)))
    return path


def offline_recon_file_phase(torch, smi, e2vid_path, root, zero_counts,
                             read_counts):
    """O-recon-file: ``generate_reconstructions --events_file`` at 480x640
    on a text stream written here, fixed-duration windows, auto-HDR."""
    from openess_tpu_torch import generate_reconstructions as gr

    phase("O-recon-file: generate_reconstructions --events_file at 480x640, "
          "--fixed_duration 50 ms, --auto_hdr, bf16, K3 gates")
    try:
        import pandas  # noqa: F401 (the fixed-count reader needs it)
        print("pandas imports: the fixed-count reader would run here too")
    except ImportError as e:
        print(f"pandas does not import ({e!r}): the fixed-count reader "
              "cannot run here; this phase drives the fixed-duration one")
    t0 = time.perf_counter()
    path = event_text(os.path.join(root, "events.txt"),
                      np.random.default_rng(13))
    out = os.path.join(root, "recon_file")
    print(f"stream written in {time.perf_counter() - t0:.1f} s")
    zero_counts()
    t0 = time.perf_counter()
    gr.main(["--events_file", path, "--e2vid_ckpt", e2vid_path,
             "--height", "480", "--width", "640", "--fixed_duration",
             "--window_duration", "50", "--auto_hdr", "--output_dir", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    pngs = sorted(os.listdir(out))
    from PIL import Image

    shapes = {np.asarray(Image.open(os.path.join(out, f))).shape
              for f in pngs}
    print(f"{len(pngs)} PNGs in {wall:.2f} s: {wall * 1e3 / len(pngs):.1f} ms "
          f"a window (read, voxelize, E2VID, post-process, write; the model "
          f"build included) [{smi}]; launches {counts}")
    report_checks("O-recon-file", {
        "about 20 windows": 18 <= len(pngs) <= 21,
        "PNGs 480x640 grey": shapes == {(480, 640)},
        "K3 3 per window, no other kernel": counts["K3"] == 3 * len(pngs)
        and sum(counts.values()) == counts["K3"],
    })
    return counts


def smooth_frame(rng, height, width):
    """A uint8 RGB frame of smooth random colour regions."""
    from scipy import ndimage

    img = ndimage.gaussian_filter(rng.uniform(0, 1, (height, width, 3)),
                                  (12, 12, 0))
    img = (img - img.min()) / (img.max() - img.min())
    return (img * 255).astype(np.uint8)


def write_frame_trees(root, rng):
    """A DSEC tree (two sequences of two 480x640 frames) and a DDD17 tree
    (one 260x346 frame in dir0) of ``images_aligned`` frames."""
    from PIL import Image

    for seq in ("zurich_city_00_a", "zurich_city_01_a"):
        d = os.path.join(root, "dsec", "train", seq, "images_aligned", "left")
        os.makedirs(d)
        for i in range(2):
            Image.fromarray(smooth_frame(rng, 480, 640)).save(
                os.path.join(d, f"{i:06d}.png"))
    d = os.path.join(root, "ddd17", "dir0", "images_aligned")
    os.makedirs(d)
    Image.fromarray(smooth_frame(rng, 260, 346)).save(
        os.path.join(d, "img_00000001.png"))


def run_tool(main, argv):
    """``main(argv)`` with its standard output captured and printed;
    returns ``(seconds, output)``."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    wall = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    return wall, buf.getvalue()


def offline_slic_phase(smi, root):
    """O-slic: ``generate_superpixels_slic`` and ``generate_superpixels_sam
    --backend slic`` on the DSEC (n 100; one frame of four, shard 0 of 4)
    and DDD17 (n 25) trees; no frame may fail."""
    from PIL import Image

    from openess_tpu_torch import (
        generate_superpixels_sam,
        generate_superpixels_slic,
    )

    phase("O-slic: generate_superpixels_slic and generate_superpixels_sam "
          "--backend slic, DSEC 480x640 n 100, DDD17 260x346 n 25")
    checks = {}
    for dataset, n in (("dsec", 100), ("ddd17", 25)):
        tree = os.path.join(root, dataset)
        shard = ["--shard", "0", "--num_shards", "4"] if dataset == "dsec" \
            else []
        for name, main, extra, out_dir in (
                ("slic", generate_superpixels_slic.main, [], "sp_slic_rgb"),
                ("sam --backend slic", generate_superpixels_sam.main,
                 ["--backend", "slic", "--n_segments", str(n)],
                 "sp_sam_rgb" if dataset == "dsec" else "superpixels_sam")):
            wall, out = run_tool(main, ["--dataset", dataset, "--root", tree]
                                 + shard + extra)
            written = [os.path.join(dp, f) for dp, _, fs in os.walk(tree)
                       if f"/{out_dir}" in dp for f in fs]
            ids = [int(np.asarray(Image.open(p)).max()) + 1 for p in written]
            print(f"{dataset} {name}: {len(written)} image(s), "
                  f"{wall / max(len(written), 1):.2f} s an image (host numpy) "
                  f"[{smi}]; superpixels {ids}")
            checks[f"{dataset} {name}: no FAILED line"] = "FAILED" not in out
            checks[f"{dataset} {name}: one PNG"] = len(written) == 1
    report_checks("O-slic", checks)


def write_maskclip_files(torch, root, seed=0):
    """Seeded random MaskCLIP ViT-B/16 weights in the released layouts
    (``ViT16_clip_backbone.pth`` under ``backbone.``,
    ``ViT16_clip_weights.pth`` with a ``[512, 768, 1, 1]`` projection) and
    text embeddings: the 36-entry vocabulary (``.npy``) and DDD17's 6
    classes (``.pth``)."""
    from openess_tpu_torch.models.maskclip import MaskClipViT

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = {"backbone." + k: v for k, v in MaskClipViT().state_dict().items()}
        proj = torch.randn(512, 768, 1, 1) * 768 ** -0.5
        vocab = torch.randn(36, 512)
        ddd17 = torch.randn(6, 512)
    files = {k: os.path.join(root, k) for k in (
        "ViT16_clip_backbone.pth", "ViT16_clip_weights.pth", "vocab.npy",
        "ddd17_text.pth")}
    torch.save({"state_dict": sd}, files["ViT16_clip_backbone.pth"])
    torch.save({"proj": {"weight": proj}}, files["ViT16_clip_weights.pth"])
    np.save(files["vocab.npy"], vocab.numpy())
    torch.save(ddd17, files["ddd17_text.pth"])
    return files


def offline_pl_phase(torch, dev, smi, root, files, zero_counts, read_counts):
    """O-maskclip-PL: ``generate_pseudo_labels --teacher maskclip`` on the
    DSEC tree (four 480x640 frames), ViT-B/16 at full width, 36 text rows
    remapped to 11 classes, bf16; then the extractor's logits in f32 on the
    card against the CPU, and bf16 against f32 on the card."""
    from PIL import Image

    from openess_tpu_torch import generate_pseudo_labels as gpl
    from openess_tpu_torch.models.fcclip.labeler import (
        DATASET_REMAP,
        maxpool_argmax,
    )

    phase("O-maskclip-PL: generate_pseudo_labels --teacher maskclip, DSEC "
          "480x640, ViT-B/16, 36 -> 11 classes, bf16")
    argv = ["--root", os.path.join(root, "dsec"), "--dataset", "dsec",
            "--teacher", "maskclip",
            "--clip_ckpt", files["ViT16_clip_backbone.pth"],
            "--visual_projs", files["ViT16_clip_weights.pth"],
            "--text_embeddings", files["vocab.npy"],
            "--out_name", "pl_maskclip"]
    zero_counts()
    wall, _ = run_tool(gpl.main, argv)
    torch.cuda.synchronize()
    counts = read_counts()
    pls = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(root)
                 if "/pl_maskclip" in dp for f in fs)
    labels = [np.asarray(Image.open(p)) for p in pls]
    frames = [np.asarray(Image.open(p.replace("/pl_maskclip/",
                                              "/images_aligned/")),
                         np.float32)[None] / 255.0 for p in pls]
    infer = gpl.build_maskclip_infer(argparse.Namespace(
        text_embeddings=files["vocab.npy"], dataset="dsec", num_classes=11,
        clip_ckpt=files["ViT16_clip_backbone.pth"],
        visual_projs=files["ViT16_clip_weights.pth"]), dev)
    same = all(np.array_equal(infer(f)[0], lb)
               for f, lb in zip(frames, labels))
    ms = []
    for f in frames * 3:
        t0 = time.perf_counter()
        infer(f)  # to the host: synchronized
        ms.append((time.perf_counter() - t0) * 1e3)
    del infer
    print(f"{len(pls)} pseudo-label PNGs in {wall:.2f} s (the model's build "
          f"and load included); the labeler alone {np.median(ms):.1f} ms an "
          f"image (p50 of 12: upload, ViT-B/16 at 30x40 patches, remap, "
          f"labels to the host) [{smi}]; launches {counts}")

    frame = np.asarray(Image.open(os.path.join(
        root, "dsec", "train", "zurich_city_00_a", "images_aligned", "left",
        "000000.png")), np.float32)[None] / 255.0
    text = torch.from_numpy(np.load(files["vocab.npy"]))
    logits = {}
    for name, d, dt in (("cpu_f32", torch.device("cpu"), torch.float32),
                        ("cuda_f32", dev, torch.float32),
                        ("cuda_bf16", dev, torch.bfloat16)):
        model = gpl.build_maskclip(files["ViT16_clip_backbone.pth"],
                                   files["ViT16_clip_weights.pth"], d, dt)
        with torch.no_grad():
            logits[name] = model(torch.from_numpy(frame).to(d),
                                 text.to(d)).float().cpu()
        del model
    ref = logits["cpu_f32"]
    err = float((logits["cuda_f32"] - ref).abs().max() / ref.abs().max())
    gap = float((logits["cuda_bf16"] - logits["cuda_f32"]).abs().max()
                / logits["cuda_f32"].abs().max())
    remap = DATASET_REMAP["dsec"][0]
    agree = float((maxpool_argmax(logits["cuda_bf16"], remap, 11)
                   == maxpool_argmax(logits["cuda_f32"], remap, 11))
                  .float().mean())
    print(f"logits [1, 480, 640, 36]: CUDA f32 vs CPU f32 max|diff| "
          f"{err:.3e} of max (bound {MASKCLIP_REL_TOL:.0e}); CUDA bf16 vs "
          f"f32 {gap:.3e} of max, labels equal on {agree:.4f} of the pixels")
    report_checks("O-maskclip-PL", {
        "4 PNGs, uint8 [480, 640], classes < 11": len(labels) == 4 and all(
            lb.dtype == np.uint8 and lb.shape == (480, 640) and lb.max() < 11
            for lb in labels),
        "CUDA f32 logits within the bound of the CPU's": err
        <= MASKCLIP_REL_TOL,
        "the PNGs are the labeler's": same,
        "no kernel launched": sum(counts.values()) == 0,
    })
    return counts


def offline_eval_phase(torch, dev, smi, root, files, zero_counts,
                       read_counts):
    """O-eval-af: ``eval_annotation_free --teacher maskclip`` on a DDD17
    tree written here (its validation recording, dir1: 5 frames, one batch
    of 8 with 3 rows padded), 6 classes, the frames as the source."""
    from openess_tpu_torch import eval_annotation_free as ev

    phase("O-eval-af: eval_annotation_free --teacher maskclip, DDD17 "
          "200x352 frames, 6 classes, bf16")
    tree = os.path.join(root, "ddd17_eval")
    write_ddd17_tree(tree, np.random.default_rng(14), need=40_000,
                     images=5, gap=5_000)
    s = ddd17_probe_settings(
        dataset_path_b=tree, nr_events_window_b=2000,
        maskclip_checkpoint=files["ViT16_clip_backbone.pth"],
        visual_projs_path=files["ViT16_clip_weights.pth"],
        text_embeddings_path=files["ddd17_text.pth"])
    zero_counts()
    t0 = time.perf_counter()
    infer = ev.build_maskclip_infer(s, dev)
    t1 = time.perf_counter()
    out = ev.evaluate(s, infer, "frame", dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    print({k: round(float(v), 2) for k, v in out.items() if k != "cm"})
    scored = int(out["cm"].sum())
    print(f"model built in {t1 - t0:.2f} s; 1 batch of {s.batch_size_b} in "
          f"{wall:.2f} s (read, ViT-B/16, confusion) [{smi}]; {scored} "
          f"pixels scored; launches {counts}")
    report_checks("O-eval-af", {
        "5 frames scored once, the padded rows not": 0 < scored
        <= 5 * 200 * 352,
        "miou and acc in [0, 100]": 0 <= out["miou"] <= 100
        and 0 <= out["acc"] <= 100,
    })
    return counts


def raw_wire_loader_phase(torch, dev, smi, windows):
    """L-raw-wire: the flagship raw-wire batches (B = 2 of the eight
    samples' T = 20 windows of 100 000 events) assembled by three
    ``PrefetchLoader`` workers, each packing with the C++ packer's recycled
    buffers (``wire_reuse_ok`` on a card) and uploading on its own stream,
    against the same indices assembled in line: every key of every batch
    equal, over ``RAW_LOADER_EPOCHS`` shuffled epochs. Each epoch starts
    with the host library's binding undone, so that the three workers are
    its first callers, as in ``tests/test_torch_gpu.py``'s raw-wire loader
    case (concurrent first calls once rebound ``argtypes`` under a running
    call)."""
    from openess_tpu_torch import native
    from openess_tpu_torch.data.device_voxelize import wire_reuse_ok
    from openess_tpu_torch.data.dsec import event_batch
    from openess_tpu_torch.data.pipeline import PrefetchLoader, batch_indices
    from openess_tpu_torch.training.trainer import to_device

    phase("L-raw-wire: PrefetchLoader, 3 workers, DSEC raw-wire batches "
          "(B = 2, T = 20, 100k events) with the packer's recycled buffers, "
          "against in-line assembly")
    s = flagship_settings(wire_format="raw_events", num_cpu_workers=1)

    class Windows:
        def __len__(self):
            return len(windows)

        def get_batch(self, idx):
            out = event_batch(s, [windows[i] for i in idx], dev)
            out["label"] = np.asarray(idx, np.int64)
            return out

    data = Windows()
    t0 = time.perf_counter()
    n = bad = 0
    diffs = []
    for epoch in range(RAW_LOADER_EPOCHS):
        native._LIBRARY = None  # no worker is running: nothing is calling it
        loader = PrefetchLoader(
            data, 2, shuffle=True, rng=np.random.default_rng(epoch),
            device=dev, put_fn=lambda b: to_device(b, dev), num_workers=3)
        plan = batch_indices(len(data), 2, shuffle=True,
                             rng=np.random.default_rng(epoch),
                             drop_last=True, pad_last=False)
        got = [{k: v.clone() for k, v in b.items()} for b in loader]
        for (idx, _), batch in zip(plan, got):
            ref = to_device(data.get_batch(idx), dev)
            n += 1
            keys_ok = sorted(batch) == sorted(ref)
            wrong = [k for k in ref if not (k in batch and batch[k].shape
                                            == ref[k].shape
                                            and torch.equal(batch[k], ref[k]))]
            if wrong or not keys_ok:
                bad += 1
                diffs.append((epoch, list(idx), wrong))
    wall = time.perf_counter() - t0
    print(f"{n} batches compared over {RAW_LOADER_EPOCHS} epochs in "
          f"{wall:.1f} s [{smi}]; batches with a key unequal: {bad} "
          f"{diffs[:4]}")
    report_checks("L-raw-wire", {
        "the packer hands out recycled buffers on the card":
        wire_reuse_ok(dev),
        "every batch delivered": n == RAW_LOADER_EPOCHS * (len(windows) // 2),
        "every key of every batch equal to the in-line one": bad == 0,
    })


def clip_merges(n=48894):
    """A synthetic CLIP merges file's lines: merges that rebuild the VILD
    templates' words first, then distinct filler pairs of CJK characters,
    ``n`` in all."""
    out, seen = [], set()
    for word in ("photo", "there", "this", "scene", "small", "medium",
                 "large", "the", "is", "in", "of"):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pair = (parts[0], parts[1])
            if pair not in seen:
                seen.add(pair)
                out.append(" ".join(pair))
            parts = [parts[0] + parts[1]] + parts[2:]
    i = 0
    while len(out) < n:
        out.append(f"{chr(0x4E00 + i // 160)} {chr(0x3400 + i % 160)}")
        i += 1
    return out


def write_fcclip_files(torch, root, seed=0):
    """A seeded random FC-CLIP checkpoint in the released layout (the
    port's modules at the released width with torch's seeded init, under
    the released names, ``{"model": ...}`` with ``criterion.empty_weight``)
    and a synthetic merges file: ``{"ckpt", "bpe", "sd"}``."""
    import gzip

    from openess_tpu_torch.models.fcclip import CLIPTextEncoder, FCCLIP

    t0 = time.perf_counter()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model, text = FCCLIP(), CLIPTextEncoder()
    sd = dict(model.state_dict())
    sd.update({"backbone.clip_model." + k: v
               for k, v in text.state_dict().items()})
    sd["criterion.empty_weight"] = torch.ones(134)
    del model, text
    files = {"ckpt": os.path.join(root, "fcclip_cocopan.pth"),
             "bpe": os.path.join(root, "bpe_simple_vocab_16e6.txt.gz"),
             "sd": sd}
    torch.save({"model": sd}, files["ckpt"])
    with gzip.open(files["bpe"], "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: synthetic"] + clip_merges()))
    n = sum(v.numel() for v in sd.values())
    print(f"FC-CLIP file: {len(sd)} tensors, {n / 1e6:.1f} M values, "
          f"{os.path.getsize(files['ckpt']) / 2 ** 30:.2f} GiB, written in "
          f"{time.perf_counter() - t0:.1f} s")
    return files


def fcclip_frames(root, rng):
    """Four 200x352 DDD17 frames (``images_aligned`` of ``ddd17_fc/dir0``,
    smooth random colour), the working resolution of DDD17's frames."""
    from PIL import Image

    d = os.path.join(root, "ddd17_fc", "dir0", "images_aligned")
    os.makedirs(d)
    for i in range(4):
        Image.fromarray(smooth_frame(rng, 200, 352)).save(
            os.path.join(d, f"img_{i + 1:08d}.png"))
    return os.path.join(root, "ddd17_fc")


def offline_fcclip_pl_phase(torch, dev, smi, root, fc, zero_counts,
                            read_counts):
    """O-fcclip-PL: ``generate_pseudo_labels --teacher fcclip`` on four
    DSEC frames (480x640) and four DDD17 frames (200x352, padded to
    224x352), bf16; the PNGs against the labeler's own labels; then the
    parts of one image timed apart (CUDA events, warm), the peak memory and
    the image path's FLOPs."""
    from PIL import Image

    from openess_tpu_torch import generate_pseudo_labels as gpl
    from openess_tpu_torch.models.fcclip import (
        DSEC_USER_CLASSES,
        load_fcclip,
        maxpool_argmax,
        prepare_class_names,
    )
    from openess_tpu_torch.models.fcclip.labeler import (
        DATASET_REMAP,
        pad_to_32,
        text_classifier,
    )
    from openess_tpu_torch.models.fcclip.tokenizer import SimpleTokenizer
    from openess_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    from openess_tpu_torch.utils.flops import count_flops, peak_bf16_flops

    phase("O-fcclip-PL: generate_pseudo_labels --teacher fcclip, FC-CLIP "
          "convnext_large_d_320 at the released width, DSEC 480x640 and "
          "DDD17 200x352, bf16")
    ddd17 = fcclip_frames(root, np.random.default_rng(16))
    trees = {"dsec": os.path.join(root, "dsec"), "ddd17": ddd17}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    walls, pngs = {}, {}
    for dataset, tree in trees.items():
        walls[dataset], _ = run_tool(gpl.main, [
            "--root", tree, "--dataset", dataset, "--teacher", "fcclip",
            "--fcclip_ckpt", fc["ckpt"], "--bpe_vocab", fc["bpe"],
            "--out_name", "pl_fcclip"])
        pngs[dataset] = sorted(os.path.join(dp, f)
                               for dp, _, fs in os.walk(tree)
                               if "/pl_fcclip" in dp for f in fs)
    torch.cuda.synchronize()
    counts = read_counts()
    tool_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for dataset in trees:
        print(f"{dataset}: {len(pngs[dataset])} PNGs in {walls[dataset]:.1f} "
              f"s (the file's load and validation, the classifier and the "
              f"model's build included) [{smi}]")

    t0 = time.perf_counter()
    model, text = load_fcclip(fc["ckpt"], dev, torch.bfloat16)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    overlap, nt, prompts = prepare_class_names(DSEC_USER_CLASSES)
    nt = tuple(nt)
    tokens = SimpleTokenizer(fc["bpe"])(prompts)
    t0 = time.perf_counter()
    tc = text_classifier(text, tokens)
    torch.cuda.synchronize()
    t_text = time.perf_counter() - t0
    text_ms = cuda_ms(torch, lambda: text_classifier(text, tokens),
                      torch.empty(256 << 20, dtype=torch.uint8, device=dev),
                      iters=5, warmup=1)
    del text
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def labels(path, remap, k):
        # the tool's arithmetic: the PNG in [0, 1], the labeler's * 255
        img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
        x = torch.from_numpy(img[None]).to(dev)
        with torch.no_grad():
            sem = model(pad_to_32(x * 255.0), tc, nt, overlap)
        return maxpool_argmax(sem[:, :img.shape[0], :img.shape[1]], remap,
                              k)[0].cpu().numpy()

    agree = {}
    for dataset, paths in pngs.items():
        remap, k = DATASET_REMAP[dataset]
        agree[dataset] = min(
            float((np.asarray(Image.open(p)) == labels(p.replace(
                "/pl_fcclip/", "/images_aligned/"), remap, k)).mean())
            for p in paths)

    frame = np.asarray(Image.open(pngs["dsec"][0].replace(
        "/pl_fcclip/", "/images_aligned/")).convert("RGB"), np.float32)
    x = pad_to_32(torch.from_numpy(frame[None]).to(dev))
    tcv = model.classifier(tc)
    head = model.sem_seg_head
    parts = {}
    with torch.no_grad():
        feats = model.encode_image(x)
        mf, ms = head.pixel_decoder(feats)
        out = head.predictor(ms, mf, tcv, nt)
        parts["trunk"] = cuda_ms(torch, lambda: model.encode_image(x), flush,
                                 iters=10)
        parts["pixel decoder"] = cuda_ms(
            torch, lambda: head.pixel_decoder(feats), flush, iters=10)
        shapes = [(f.shape[1], f.shape[2]) for f in ms]
        lin = sum(h * w for h, w in shapes)
        g = torch.Generator(device=dev).manual_seed(0)
        value = torch.randn(1, lin, 8, 32, device=dev, generator=g,
                            dtype=torch.bfloat16)
        loc = torch.rand(1, lin, 8, 3, 4, 2, device=dev, generator=g)
        w = torch.softmax(torch.rand(1, lin, 8, 12, device=dev, generator=g),
                          -1).reshape(1, lin, 8, 3, 4)
        sampling = cuda_ms(torch, lambda: ms_deform_attn(value, shapes, loc, w),
                           flush, iters=10)
        n_enc = len(head.pixel_decoder.transformer.encoder.layers)
        parts["transformer decoder"] = cuda_ms(
            torch, lambda: head.predictor(ms, mf, tcv, nt), flush, iters=10)
        remap = DATASET_REMAP["dsec"][0]
        parts["post-processing"] = cuda_ms(
            torch, lambda: maxpool_argmax(model.semantic_inference(
                feats, out, tcv, nt, overlap, (480, 640)), remap, 11),
            flush, iters=10)
        parts["whole image (pad to labels)"] = cuda_ms(
            torch, lambda: maxpool_argmax(model(x, tc, nt, overlap), remap,
                                          11), flush, iters=10)
        xd = pad_to_32(torch.rand(1, 200, 352, 3, device=dev) * 255)
        ddd17_ms = cuda_ms(torch, lambda: maxpool_argmax(
            model(xd, tc, nt, overlap)[:, :200], DATASET_REMAP["ddd17"][0],
            6), flush, iters=10)
        flops, _ = count_flops(lambda: model(x, tc, nt, overlap))
        trunk_flops, _ = count_flops(lambda: model.encode_image(x))
        avg, prof_wall, _ = device_profile(torch, lambda: [maxpool_argmax(
            model(x, tc, nt, overlap), remap, 11) for _ in range(3)])
    print("the whole 480x640 image under the profiler, 3 images:")
    print_profile(avg, prof_wall, 3, "image", smi)
    print(f"device kernels and copies per image: "
          f"{sum(e.count for e in avg) / 3:.0f}")
    whole = parts["whole image (pad to labels)"]
    peak = peak_bf16_flops(torch.cuda.get_device_name(0))
    print(f"file load and validation {t_load:.2f} s; the 504-prompt "
          f"classifier {t_text:.2f} s the first time, {text_ms:.1f} ms warm "
          f"(2 chunks of 256) [{smi}]")
    print("one 480x640 DSEC image, bf16, ms (CUDA events, median of 10): "
          + "; ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + f"; the deformable sampling alone {sampling:.3f} a call x "
          f"{n_enc} layers; one 200x352 DDD17 image {ddd17_ms:.2f} [{smi}]")
    print(f"FLOPs of one 480x640 image (FlopCounterMode: convolutions and "
          f"matrix products): {flops / 1e12:.3f} TFLOP, the trunk "
          f"{trunk_flops / 1e12:.3f}; {flops / whole / 1e9:.1f} TFLOP/s "
          f"({flops / whole * 1e3 / peak:.1%} of the bf16 peak); peak memory "
          f"{tool_peak:.2f} GiB in the tool, "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB in all; "
          f"launches {counts}; PNGs equal to the labeler's labels on "
          f"{agree} of the pixels")
    shapes_ok = all(
        np.asarray(Image.open(p)).shape == size and np.asarray(
            Image.open(p)).dtype == np.uint8 and np.asarray(
            Image.open(p)).max() < k
        for dataset, size, k in (("dsec", (480, 640), 11),
                                 ("ddd17", (200, 352), 6))
        for p in pngs[dataset])
    report_checks("O-fcclip-PL", {
        "4 DSEC and 4 DDD17 PNGs": len(pngs["dsec"]) == 4
        and len(pngs["ddd17"]) == 4,
        "uint8 at the frames' size, classes of the dataset": shapes_ok,
        "the classifier [36, 768] finite": tuple(tc.shape) == (36, 768)
        and bool(torch.isfinite(tc).all()),
        "the PNGs are the labeler's (>= 0.999 of the pixels)":
        min(agree.values()) >= 0.999,
        "no kernel of the port launched": sum(counts.values()) == 0,
    })
    del model, feats, mf, ms, out, value, loc, w, flush
    torch.cuda.empty_cache()
    return counts


def fcclip_f32_phase(torch, dev, smi, root, fc):
    """FC-CLIP in f32: the full-width image path on one 480x640 DSEC frame
    on the card (TF32 off) against the CPU, both given the same 504-prompt
    text classifier (made on the card: the text tower over 504 prompts is
    slow on the CPU); the text tower on one class's 14 prompts the same
    way; and the bf16 labels on the card against the f32 ones."""
    from PIL import Image

    from openess_tpu_torch.models.fcclip import (
        DSEC_USER_CLASSES,
        build_fcclip,
        convert_fcclip_checkpoint,
        maxpool_argmax,
        prepare_class_names,
    )
    from openess_tpu_torch.models.fcclip.labeler import (
        DATASET_REMAP,
        pad_to_32,
        text_classifier,
    )
    from openess_tpu_torch.models.fcclip.tokenizer import SimpleTokenizer

    phase("FC-CLIP f32: the image path at full width on one 480x640 frame, "
          "CUDA (TF32 off) vs CPU; the text tower on 14 prompts; bf16 vs f32 "
          "labels")
    t0 = time.perf_counter()
    image_sd, text_sd = convert_fcclip_checkpoint(fc["ckpt"])
    cpu = torch.device("cpu")
    models = {d.type: build_fcclip(image_sd, text_sd, d, torch.float32)
              for d in (cpu, dev)}
    tok = SimpleTokenizer(fc["bpe"])
    overlap, nt, prompts = prepare_class_names(DSEC_USER_CLASSES)
    nt = tuple(nt)
    one = tok(prepare_class_names(("car",))[2])
    with torch.no_grad():
        t_cpu = models["cpu"][1](torch.from_numpy(one))
        t_gpu = models["cuda"][1](torch.from_numpy(one).to(dev)).cpu()
    text_err = float((t_gpu - t_cpu).abs().max() / t_cpu.abs().max())
    tc = text_classifier(models["cuda"][1], tok(prompts))
    frame = np.asarray(Image.open(os.path.join(
        root, "dsec", "train", "zurich_city_00_a", "images_aligned", "left",
        "000000.png")).convert("RGB"), np.float32)
    x = pad_to_32(torch.from_numpy(frame[None]))
    with torch.no_grad():
        t1 = time.perf_counter()
        ref = models["cpu"][0](x, tc.cpu(), nt, overlap)
        t_ref = time.perf_counter() - t1
        got = models["cuda"][0](x.to(dev), tc, nt, overlap).cpu()
    err = float((got - ref).abs().max() / ref.abs().max())
    del models
    half = build_fcclip(image_sd, text_sd, dev, torch.bfloat16)[0]
    with torch.no_grad():
        sem16 = half(x.to(dev), tc, nt, overlap).cpu()
    del half, image_sd, text_sd
    torch.cuda.empty_cache()
    remap = DATASET_REMAP["dsec"][0]
    agree = float((maxpool_argmax(sem16, remap, 11)
                   == maxpool_argmax(got, remap, 11)).float().mean())
    gap = float((sem16 - got).abs().max() / got.abs().max())
    print(f"class scores [1, 480, 640, 36]: CUDA f32 vs CPU f32 max|diff| "
          f"{err:.3e} of max (bound {FCCLIP_REL_TOL:.0e}; the CPU took "
          f"{t_ref:.1f} s); text tower on 14 prompts {text_err:.3e} of max; "
          f"CUDA bf16 vs f32 {gap:.3e} of max, labels equal on {agree:.4f} "
          f"of the pixels; phase {time.perf_counter() - t0:.1f} s [{smi}]")
    report_checks("FC-CLIP f32", {
        "CUDA f32 class scores within the bound of the CPU's": err
        <= FCCLIP_REL_TOL,
        "CUDA f32 text embeddings within the bound of the CPU's": text_err
        <= FCCLIP_REL_TOL,
        "finite": bool(torch.isfinite(got).all() and torch.isfinite(
            sem16).all()),
    })


def offline_eval_fcclip_phase(torch, dev, smi, root, fc, zero_counts,
                              read_counts):
    """O-eval-af-fcclip: ``eval_annotation_free``'s FC-CLIP scoring of the
    DDD17 validation recording O-eval-af wrote (5 frames, one batch of 8
    with 3 rows padded), 6 classes, the frames as the source, bf16."""
    from openess_tpu_torch import eval_annotation_free as ev

    phase("O-eval-af-fcclip: eval_annotation_free --teacher fcclip, DDD17 "
          "200x352 frames, 6 classes, bf16")
    s = ddd17_probe_settings(dataset_path_b=os.path.join(root, "ddd17_eval"),
                             nr_events_window_b=2000)
    zero_counts()
    t0 = time.perf_counter()
    infer = ev.build_fcclip_infer(s, fc["ckpt"], fc["bpe"], dev)
    t1 = time.perf_counter()
    out = ev.evaluate(s, infer, "frame", dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = read_counts()
    del infer
    print({k: round(float(v), 2) for k, v in out.items() if k != "cm"})
    scored = int(out["cm"].sum())
    print(f"labeler built in {t1 - t0:.2f} s (load, validation, the "
          f"504-prompt classifier); 1 batch of {s.batch_size_b} in "
          f"{wall:.2f} s (read, FC-CLIP, confusion) [{smi}]; {scored} pixels "
          f"scored; launches {counts}")
    report_checks("O-eval-af-fcclip", {
        "5 frames scored once, the padded rows not": 0 < scored
        <= 5 * 200 * 352,
        "miou and acc in [0, 100]": 0 <= out["miou"] <= 100
        and 0 <= out["acc"] <= 100,
    })
    return counts


def preflight_phase(torch, smi, root, fc):
    """``python -m openess_tpu_torch.preflight --fcclip --bpe`` on the
    files (PASS, exit 0), then ``--fcclip`` on a copy with one shape wrong
    (FAIL naming the key, exit 1), each in its own process."""
    phase("preflight: python -m openess_tpu_torch.preflight --fcclip --bpe, "
          "then a copy with one shape wrong")
    key = "sem_seg_head.predictor.query_embed.weight"
    bad = os.path.join(root, "fcclip_wrong.pth")
    sd = dict(fc["sd"])
    sd[key] = torch.zeros(251, 256)
    torch.save({"model": sd}, bad)
    del sd
    runs = {}
    for name, argv in (("released layout", ["--fcclip", fc["ckpt"], "--bpe",
                                            fc["bpe"]]),
                       ("one shape wrong", ["--fcclip", bad])):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "openess_tpu_torch.preflight",
                            *argv], capture_output=True, text=True, cwd=ROOT,
                           timeout=600)
        runs[name] = r
        print(f"{name}: exit {r.returncode} in {time.perf_counter() - t0:.1f}"
              f" s [{smi}]\n{r.stdout.strip()}")
        if r.returncode not in (0, 1):
            print(r.stderr[-3000:])
    os.remove(bad)
    good, wrong = runs["released layout"], runs["one shape wrong"]
    report_checks("preflight", {
        "PASS on the files, exit 0": good.returncode == 0
        and "PASS  fcclip" in good.stdout and "PASS  bpe_vocab" in good.stdout,
        "FAIL naming the key on the wrong copy, exit 1": wrong.returncode == 1
        and "FAIL  fcclip" in wrong.stdout and key in wrong.stdout,
    })


def mfu_probe_phase(torch, smi, zero_counts, read_counts):
    """P-mfu-probe: ``python -m openess_tpu_torch.mfu_ledger_probe`` on the
    flagship YAML, in this process so that its launches are counted."""
    from openess_tpu_torch import mfu_ledger_probe
    from openess_tpu_torch.utils.flops import peak_bf16_flops

    peak = peak_bf16_flops(torch.cuda.get_device_name(0))
    phase("P-mfu-probe: openess_tpu_torch.mfu_ledger_probe, flagship "
          "pretrain frame2voxel at full width, bf16, K3 gates")
    torch.cuda.empty_cache()
    zero_counts()
    t0 = time.perf_counter()
    out = mfu_ledger_probe.main([])
    counts = read_counts()
    print(f"probe ran {time.perf_counter() - t0:.1f} s [{smi}]; launches "
          f"{counts}")
    for fold in (True, False):
        tf = out[f"teacher_flops_fold_{fold}"]
        ms = out[f"teacher_fwd_ms_fold_{fold}"]
        gb = out[f"teacher_bytes_fold_{fold}"] / 1e9
        print(f"fold_bn={fold}: teacher fwd {ms:.2f} ms, {tf / 1e12:.3f} "
              f"TFLOP -> {tf / ms / 1e9:.1f} TFLOP/s ({tf / ms * 1e3 / peak:.1%} "
              f"of the bf16 peak); operator bytes {gb:.2f} GB -> "
              f"{gb / ms * 1e3:.0f} GB/s [{smi}]")
    report_checks("P-mfu-probe", {
        "every key": len(out) == 12,
        "K1, K2 and K3 in the step, no K3 backward": counts["K1"] > 0
        and counts["K2"] > 0 and counts["K3"] > 0 and counts["K3_bwd"] == 0,
        "residual > 0": all(out[f"bwd_opt_residual_ms_fold_{f}"] > 0
                            for f in (True, False)),
    })
    return counts


# ------------------------------------------------------------------------
# Data parallelism (the fourteenth slice): D1-nccl and the D2 phases. Each
# rank is this script run with ``--dp-rank DIR`` under torchrun's
# environment (a free localhost port); its jobs are in DIR/spec.json and
# its results go to DIR/rank<r>.pt. The one-process references run here.


def launch_counters():
    """The seven kernel wrappers, whose ``launches`` count their
    launches."""
    from openess_tpu_torch.ops import lstm_gates as k3
    from openess_tpu_torch.ops import segment_pool as k2
    from openess_tpu_torch.ops import voxelize_chunked as k1
    from openess_tpu_torch.ops import voxelize_mxu as k56

    return {"K1": k1.voxelize_chunked_trilinear, "K2": k2.segment_pool_sums,
            "K3": k3.fused_lstm_gates, "K3_bwd": k3.fused_lstm_gates_bwd,
            "K4": k1.voxelize_chunked_bilinear_t,
            "K5": k56.voxelize_windows_trilinear_mxu,
            "K6": k56.voxelize_windows_bilinear_t_mxu}


class RowsDataset:
    """``n`` samples over the rows of one host batch: sample ``i`` is row
    ``i % B``, so a rank that assembles only its rows gets them."""

    def __init__(self, host_batch, n):
        self.host_batch = host_batch
        self.rows = host_batch["label"].shape[0]
        self.n = n

    def __len__(self):
        return self.n

    def get_batch(self, idx):
        rows = np.asarray(idx) % self.rows
        return {k: v[rows] for k, v in self.host_batch.items()}


def dp_settings(job):
    """A D job's settings: the flagship pretrain YAML's, T8-pretrain-recon's
    or F8's (as ``frame2voxel``), K3 gates on, the job's overrides, its
    global batch."""
    make = {"pretrain": flagship_settings, "recon": recon_pretrain_settings,
            "finetune": finetune_settings}[job["settings"]]
    return make(e2vid_fused_gates=True, batch_size_b=job["batch"],
                save_checkpoint=False, **job.get("overrides", {}))


def dp_host_batch(s, job):
    """The job's global host batch, the same on every rank (seeded)."""
    if job["settings"] == "recon":
        return recon_batch(s, batch=job["batch"])
    host, _ = flagship_batch(flagship_settings(), batch=job["batch"])
    if job["settings"] == "finetune":  # the pseudo-labels as labels
        host = {k: v for k, v in host.items() if k.startswith("ev_")} | {
            "label": host["pl"]}
    return host


def host_copy(torch, t):
    """An f32 copy of ``t`` on the host (a copy even where ``t`` is one)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def whole_copy(torch, mset):
    """``copy(name, t)``: :func:`host_copy` of the parameter ``name``'s
    tensor or gradient ``t``, gathered whole over the model group where the
    parameter is a sharded weight (a collective: every rank calls it, in
    one order)."""
    from openess_tpu_torch.parallel import tp

    sharded = tp.sharded_params(mset.modules)

    def copy(name, t):
        shard = sharded.get(name)
        if shard is not None:
            t = tp.gather_full(t.detach(), shard[1])
        return host_copy(torch, t)

    return copy


def loader_batch(torch, host, mesh, dev):
    """The job's global host batch through the trainer's loader
    (``PrefetchLoader`` over a ``RowsDataset``, uploaded as ``Trainer``
    uploads): under ``mesh`` this rank assembles and uploads its rows."""
    from openess_tpu_torch.data.pipeline import PrefetchLoader
    from openess_tpu_torch.training.trainer import to_device

    rows = host["label"].shape[0]
    (batch,) = PrefetchLoader(
        RowsDataset(host, rows), rows, shuffle=False,
        put_fn=lambda b: to_device(b, dev), device=dev, mesh=mesh)
    return batch


def release(torch):
    """Give the card back what this process no longer references (cyclic
    garbage collected first, so that a finished run's model set goes too):
    ranks launched beside it share the card. Returns the GiB it still
    holds."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2 ** 30


def ckpt_written(job):
    """The marker rank 0 writes once the job's checkpoint is whole."""
    return job["ckpt_dir"] + ".written"


def dp_steps(torch, job, mesh, dev):
    """``1 + DP_STEPS`` train steps of a pretrain job on its global batch
    (this rank's rows under ``mesh``): the losses, the trainable gradients
    and the BatchNorm running statistics after step 1, the trainable
    parameters after the last step, the timed steps' ms (CUDA events) and
    the launches; under a mesh also the gradient all-reduce's ms, a
    checkpoint (``ckpt_dir``) and the idle share of two profiled steps."""
    from openess_tpu_torch.parallel import all_reduce_gradients
    from openess_tpu_torch.parallel import spatial, tp
    from openess_tpu_torch.training import checkpoint as ckpt
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder

    s = dp_settings(job)
    host = dp_host_batch(s, job)
    steps = job.get("steps", DP_STEPS)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    mset = build_models(s, seed=0, device=dev)
    if s.compute_dtype == "float32":
        small_residual_scales(mset)
    if mesh is not None:  # replicate, and shard under a model axis
        tp.shard_params_tp(mset.modules, mesh)
    opt = make_optimizer(s, mset)
    sb = StepBuilder(s, mset, opt, steps_per_epoch=1 + steps, mesh=mesh)
    batch = loader_batch(torch, host, mesh, dev)
    named = [(f"{n}.{k}", p) for n, m in mset.modules.items()
             for k, p in m.named_parameters()]
    whole = whole_copy(torch, mset)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    tp.reset_traffic()
    spatial.reset_traffic()
    tp_axis = mesh is not None and mesh.model > 1
    losses, events, grads, stats1 = [], [], {}, {}
    for i in range(1 + steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if tp_axis and i == steps:  # the last step's exchanges timed apart
            moved = dict(tp.traffic), dict(spatial.traffic)
            tp.traffic["timed"] = spatial.traffic["timed"] = True
            t0 = time.perf_counter()
        a.record()
        losses.append(sb.train_step(batch, 0))
        b.record()
        events.append((a, b))
        if i == 0:
            grads = {k: whole(k, p.grad) for k, p in named
                     if p.grad is not None}
            stats1 = {f"{n}.{k}": host_copy(torch, v)
                      for n, m in mset.modules.items()
                      for k, v in m.named_buffers()
                      if k.endswith(("running_mean", "running_var"))
                      and mset.roles[n] == "deeplab"}
    torch.cuda.synchronize()
    if tp_axis:
        tp.traffic["timed"] = spatial.traffic["timed"] = False
        timed_ms = (time.perf_counter() - t0) * 1e3
        exchange_ms = (tp.traffic["seconds"]
                       + spatial.traffic["seconds"]) * 1e3
        # the steps' bytes counted once, the last step's seconds kept
        tp.traffic.update(moved[0])
        spatial.traffic.update(moved[1])
    out = dict(
        model=1 if mesh is None else mesh.model, batch=job["batch"],
        losses=[{k: float(v) for k, v in h.items()} for h in losses],
        ms=[a.elapsed_time(b) for a, b in events[1:]],
        counts={k: fn.launches for k, fn in counters.items()},
        grads=grads, stats1=stats1,
        params={k: whole(k, p) for k, p in named if p.grad is not None},
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        rows=int(batch["frame"].shape[0]),
        gather_mb=tp.traffic["gather_bytes"] / steps / 1e6,
        reduce_mb=tp.traffic["reduce_bytes"] / steps / 1e6,
        sync_mb=tp.traffic["sync_bytes"] / steps / 1e6,
        halo_mb=spatial.traffic["halo_bytes"] / steps / 1e6,
        band_sum_mb=spatial.traffic["reduce_bytes"] / steps / 1e6,
        spatial=mesh is not None and mesh.bands is not None,
        sharded_mb=sum(p.numel() * p.element_size() for p, _ in
                       tp.sharded_params(mset.modules).values()) / 1e6,
        params_mb=sum(p.numel() * p.element_size()
                      for _, p in named) / 1e6)
    if mesh is None:
        return out
    if tp_axis:
        out.update(timed_step_ms=timed_ms, exchange_ms=exchange_ms)
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        all_reduce_gradients(named, mesh.pixel_group)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    out["allreduce_ms"] = float(np.median(times))
    out["allreduce_mb"] = sum(p.grad.numel() * p.grad.element_size()
                              for _, p in named if p.grad is not None) / 1e6
    if job.get("ckpt_dir"):
        ckpt.save_checkpoint(job["ckpt_dir"], mset, opt, sb.step, 0,
                             mesh=mesh)
        if mesh.rank == 0:  # the file is whole: the fine-tunes may start
            open(ckpt_written(job), "w").close()
        out["saved"] = {k: whole(k, p) for k, p in named}
    if job.get("profile"):  # two steps; one under a model axis (seconds)
        avg, wall, _ = device_profile(
            torch, lambda: [sb.train_step(batch, 0)
                            for _ in range(1 if tp_axis else 2)])
        busy = sum(e.self_device_time_total for e in avg) / 1e3
        out["idle"] = 1 - busy / (wall * 1e3) if busy > 0 else None
    return out


def dp_finetune(torch, job, mesh, dev):
    """F8's fine-tune with ``unfrozen_e2vid`` from ``job['ckpt_dir']``
    through ``Trainer``: a padded ``val_epoch`` (``job['val']`` samples),
    then an epoch of ``job['steps']`` steps (``DP_STEPS`` by default; each
    rank assembling its rows; none at 0, a job that only validates), then
    the timed steps on a resident batch (one under a model axis; none where
    ``job['timed']`` is false). With
    ``job['vis']`` the ``val_epoch`` writes its dumps to that directory
    (``_ranks`` or ``_one`` appended)."""
    from openess_tpu_torch.parallel import spatial, tp
    from openess_tpu_torch.training.trainer import Trainer

    s = dp_settings(job)
    if job.get("vis"):
        vis = job["vis"] + ("_one" if mesh is None else "_ranks")
        os.makedirs(vis, exist_ok=True)
        s = dataclasses.replace(s, vis_dir=vis)
    host = dp_host_batch(s, job)
    release(torch)
    torch.cuda.reset_peak_memory_stats()
    B = job["batch"]
    steps = job.get("steps", DP_STEPS)
    trainer = Trainer(s, RowsDataset(host, B * steps),
                      RowsDataset(host, job["val"]), seed=0, device=dev,
                      mesh=mesh)
    summary = trainer.val_epoch()
    # the logits in one process only: its bf16 run against its f32 one
    val = (val_labels(torch, trainer, logits=mesh is None)
           if job.get("labels") else None)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    tp.reset_traffic()
    spatial.reset_traffic()
    t0 = time.perf_counter()
    epoch = trainer.train_epoch()
    torch.cuda.synchronize()
    per = max(steps, 1)
    epoch_ms = (time.perf_counter() - t0) * 1e3 / per
    traffic = dict(tp.traffic)
    halo = spatial.traffic["halo_bytes"]
    counts = {k: fn.launches for k, fn in counters.items()}
    named = [(f"{n}.{k}", p) for n, m in trainer.mset.modules.items()
             for k, p in m.named_parameters() if p.requires_grad]
    whole = whole_copy(torch, trainer.mset)
    params = {k: whole(k, p) for k, p in named if p.grad is not None}
    batch = loader_batch(torch, host, mesh, dev)
    events = []
    # one resident step under a model axis, whose exchanges take seconds;
    # none for a job that only checks (``timed`` false)
    timed = job.get("timed", True)
    for _ in range((1 if mesh is not None and mesh.model > 1 else steps)
                   if timed else 0):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        trainer.sb.train_step(batch, 0)
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return dict(cm=summary["cm"], val=val, epoch=epoch, epoch_ms=epoch_ms,
                counts=counts, params=params,
                ms=[a.elapsed_time(b) for a, b in events],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                gather_mb=traffic["gather_bytes"] / per / 1e6,
                reduce_mb=traffic["reduce_bytes"] / per / 1e6,
                sync_mb=traffic["sync_bytes"] / per / 1e6,
                halo_mb=halo / per / 1e6,
                sharded_mb=sum(p.numel() * p.element_size() for p, _ in
                               tp.sharded_params(
                                   trainer.mset.modules).values()) / 1e6)


def dp_f64_step(torch, job, dev):
    """Step 1 of an f32 D job (its global batch, seed and draws, one
    process) with every module, its compute dtype and the step's f32
    arithmetic (``Tensor.float()``: the losses, the norms) in f64 on the
    card: the step that the f32 runs of the ranks and of the one process
    both round. Returns its losses and trainable gradients on the host. K3's
    gates and K2's pooling run their plain versions here (the kernels take
    bf16 and f32); K1's f32 grid is cast to f64 as the step casts it."""
    from openess_tpu_torch.ops import segment_pool as k2
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder

    f64, to_f32 = torch.float64, torch.Tensor.float
    s = dp_settings(job)
    host = dp_host_batch(s, job)
    release(torch)
    mset = build_models(s, seed=0, device=dev)
    small_residual_scales(mset)
    for m in mset.modules.values():
        m.double()
        for sub in m.modules():
            if isinstance(getattr(sub, "dtype", None), torch.dtype):
                sub.dtype = f64
            if hasattr(sub, "fused_gates"):
                sub.fused_gates = False
    mset.dtype = f64
    sb = StepBuilder(s, mset, make_optimizer(s, mset),
                     steps_per_epoch=1 + DP_STEPS)
    batch = loader_batch(torch, host, None, dev)
    kernel = k2.segment_pool_sums
    k2.segment_pool_sums = k2.segment_pool_sums_plain
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == f64 else to_f32(t, *a, **k))
    try:
        losses = sb.train_step(batch, 0)
    finally:
        torch.Tensor.float = to_f32
        k2.segment_pool_sums = kernel
    grads = {f"{n}.{k}": p.grad.detach().cpu()
             for n, m in mset.modules.items()
             for k, p in m.named_parameters() if p.grad is not None}
    if any(g.dtype != f64 for g in grads.values()):
        raise AssertionError("the f64 step left a gradient below f64")
    del mset, sb, batch
    release(torch)
    return dict(losses=[{k: float(v) for k, v in losses.items()}],
                grads=grads)


def dp_val_confusion(torch, job, dev, batch):
    """``val_epoch``'s confusion through ``Trainer`` in one process at
    batch size ``batch``, over the D-finetune job's samples and weights,
    and its near ties: the valid pixels whose top two logits (bf16) are
    equal or one bf16 step apart, whose label any other rounding of the
    forward may flip."""
    from openess_tpu_torch.training.trainer import Trainer

    s = dp_settings(dict(job, batch=batch))
    host = dp_host_batch(s, job)
    trainer = Trainer(s, RowsDataset(host, batch),
                      RowsDataset(host, job["val"]), seed=0, device=dev)
    cm = trainer.val_epoch()["cm"]
    ties = int((val_labels(torch, trainer)["margin"] <= 1).sum())
    del trainer
    release(torch)
    return cm, ties


def val_labels(torch, trainer, logits=False):
    """Per pixel of ``trainer.val_epoch``'s rows (padded rows left out), on
    the host: ``labels`` (int16), ``counted`` (what the confusion counts:
    not the ignore label), ``gap``, the top logit less the second (f32 of
    the compute dtype's values), and ``margin``, that gap in bf16 steps of
    the top logit: at most 1 is a near tie, whose label any other rounding
    of the forward may flip; with ``logits``, the logits too (f32)."""
    from openess_tpu_torch.parallel.spatial import gather_bands

    eps = torch.finfo(torch.bfloat16).eps
    ignore = trainer.s.semseg_ignore_label
    bands = trainer.mesh.bands
    out = {"labels": [], "counted": [], "gap": [], "margin": []}
    if logits:
        out["logits"] = []
    with torch.no_grad():
        for b in trainer._batches(trainer.val_data, False):
            z = trainer.sb._predict(b)[0].float()
            if bands is not None:  # each image whole, from its bands
                z = gather_bands(z, bands, 1)
                b = dict(b, label=gather_bands(b["label"], bands, 1))
            top = z.topk(2, dim=-1).values
            gap = top[..., 0] - top[..., 1]
            step = (eps * top[..., 0].abs()).clamp_min(
                torch.finfo(torch.float32).tiny)
            valid = b["valid"]
            for k, v in (("labels", z.argmax(dim=-1).short()),
                         ("counted", b["label"] != ignore),
                         ("gap", gap), ("margin", gap / step),
                         ("logits", z)):
                if k in out:
                    out[k].append(v[valid].cpu())
    return {k: torch.cat(v) for k, v in out.items()}


def label_moves(torch, one, one32, labels):
    """The fine-tunes' per-pixel rule for bf16 ``val_epoch`` labels.
    ``one`` and ``one32``: one process's :func:`val_labels` with logits,
    in bf16 and in f32 (TF32 off); ``labels``: each parallel run's bf16
    labels over the same pixels. At a pixel where one process's bf16
    logits lie within e of its f32 ones (the bf16 forward's own error
    there) and a run's bf16 logits round no farther, the two bf16 runs lie
    within 2e of each other, and a label between them can move where one
    process's top-two gap is within 4e; the runs' distance from the f32
    labels, against one process's, checks that they round no farther. The
    near ties (one bf16 step) and the gaps within 2e are read too. Returns
    the counts, each the largest over ``labels``, and the text that prints
    them."""
    c = one["counted"]
    err = (one["logits"] - one32["logits"]).abs().amax(dim=-1)
    loose = one["gap"] <= 4 * err
    half = one["gap"] <= 2 * err
    tie = one["margin"] <= 1
    moved = [(lab != one["labels"]) & c for lab in labels]

    def most(mask):
        return max(int((m & mask).sum()) for m in moved)

    gaps = torch.cat([one["margin"][m] for m in moved])
    m = dict(ties=int((tie & c).sum()), on_tie=most(tie),
             off_tie=most(~tie), within=most(loose), beyond=most(~loose),
             beyond_half=most(~half), n_loose=int((loose & c).sum()),
             to_f32=int(((one["labels"] != one32["labels"]) & c).sum()),
             ranks_f32=max(int(((lab != one32["labels"]) & c).sum())
                           for lab in labels),
             widest=f"{float(gaps.max()):.2f}" if gaps.numel() else "none")
    m["text"] = (
        f"per pixel, a rank's labels apart from one process's: on its near "
        f"ties (top two bf16 logits equal or one step apart, {m['ties']}) "
        f"{m['on_tie']}, elsewhere {m['off_tie']}, the widest one-process "
        f"gap under a moved label {m['widest']} bf16 steps; where the gap "
        f"is within 4e, e the bf16 logits' largest distance there from f32 "
        f"({m['n_loose']} pixels), {m['within']}, beyond it {m['beyond']} "
        f"(bound {DP_LABEL_FLIPS:g} of the pixels; beyond 2e "
        f"{m['beyond_half']}); bf16 labels apart from one process's f32 "
        f"labels: one process {m['to_f32']}, the ranks {m['ranks_f32']} "
        f"(bound {DP_F64_FACTOR}x)")
    return m


def label_checks(m, same_pixels, pixels):
    """The checks of :func:`label_moves`'s counts ``m``."""
    return {
        "bf16 val_epoch labels apart only within the bf16 error":
        same_pixels and m["beyond"] <= DP_LABEL_FLIPS * pixels,
        "bf16 labels no farther from f32 than one process's":
        m["ranks_f32"] <= DP_F64_FACTOR * m["to_f32"],
    }


DP_JOBS = {"steps": dp_steps, "trainer": dp_finetune}


@contextlib.contextmanager
def cache_weight_draws():
    """While the block runs, ``training/build.init_weights`` remembers what
    it drew: a module of a class, with conv parameters of names and shapes
    and a generator state seen before in the block gets the same conv
    weights and biases again, copied (nothing else of the module is
    touched), and the generator the state the draw left. So every later
    build of a model set in the block is the first one's, exactly, without
    the seconds of drawing a ResNet-50 on the host. The port's own
    ``init_weights`` is back after the block."""
    import torch

    from openess_tpu_torch.training import build

    draw, seen = build.init_weights, {}

    def drawn(module):  # what init_weights draws (and zeroes), in order
        return [(f"{n}.{k}", t) for n, m in module.named_modules()
                if isinstance(m, torch.nn.Conv2d | torch.nn.ConvTranspose2d)
                for k, t in (("weight", m.weight), ("bias", m.bias))
                if t is not None]

    def init_weights(module, generator):
        key = (type(module).__qualname__,
               generator.get_state().numpy().tobytes(),
               tuple((k, tuple(t.shape)) for k, t in drawn(module)))
        if key not in seen:
            draw(module, generator)
            seen[key] = ([t.detach().clone() for _, t in drawn(module)],
                         generator.get_state())
        tensors, after = seen[key]
        with torch.no_grad():
            for (_, t), v in zip(drawn(module), tensors):
                t.copy_(v)
        generator.set_state(after)

    build.init_weights = init_weights
    try:
        yield
    finally:
        build.init_weights = draw


def dp_rank_main(out_dir):
    """A rank's entry (``python3 chip_smoke.py --dp-rank DIR``): joins the
    group torchrun's environment describes with the spec's backend and runs
    the spec's jobs, each in the modes it lists (``group``: this rank's
    rows under the mesh; ``none``: the whole batch with no group)."""
    import torch

    sys.path.insert(0, ROOT)
    from openess_tpu_torch.parallel import make_mesh, maybe_init_distributed

    with open(os.path.join(out_dir, "spec.json")) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_init_distributed(spec["backend"])
    try:
        mesh = make_mesh(-1, spec.get("model", 1),
                         spatial=spec.get("spatial", False))
        results = []
        with cache_weight_draws():
            for job in spec["jobs"]:
                results.append([
                    DP_JOBS[job["kind"]](torch, job,
                                         mesh if mode == "group" else None,
                                         mesh.device)
                    for mode in job.get("modes", ("group",))])
        torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


RANK_RUNS = []  # the launches under way: stopped if the script fails


def dp_start(world, backend, jobs, out_dir, model=1, spatial=False):
    """Start ``jobs`` on ``world`` ranks of this script (torchrun's
    environment, a free localhost port, ``backend``) on a mesh of ``model``
    model ranks a data index (splitting image rows with ``spatial``), in
    the background: this process goes on while they run, and
    :func:`dp_wait` collects them."""
    import socket

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "spec.json"), "w") as f:
        json.dump(dict(backend=backend, jobs=jobs, model=model,
                       spatial=spatial), f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    run = dict(out_dir=out_dir, procs=[], logs=[], t0=time.perf_counter(),
               deadline=time.monotonic() + DP_RANK_TIMEOUT_S)
    RANK_RUNS.append(run)
    for r in range(world):
        env = dict(os.environ, WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        run["logs"].append(open(os.path.join(out_dir, f"rank{r}.log"), "w+"))
        run["procs"].append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank",
             out_dir], env=env, stdout=run["logs"][-1],
            stderr=subprocess.STDOUT))
    return run


def dp_stop(run):
    """Stop the ranks of ``run`` still running and close their logs."""
    for p in run["procs"]:
        if p.poll() is None:
            p.kill()
            p.wait()
    for log in run["logs"]:
        log.close()
    if run in RANK_RUNS:
        RANK_RUNS.remove(run)


def dp_wait(torch, run):
    """The results of :func:`dp_start`'s ranks, each rank's list. A rank
    that fails, or outlives ``DP_RANK_TIMEOUT_S`` from its start, fails the
    phase: every rank is stopped and their output printed. Sets
    ``run['seconds']``, from the start to the last rank's end."""
    procs, logs = run["procs"], run["logs"]
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, run["deadline"] - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        run["seconds"] = time.perf_counter() - run["t0"]
        bad = [(r, p.poll()) for r, p in enumerate(procs) if p.poll() != 0]
        if bad:
            for r, log in enumerate(logs):
                log.seek(0)
                print(f"-- rank {r} output (tail):\n{log.read()[-4000:]}")
    finally:
        dp_stop(run)
    if bad:
        raise AssertionError(f"ranks failed (rank, exit code; None: still "
                             f"running at the deadline): {bad}")
    return [torch.load(os.path.join(run["out_dir"], f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def dp_launch(torch, world, backend, jobs, out_dir, model=1, spatial=False):
    """:func:`dp_start` and :func:`dp_wait`: each rank's results."""
    return dp_wait(torch, dp_start(world, backend, jobs, out_dir, model,
                                   spatial))


def dp_ready(torch, path, run):
    """Wait for the file ``path`` that a rank of ``run`` writes (a
    checkpoint's marker): fails if the ranks end without it or pass their
    deadline first."""
    while not os.path.exists(path):
        if time.monotonic() > run["deadline"] or any(
                p.poll() is not None for p in run["procs"]):
            if not os.path.exists(path):
                dp_wait(torch, run)  # a failed rank's output, and raises
                raise AssertionError(f"the ranks ended without {path}")
        time.sleep(0.2)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def rel_l2(got, ref):
    """Relative L2 error of the tensors ``got`` against ``ref``, all
    together (same names)."""
    if sorted(got) != sorted(ref):
        raise AssertionError("different tensors to compare")
    num = sum(float((got[k].double() - ref[k].double()).square().sum())
              for k in ref)
    den = sum(float(ref[k].double().square().sum()) for k in ref)
    return (num / den) ** 0.5 if den > 0 else num ** 0.5


def max_loss_rel(got, ref, steps=None):
    """The largest relative loss error over the steps (or the first
    ``steps``) and the loss keys."""
    return max(rel(g[k], r[k]) for g, r in list(zip(got, ref))[:steps]
               for k in r)


def bitwise(torch, a, b):
    """Whether two runs' losses and parameters are equal bit for bit. The
    ranks of a model axis compute the replicated loss each on its own, so
    their losses round apart where a kernel's atomics do (K1, K2, a conv's
    backward), and only their parameters are compared. Those are gathered
    whole on every rank, and the replicated ones take model rank 0's
    gradients (``sync_replicated_gradients``), so between two ranks of one
    model group the check shows only that the gathers and the broadcast
    ran; between two data indexes (DM4) it holds each shard's replicas,
    updated apart, to each other. Agreement with one process is the f32
    checks' to show."""
    same_losses = a["losses"] == b["losses"] or a.get("model", 1) > 1
    return same_losses and sorted(a["params"]) == sorted(
        b["params"]) and all(torch.equal(a["params"][k], b["params"][k])
                             for k in b["params"])


def max_abs_param_diff(a, b):
    return max(float((a["params"][k] - b["params"][k]).abs().max())
               for k in b["params"])


DP_F32_JOB = dict(kind="steps", settings="pretrain", batch=DP_F32_BATCH,
                  steps=1, overrides=dict(compute_dtype="float32"))


def dp_f32_errors(torch, rank_results, refs, exact, grad_bound):
    """D2's f32 check of the ranks against two one-process runs (``refs``)
    and the f64 step (``exact``, :func:`dp_f64_step`) of the same global
    batch, on step 1's losses and gradients. Tensors whose f64 gradient is
    zero to rounding (at most ``DP_ZERO_GRAD`` of the whole gradient's
    norm: biases that an instance norm cancels) are left out; every other
    gradient is compared:

    - ``exact``: on the tensors where both one-process runs are within
      ``DP_F32_GRAD_L2`` (relative L2) of the f64 step, the ranks against
      the one process, relative L2 all together (bound ``DP_F32_GRAD_L2``);
    - ``grad``: on all of them, the same (bound ``grad_bound``, the job's);
    - ``f64_ranks`` against ``f64_one``: the ranks' distance from the f64
      step against the one process's (the farther of its two runs), bound
      ``DP_F64_FACTOR`` times it: the ranks round no worse than one
      process does.

    Also step 1's losses (bound ``DP_F32_LOSS_REL``), the one-process
    step's own spread (its second run against its first) and whether the
    ranks' parameters after the steps are bitwise equal."""
    g64 = exact["grads"]
    total = sum(float(v.square().sum()) for v in g64.values()) ** 0.5
    live = [k for k, v in g64.items() if float(v.norm()) > DP_ZERO_GRAD * total]
    close = [k for k in live
             if all(rel_l2({k: r["grads"][k]}, {k: g64[k]}) <= DP_F32_GRAD_L2
                    for r in refs)]
    ref = refs[0]

    def sub(g, keys):
        return {k: g[k] for k in keys}

    def worst(runs, want, keys):
        return max(rel_l2(sub(r["grads"], keys), sub(want, keys))
                   for r in runs)

    out = dict(
        loss=max(max_loss_rel(r["losses"], ref["losses"], 1)
                 for r in rank_results),
        loss64=max(max_loss_rel(r["losses"], exact["losses"], 1)
                   for r in rank_results + refs),
        zero=len(g64) - len(live), tensors=len(live), close=len(close),
        close_share=(sum(float(g64[k].square().sum()) for k in close)
                     / total ** 2) ** 0.5,
        exact=worst(rank_results, ref["grads"], close),
        grad=worst(rank_results, ref["grads"], live),
        spread=worst(refs[1:], ref["grads"], live),
        f64_ranks=worst(rank_results, g64, live),
        f64_one=worst(refs, g64, live),
        equal=all(bitwise(torch, r, rank_results[0])
                  for r in rank_results[1:]))
    out["ok"] = (out["loss"] <= DP_F32_LOSS_REL and out["equal"]
                 and close and out["exact"] <= DP_F32_GRAD_L2
                 and out["grad"] <= grad_bound
                 and out["f64_ranks"] <= DP_F64_FACTOR * out["f64_one"])
    return out


# D1-nccl's one rank: the flagship pretrain step at B = 8 with no group,
# with the one-rank NCCL group, and with no group again
D1_JOB = dict(kind="steps", settings="pretrain", batch=8,
              modes=["none", "group", "none"])


def d1_nccl_report(torch, smi, ranks, seconds):
    """D1-nccl: one rank over NCCL against the one-process step (no
    group), in one process (:data:`D1_JOB`; the one-process step run again
    gives its own repeatability). Returns the group run's launches."""
    phase("D1-nccl: one rank over NCCL vs the one-process step (flagship "
          "pretrain frame2voxel at full width, B = 8, bf16, augmentation "
          f"on; 1 warm-up + {DP_STEPS} steps)")
    print(f"the rank ran {seconds:.1f} s, beside the M2 and SP2 ranks")
    (res,) = ranks  # one rank, one job, three runs
    none, group, again = res[0]
    same = bitwise(torch, group, none)
    repeatable = bitwise(torch, again, none)
    d_group = max_abs_param_diff(group, none)
    d_again = max_abs_param_diff(again, none)
    print(f"losses per step, no group: {none['losses']}")
    l_group = max_loss_rel(group["losses"], none["losses"])
    l_again = max_loss_rel(again["losses"], none["losses"])
    print(f"one-rank NCCL group bitwise equal to no group (losses and "
          f"parameters after {1 + DP_STEPS} steps): {same}; max|param diff| "
          f"{d_group:.3e}, max loss rel {l_group:.3e}")
    print(f"no group run twice bitwise equal: {repeatable}; max|param "
          f"diff| {d_again:.3e}, max loss rel {l_again:.3e}")
    p50 = {k: float(np.median(r["ms"])) for k, r in
           (("none", none), ("group", group))}
    print(f"step p50 (CUDA events, {DP_STEPS} steps): no group "
          f"{p50['none']:.1f} ms, one NCCL rank {p50['group']:.1f} ms; "
          f"peak {group['peak_gib']:.2f} GiB; on {smi}")
    counts = group["counts"]
    n = 1 + DP_STEPS
    report_checks("D1-nccl", {
        # bit for bit wherever the step itself repeats bit for bit;
        # otherwise no further apart than two runs of it
        "equal to the one-process step": same if repeatable
        else d_group <= DP_NONDET_FACTOR * d_again,
        "every loss finite": all(np.isfinite(v) for h in group["losses"]
                                 for v in h.values()),
        f"K1 {n}, K3 {60 * n}, K2 {2 * n}": counts["K1"] == n
        and counts["K3"] == 60 * n and counts["K2"] == 2 * n,
    })
    return counts


def steps_report(torch, name, bf16, f32, refs, refs32, exact, grad_bound,
                 expect, stats, label):
    """A D or M phase's checks and numbers: the ranks' bf16 runs (``bf16``)
    against the one-process ones (``refs``; a second one gives the step's
    own spread), the f32 runs against two one-process ones and the f64
    step (:func:`dp_f32_errors`), the launches a rank and step
    (``expect``), the running statistics (``stats``). Returns the launches
    summed over the ranks."""
    got, ref = bf16[0], refs[0]

    def per_step(runs, want):
        return [max(rel(r["losses"][i][k], want["losses"][i][k])
                    for r in runs for k in want["losses"][i])
                for i in range(len(want["losses"]))]

    steps = per_step(bf16, ref)
    spread = per_step(refs[1:], ref) if refs[1:] else []
    params = max(rel_l2(r["params"], ref["params"]) for r in bf16)
    own = (f"{rel_l2(refs[1]['params'], ref['params']):.3e}" if refs[1:]
           else "not run")
    print(f"bf16: losses, rank 0 {got['losses']}")
    print("bf16: loss rel vs one process per step " + " ".join(
        f"{v:.3e}" for v in steps) + f" (step 1 bound "
        f"{DP_BF16_LOSS_REL:g}; the later steps follow trajectories "
        f"that part: one process against itself " + " ".join(
            f"{v:.3e}" for v in spread) + f"); parameters after "
        f"{len(ref['losses'])} steps rel L2 {params:.3e} (one process "
        f"against itself {own})")
    for r, res in enumerate(bf16):
        tp_part = "" if "exchange_ms" not in res else (
            f", gathered {res['gather_mb']:.1f} MB, summed "
            f"{res['reduce_mb']:.1f} MB and took "
            f"{res['sync_mb']:.1f} MB of replicated gradients "
            f"(train/tp_sync) a step over the model group "
            f"(timed step {res['timed_step_ms']:.1f} ms, of it "
            f"{res['exchange_ms']:.1f} ms in those exchanges), sharded "
            f"parameters {res['sharded_mb']:.1f} of {res['params_mb']:.1f} "
            f"MB")
        if res.get("spatial"):
            tp_part = (
                f", received {res['halo_mb']:.2f} MB of halo rows and "
                f"{res['band_sum_mb']:.3f} MB of image sums a step over "
                f"the model group (timed step {res['timed_step_ms']:.1f} "
                f"ms, of it {res['exchange_ms']:.1f} ms in those "
                f"exchanges)")
        idle = ("not profiled" if "idle" not in res
                else f"{res['idle']:.3f}")
        print(f"rank {r}: {res['rows']} rows, step p50 "
              f"{np.median(res['ms']):.1f} ms, gradient all-reduce "
              f"{res['allreduce_ms']:.2f} ms ({res['allreduce_mb']:.1f} "
              f"MB f32){tp_part}, idle share {idle}, peak "
              f"{res['peak_gib']:.2f} GiB; launches {res['counts']}")
    print(f"one process (B = {ref['rows']}): step p50 "
          f"{np.median(ref['ms']):.1f} ms, peak {ref['peak_gib']:.2f} GiB; "
          f"{label}")
    e = dp_f32_errors(torch, f32, refs32, exact, grad_bound)
    print(f"f32 (TF32 off, global B = {f32[0]['batch']}): step 1 loss rel "
          f"{e['loss']:.3e} (bound {DP_F32_LOSS_REL:g}), every f32 run "
          f"against the f64 step {e['loss64']:.3e}; gradients after "
          f"step 1, relative L2, {e['zero']} tensors zero to rounding in "
          f"f64 left out: where both one-process runs are within "
          f"{DP_F32_GRAD_L2:g} of f64 ({e['close']} of {e['tensors']} "
          f"tensors, {e['close_share']:.3f} of the norm) the ranks "
          f"against one process {e['exact']:.3e} (bound "
          f"{DP_F32_GRAD_L2:g}); all {e['tensors']}: the ranks against "
          f"one process {e['grad']:.3e} (bound {grad_bound:g}), one "
          f"process against itself {e['spread']:.3e}; against the f64 "
          f"step the ranks {e['f64_ranks']:.3e}, one process "
          f"{e['f64_one']:.3e} (bound {DP_F64_FACTOR}x that); ranks "
          f"bitwise equal {e['equal']}")
    checks = {
        "bf16 step-1 losses": steps[0] <= DP_BF16_LOSS_REL,
        "bf16 ranks bitwise equal": all(
            bitwise(torch, r, got) for r in bf16[1:]),
        "every loss finite": all(np.isfinite(v) for r in bf16
                                 for h in r["losses"]
                                 for v in h.values()),
        "f32 losses, gradients, ranks equal": e["ok"],
    }
    n = len(got["losses"])
    for k, v in expect.items():
        checks[f"{k} {v} per rank and step"] = all(
            r["counts"][k] == v * n for r in bf16)
    for tag, runs, want, bound, *held_out in stats:
        held_out = held_out[0] if held_out else ()
        errs = {k: max(float((r["stats1"][k] - v).abs().max()
                             / v.abs().max().clamp_min(1e-12)) for r in runs)
                for k, v in want["stats1"].items()}
        err, worst = max((e, k) for k, e in errs.items()
                         if k not in held_out)
        same = all(torch.equal(r["stats1"][k], runs[0]["stats1"][k])
                   for r in runs[1:] for k in want["stats1"])
        apart = "".join(f"; held out of the bound: {k} {errs[k]:.3e}"
                        for k in held_out)
        print(f"{tag}: BatchNorm running statistics after step 1 vs one "
              f"process, max |diff| of each tensor's max {err:.3e} "
              f"({worst}; bound {bound:g}){apart}; equal on both ranks "
              f"{same}")
        checks[f"{tag} running statistics"] = err <= bound and same
    report_checks(name, checks)
    return {k: sum(r["counts"][k] for r in bf16) for k in got["counts"]}


def d2_phases(torch, dev, smi, out_root):
    """D2-pretrain, D2-pretrain-recon and D2-finetune: two gloo ranks on
    the one card, global B = 8 (4 a rank), against the one-process runs
    on the same seed and draws, run here: the pretrain and recon jobs'
    while the ranks run, the fine-tunes' and the f64 steps after them. The
    ranks run every job in one launch (the fine-tune starts from
    D2-pretrain's rank 0 checkpoint; its val_epoch runs again in f32,
    without a step). Returns each phase's launches, summed over the ranks,
    and the f32 pretrain job's one-process runs and f64 step."""
    ckpt_dir = os.path.join(out_root, "d2_ckpt")
    # D2_STEPS bf16 steps after the warm-up on the recon job and the
    # fine-tune (DP_STEPS before the M phases); the pretrain job keeps
    # DP_STEPS: its checkpoint is the fine-tune's start, whose bf16 near
    # ties (85 after 1 + 3 steps, ~4 000 after 1 + 2) set how many
    # labels can flip
    jobs = [
        dict(kind="steps", settings="pretrain", batch=8, ckpt_dir=ckpt_dir,
             profile=True),
        DP_F32_JOB,
        dict(kind="steps", settings="recon", batch=8, profile=True,
             steps=D2_STEPS),
        dict(DP_F32_JOB, settings="recon"),
        dict(kind="trainer", settings="finetune", batch=8, val=6,
             steps=D2_STEPS, labels=True,
             overrides=dict(pretrained_file=ckpt_dir)),
        # the same val_epoch in f32 (TF32 off), no step: the labels the
        # bf16 ones are held against per pixel
        dict(kind="trainer", settings="finetune", batch=8, val=6, steps=0,
             timed=False, labels=True,
             overrides=dict(pretrained_file=ckpt_dir,
                            compute_dtype="float32")),
    ]
    phase("D2: two gloo ranks on the one card (global B = 8, 4 a rank): "
          "D2-pretrain, D2-pretrain-recon, D2-finetune, each rank a "
          "process of this script; the pretrain and recon jobs' "
          "one-process runs in this process beside them")
    print(f"this process holds {release(torch):.2f} GiB of the card")
    t0 = time.perf_counter()
    run = dp_start(2, "gloo", jobs, os.path.join(out_root, "d2"))
    # every pretrain and recon job twice (the one-process step's own
    # spread) while the ranks run; the fine-tunes, which start from the
    # ranks' checkpoint, and the f64 steps (the most memory) after them
    refs = {i: [dp_steps(torch, j, None, dev) for _ in range(2)]
            for i, j in enumerate(jobs) if j["kind"] == "steps"}
    print(f"the pretrain and recon jobs' one-process runs done in "
          f"{time.perf_counter() - t0:.1f} s")
    ranks = dp_wait(torch, run)
    print(f"ranks done in {run['seconds']:.1f} s (every job); the "
          "fine-tunes' one-process runs follow")
    t0 = time.perf_counter()
    refs = [refs[i] if i in refs else [dp_finetune(torch, j, None, dev)]
            for i, j in enumerate(jobs)]
    print(f"references done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the witnesses: the f64 step of each f32 job, and the fine-tune's
    # val_epoch in one process again, at its batch and at a rank's
    exact = {i: dp_f64_step(torch, j, dev) for i, j in enumerate(jobs)
             if j["kind"] == "steps"
             and j.get("overrides", {}).get("compute_dtype") == "float32"}
    val_batches = (jobs[4]["batch"], jobs[4]["batch"] // 2)
    cms, ties = {}, {}
    for b in val_batches:
        cms[b], ties[b] = dp_val_confusion(torch, jobs[4], dev, b)
    print(f"witnesses done in {time.perf_counter() - t0:.1f} s")
    per = [[r[i][0] for r in ranks] for i in range(len(jobs))]
    launches = {}
    label = ("host-staged gloo on one card shared by both ranks (and by "
             "the one-process pretrain and recon steps), not a multi-card "
             f"figure; on {smi}")

    phase("D2-pretrain: flagship pretrain frame2voxel at full width, bf16, "
          "augmentation on, K1/K3/K2 on each rank")
    none = dict.fromkeys(("K1", "K2", "K3", "K3_bwd", "K4", "K5", "K6"), 0)
    launches["d2_pretrain"] = steps_report(
        torch, "D2-pretrain", per[0], per[1], refs[0], refs[1], exact[1],
        DP_EVENT_F32_GRAD_L2, none | {"K1": 1, "K3": 60, "K2": 2}, [],
        label)
    phase("D2-pretrain-recon: T8-pretrain-recon's frame2recon at full "
          "width (synced train-mode BatchNorm, K2 on f32 and bf16 "
          "features)")
    launches["d2_pretrain_recon"] = steps_report(
        torch, "D2-pretrain-recon", per[2], per[3], refs[2], refs[3], exact[3],
        DP_RECON_F32_GRAD_L2, none | {"K2": 2},
        [("bf16", per[2], refs[2][0], DP_BF16_STATS_REL),
         ("f32", per[3], refs[3][0], DP_F32_STATS_REL)], label)

    phase("D2-finetune: F8's fine-tune with unfrozen_e2vid from D2-pretrain's "
          "rank 0 checkpoint, through Trainer on both ranks; its val_epoch "
          "in bf16 and in f32 (TF32 off)")
    ft, (ref,) = per[4], refs[4]
    ft32, (ref32,) = per[5], refs[5]
    pixels = int(ref["cm"].sum())
    counted = all(r["cm"].sum() == pixels for r in ft + ft32)

    def apart(a, b):  # pixels labelled otherwise
        return int(np.abs(a - b).sum()) // 2

    flips = max(apart(r["cm"], ref["cm"]) for r in ft)
    flips32 = max(apart(r["cm"], ref32["cm"]) for r in ft32)
    # per pixel, as the M and SP phases hold theirs: the ranks' bf16
    # labels, each rank its rows (rank order is the global batch's)
    one = ref["val"]
    moves = label_moves(torch, one, ref32["val"], [torch.cat(
        [r["val"]["labels"] for r in ft])])
    same_pixels = all(torch.equal(v, one["counted"]) for v in (
        ref32["val"]["counted"],
        torch.cat([r["val"]["counted"] for r in ft]),
        torch.cat([r["val"]["counted"] for r in ft32])))
    loss = max(rel(r["epoch"][k], v) for r in ft
               for k, v in ref["epoch"].items())
    for r, res in enumerate(ft):
        print(f"rank {r}: Trainer.train_epoch {res['epoch_ms']:.1f} ms a "
              f"step (host clock, its rows assembled and uploaded), step "
              f"p50 {np.median(res['ms']):.1f} ms (CUDA events), peak "
              f"{res['peak_gib']:.2f} GiB; launches {res['counts']}")
    print(f"one process (B = 8): train_epoch {ref['epoch_ms']:.1f} ms a "
          f"step, step p50 {np.median(ref['ms']):.1f} ms; {label}")
    big, small = val_batches
    print(f"val_epoch over 6 samples (the batch padded to {big}; rank 1 "
          f"holds 2 valid rows): pixels counted {pixels} on every side: "
          f"{counted}; f32 (TF32 off): labelled otherwise than by one "
          f"process {flips32} (bound {DP_LABEL_FLIPS:g} of the pixels); "
          f"bf16: labelled otherwise by the ranks' summed confusion "
          f"{flips}; without ranks, one process run again at B = {big} "
          f"{apart(cms[big], ref['cm'])} and at B = {small} (a rank's "
          f"batch, the same rows) {apart(cms[small], ref['cm'])}; the ranks "
          f"against that B = {small} run "
          f"{max(apart(r['cm'], cms[small]) for r in ft)}; near ties (top "
          f"two bf16 logits equal or one step apart) at B = {big} "
          f"{ties[big]}, at B = {small} {ties[small]}; {moves['text']}; "
          f"epoch losses max rel {loss:.3e}")
    n = D2_STEPS
    report_checks("D2-finetune", {
        # the padding masked exactly; the f32 labels one process's but
        # where f32 rounding ties; the bf16 labels by the per-pixel rule
        "f32 val_epoch confusion": counted
        and flips32 <= DP_LABEL_FLIPS * pixels,
        **label_checks(moves, same_pixels, pixels),
        "epoch losses": loss <= DP_BF16_LOSS_REL,
        "ranks bitwise equal": all(
            torch.equal(r["params"][k], ft[0]["params"][k])
            for r in ft[1:] for k in ft[0]["params"]),
        f"K1 {n}, K3 {60 * n}, K3 backward {60 * n} per rank": all(
            r["counts"]["K1"] == n and r["counts"]["K3"] == 60 * n
            and r["counts"]["K3_bwd"] == 60 * n for r in ft),
    })
    launches["d2_finetune"] = {k: sum(r["counts"][k] for r in ft)
                               for k in ft[0]["counts"]}
    # the f32 pretrain job's one-process runs and f64 step, which DM4's
    # f32 check (the same job) reads too
    return launches, dict(refs=refs[1], exact=exact[1])


# ------------------------------------------------------------------------
# Channel tensor parallelism: the M phases. The ranks
# are gloo processes of this script sharing the one card (two NCCL ranks
# cannot share it), so every gather and sum over the model group is staged
# through the host: the sharded step's semantics on the card, not a
# scaling figure.

TP_BATCH = 2                # global batch of the M2 phases (each rank both
                            # rows)
TP_DM4_BATCH = 4            # ... of DM4 (2 rows a data shard)
TP_F32_STEPS = 1            # f32 checks: steps after step 1 (step 2's loss)
TP_LOSS2_REL = 1e-2         # ... step 2's losses, ranks vs one process
TP_BF16_STEPS = 1           # the M and SP phases' bf16 recon steps after
                            # the warm-up (cut from 3 to make room for the
                            # SP phases)
TP_DM4_BF16_STEPS = 1       # DM4's and DSP4's ... (cut from 2)
TP_FINETUNE_STEPS = 1       # the M2 and SP2 fine-tunes' bf16 epoch (steps;
                            # cut from 2)
# SP2-pretrain-recon bf16: the running statistic held out of
# DP_BF16_STATS_REL (printed; held in f32 with the rest). The ASPP
# projection's BatchNorm mean: its input holds the image-pool branch, a
# BatchNorm over the 2 images' 1x1 maps, whose output is +-1 and flips
# where the two bf16 values nearly tie, and the bands' image means round
# otherwise than one process's (6.482e-2 in each of five runs on one
# seed; M2's channel split of the same job 2.945e-2; f32 2.294e-5)
SP_BF16_TIES = ("model_recon.classifier.ASPP.project.1.running_mean",)
K3_TP_SHAPES = ((220, 320, 32), (110, 160, 64), (55, 80, 128))  # C/2
# a model rank's band of E2VID's levels under spatial partitioning (M = 2
# at 440x640: rank 1's, the larger of the 55-row level's 27 and 28 rows)
K3_BAND_SHAPES = ((110, 320, 64), (55, 160, 128), (28, 80, 256))


def k3_tp_phase(torch, k3, dev, flush, shapes=K3_TP_SHAPES, key="tp_c_half",
                what="C/2 (a model rank's per-gate slice under channel TP, "
                     "M = 2, B = 2 at 440x640)"):
    """K3's forward and backward at the shapes a model rank of the M2 and
    DM4 phases gives them: its ``C/2`` channels of each gate at B = 2 on the
    440x640 levels (or, with ``shapes``, a rank's band of the levels under
    spatial partitioning), bf16 and f32, against their plain versions (the
    forward to one bf16 ulp + ``K3_ABS_SLACK``, the backward as
    :func:`k3_bwd_error`), each bf16 time beside its bound and PyTorch's
    fused LSTM cell's. Returns the forward's and the backward's numbers
    for their kernel rows, each key ending in ``key``."""
    phase(f"K3 at {what} vs plain, forward and backward")
    gen = torch.Generator(device=dev).manual_seed(1515)
    B = TP_BATCH
    # kernel, plain, bound, library
    sums = {"fwd": np.zeros(4), "bwd": np.zeros(4)}
    errs = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        size = 2 if bf16 else 4
        for h, w, c in shapes:
            gates = (torch.randn((B, h, w, 4 * c), generator=gen, device=dev)
                     * 2).to(dtype)
            pc, dh, dcn = (torch.randn((B, h, w, c), generator=gen,
                                       device=dev).to(dtype)
                           for _ in range(3))
            if bf16:
                err, ulps = k3_fwd_check(torch, k3, gates, pc)
            else:
                err, ulps = k3_bwd_error(
                    torch, k3.fused_lstm_gates(gates, pc),
                    k3.fused_lstm_gates_plain(gates, pc), False)
            berr, bulps = k3_bwd_error(
                torch, k3.fused_lstm_gates_bwd(gates, pc, dh, dcn),
                k3.fused_lstm_gates_bwd_plain(gates, pc, dh, dcn), bf16)
            n = B * h * w
            line = (f"K3 [{str(dtype).split('.')[-1]} {B}x{h}x{w}x{c}] "
                    f"fwd max|kernel-plain| {err:.3e} = {ulps:.3f} of the "
                    f"bound, bwd {berr:.3e} = {bulps:.3f}")
            if bf16:
                lib_f, _ = k3_library_fwd(torch, gates, pc)
                try:  # as in the B = 8 phase, the cell's backward may refuse
                    lib_b, _ = k3_library_bwd(torch, gates, pc, dh, dcn)
                except (RuntimeError, AttributeError, TypeError) as e:
                    lib_b = None
                    print(f"  library backward not driven on this data: "
                          f"{type(e).__name__}: {str(e)[:200]}")
                for kind, run, plain, lib, nbytes, ops in (
                        ("fwd", lambda: k3.fused_lstm_gates(gates, pc),
                         lambda: k3.fused_lstm_gates_plain(gates, pc),
                         lib_f, n * 7 * c * size, n * c * 30),
                        ("bwd", lambda: k3.fused_lstm_gates_bwd(
                            gates, pc, dh, dcn),
                         lambda: k3.fused_lstm_gates_bwd_plain(
                             gates, pc, dh, dcn), lib_b, n * 12 * c * size,
                         n * c * 60)):
                    ms_k = cuda_ms(torch, run, flush)
                    ms_p = cuda_ms(torch, plain, flush, iters=5, warmup=1)
                    ms_l = (float("nan") if lib is None else
                            cuda_ms(torch, lib, flush, iters=5, warmup=1))
                    b_ms, _ = bound(nbytes, ops, F32_OPS_PER_S)
                    sums[kind] += (ms_k, ms_p, b_ms, ms_l)
                    line += (f"; {kind} kernel_ms {ms_k:.4f} plain_ms "
                             f"{ms_p:.4f} library_ms {ms_l:.4f} bound_ms "
                             f"{b_ms:.4f} (kernel at {b_ms / ms_k:.0%} of "
                             f"it)")
                del lib_f, lib_b
                errs["fwd"] = max(errs["fwd"], err)
                errs["bwd"] = max(errs["bwd"], berr)
            print(line)
            if ulps > 1.0 or bulps > 1.0:
                raise AssertionError(
                    f"K3 at {key} disagrees with its plain version: {line}")
            del gates, pc, dh, dcn
    out = {}
    for kind in ("fwd", "bwd"):
        ms_k, ms_p, b_ms, ms_l = sums[kind]
        print(f"K3 {kind} at {key}, B = {B}, bf16, sum over the three "
              f"levels: kernel {ms_k:.4f} ms, plain {ms_p:.4f}, library "
              f"{ms_l:.4f}, bound {b_ms:.4f} (kernel at {b_ms / ms_k:.0%} "
              f"of it)")
        out[kind] = {f"ms_{key}": ms_k, f"plain_ms_{key}": ms_p,
                     f"bound_ms_{key}": b_ms,
                     f"library_ms_{key}": None if np.isnan(ms_l) else ms_l,
                     f"max_abs_err_{key}": errs[kind]}
    return out["fwd"], out["bwd"]


def k2_band_phase(torch, k2, dev, flushes):
    """K2 at a model rank's band under spatial partitioning (M = 2, B = 2
    at 440x640: 220 rows, S = 100 an image) against its plain version,
    bf16 and f32 on block superpixels, with the image structure and flat
    (:func:`k2_times`). Returns the numbers for K2's row, each key ending
    in ``band`` or ``band_f32``."""
    phase("K2 at a model rank's band (spatial, M = 2, [2,220,640,256], "
          "S = 100 an image) vs plain")
    B, H, W, D, S = TP_BATCH, 220, 640, 256, 100
    gen = torch.Generator(device=dev).manual_seed(1616)
    sp = torch.from_numpy(block_superpixels(B, 2 * H, W)[:, :H]).to(dev)
    ids, total = k2.global_segment_ids(sp, S)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        rows = torch.randn((B * H * W, D), generator=gen,
                           device=dev).to(dtype)
        tag = str(dtype).split(".")[-1]
        got = k2_times(torch, k2, dev, flushes, rows, ids, total, H * W, S,
                       f"band, {tag}")
        got.pop("bound_by")
        sfx = "band" if dtype == torch.bfloat16 else "band_f32"
        out.update({f"{k}_{sfx}": v for k, v in got.items()})
        del rows
    return out


def dumps_apart(vis, h):
    """The ranks' ``val_epoch`` dumps (``vis + '_ranks'``) against one
    process's (``vis + '_one'``): how many of the five files each side
    wrote, whether the label panels (the second row of the prediction and
    label grid, ``h`` rows a panel) and the event previews are equal, the
    prediction pixels apart, and the PCA map's largest difference."""
    from PIL import Image

    def read(side):
        out = {}
        for name in sorted(os.listdir(vis + side)):
            with Image.open(os.path.join(vis + side, name)) as im:
                out[name.split("_e")[0]] = np.asarray(im).astype(np.int16)
        return out

    got, want = read("_ranks"), read("_one")
    files = len(got) if sorted(got) == sorted(want) else -1
    pg, pw = got["semseg_pred_gt"], want["semseg_pred_gt"]
    return dict(
        files=files,
        labels_equal=bool(np.array_equal(pg[h:], pw[h:])),
        pred_apart=int((pg[:h] != pw[:h]).any(-1).sum()),
        pca_diff=int(np.abs(got["pca_latent"] - want["pca_latent"]).max()),
        events_equal=bool(np.array_equal(got["event_preview"],
                                         want["event_preview"])))


def tp_checkpoint_check(torch, job, saved):
    """M2-pretrain's checkpoint (whole tensors, gathered over the model
    group) loaded into a one-process build: every tensor of its layout
    against the ranks' gathered parameters. Returns ``(tensors, equal)``."""
    from openess_tpu_torch.training import checkpoint as ckpt
    from openess_tpu_torch.training.build import build_models

    s = dp_settings(job)
    mset = build_models(s, seed=1, device="cpu")
    ckpt.restore_checkpoint(job["ckpt_dir"], mset)
    loaded = {f"{n}.{k}": p for n, m in mset.modules.items()
              for k, p in m.named_parameters()}
    equal = sorted(loaded) == sorted(saved) and all(
        torch.equal(p.detach().float(), saved[k]) for k, p in loaded.items())
    return len(loaded), equal


def tp_jobs(out_root, spatial=False):
    """The jobs of the M2 launch (data 1 x model 2, two gloo ranks, global
    B = 2): M2-pretrain's bf16 steps (with the checkpoint M2-finetune
    starts from) and f32 steps, M2-pretrain-recon's likewise, and
    M2-finetune in bf16 and in f32. ``spatial``: SP2's, the same jobs with
    each model rank holding a band of the image rows (the f32 fine-tune's
    ``val_epoch`` writing its dumps)."""
    ckpt_dir = os.path.join(out_root, "sp2_ckpt" if spatial else "m2_ckpt")
    f32 = dict(compute_dtype="float32")
    jobs = [
        # DP_STEPS: the fine-tune starts from this checkpoint, and its bf16
        # near ties (~85 after 1 + 3 steps, thousands after 1 + 1) set
        # how many labels the val_epoch check may see move
        dict(kind="steps", settings="pretrain", batch=TP_BATCH,
             ckpt_dir=ckpt_dir, profile=True),
        dict(kind="steps", settings="pretrain", batch=TP_BATCH,
             steps=TP_F32_STEPS, overrides=f32),
        dict(kind="steps", settings="recon", batch=TP_BATCH, profile=True,
             steps=TP_BF16_STEPS),
        dict(kind="steps", settings="recon", batch=TP_BATCH,
             steps=TP_F32_STEPS, overrides=f32),
        dict(kind="trainer", settings="finetune", batch=TP_BATCH, val=3,
             steps=TP_FINETUNE_STEPS, labels=True,
             overrides=dict(pretrained_file=ckpt_dir)),
        dict(kind="trainer", settings="finetune", batch=TP_BATCH, val=3,
             steps=1, timed=False, labels=True,
             overrides=dict(pretrained_file=ckpt_dir, **f32)),
    ]
    if spatial:  # the f32 fine-tune's val_epoch writes its dumps
        jobs[-1]["vis"] = os.path.join(out_root, "sp2_vis")
    return jobs


def tp_dm4_jobs():
    """The jobs of the DM4 and DSP4 launches (data 2 x model 2, four gloo
    ranks, global B = 4): D2's f32 job, whose one-process runs and f64 step
    D2 made, then bf16 steps."""
    return [dict(DP_F32_JOB, steps=TP_F32_STEPS),
            # not profiled (cut for time: four host-bound ranks; M2's and
            # SP2's steps give the idle share)
            dict(kind="steps", settings="pretrain", batch=TP_DM4_BATCH,
                 steps=TP_DM4_BF16_STEPS)]


def tp_refs(torch, dev, jobs, run=None):
    """The one-process runs of the M2 (or SP2) jobs on the same seed and
    draws: the bf16 steps once, the f32 steps twice (the one-process step's
    own spread), the fine-tunes once (the bf16 one with its labels and near
    ties per pixel). With ``run`` (the launch under way) only the fine-tunes,
    each once the ranks' checkpoint is whole; without it only the steps."""
    f32 = dict(compute_dtype="float32")
    if run is None:
        return {i: [dp_steps(torch, j, None, dev)
                    for _ in range(2 if j.get("overrides") == f32 else 1)]
                for i, j in enumerate(jobs) if j["kind"] == "steps"}
    dp_ready(torch, ckpt_written(jobs[0]), run)
    return {i: [dp_finetune(torch, j, None, dev)]
            for i, j in enumerate(jobs) if j["kind"] == "trainer"}


def tp_f64_steps(torch, dev, jobs):
    """The f64 step of each f32 steps job of the M2 (or SP2) launch."""
    return {i: dp_f64_step(torch, j, dev) for i, j in enumerate(jobs)
            if j["kind"] == "steps"
            and j.get("overrides") == dict(compute_dtype="float32")}


def tp_report(torch, smi, jobs, ranks, refs, exact, spatial=False):
    """M2-pretrain, M2-pretrain-recon and M2-finetune (``spatial``: SP2's)
    from the launch's results (``ranks``) against the one-process runs
    (``refs``, a list by job) and the f64 steps (``exact``). Returns each
    phase's launches summed over the ranks."""
    m2 = "SP2" if spatial else "M2"
    n_ckpt, ckpt_equal = tp_checkpoint_check(torch, jobs[0],
                                             ranks[0][0][0]["saved"])
    per = [[r[i][0] for r in ranks] for i in range(len(jobs))]
    label = ("host-staged gloo on one card shared by the ranks of the M "
             "and SP phases and D1 (and this process's work), not a "
             f"multi-card figure; on {smi}")
    none = dict.fromkeys(("K1", "K2", "K3", "K3_bwd", "K4", "K5", "K6"), 0)
    launches = {}
    phase(f"{m2}-pretrain: flagship pretrain frame2voxel at full width, "
          "bf16, augmentation on, " + (
              "every activation a band of rows (K1 on each rank's rows "
              "whole, then banded; K3 on each band; K2 on each band, summed "
              "over the model group)" if spatial else
              "the 55 wide convs sharded over two model ranks (K1 on each "
              "rank's rows, K3 on C/2 of each gate, K2 on the gathered "
              "features)"))
    launches[f"{m2.lower()}_pretrain"] = steps_report(
        torch, f"{m2}-pretrain", per[0], per[1], refs[0], refs[1], exact[1],
        DP_EVENT_F32_GRAD_L2, none | {"K1": 1, "K3": 60, "K2": 2}, [], label)
    l2 = tp_loss2(per[1], refs[1][0])
    print(f"f32 step 2's losses vs one process: {l2:.3e} (bound "
          f"{TP_LOSS2_REL:g}); checkpoint written by rank 0 loaded into one "
          f"process: {n_ckpt} tensors, each equal to the ranks' gathered "
          f"parameters: {ckpt_equal}")
    report_checks(f"{m2}-pretrain checkpoint and step 2", {
        "f32 step-2 losses": l2 <= TP_LOSS2_REL,
        "checkpoint loads into one process and equals the ranks'":
            ckpt_equal})

    phase(f"{m2}-pretrain-recon: T8-pretrain-recon's frame2recon at full "
          "width, " + (
              "the DeepLabV3 student on bands (the ASPP rates past the "
              "neighbouring band, train-mode BatchNorm over both ranks' "
              "pixels)" if spatial else
              "the DeepLabV3 student's aspp, classifier_conv and wide "
              "backbone convs sharded, train-mode BatchNorm after the "
              "gathers"))
    launches[f"{m2.lower()}_pretrain_recon"] = steps_report(
        torch, f"{m2}-pretrain-recon", per[2], per[3], refs[2], refs[3],
        exact[3], DP_RECON_F32_GRAD_L2, none | {"K2": 2},
        [("bf16", per[2], refs[2][0], DP_BF16_STATS_REL,
          SP_BF16_TIES if spatial else ()),
         ("f32", per[3], refs[3][0], DP_F32_STATS_REL)], label)
    l2 = tp_loss2(per[3], refs[3][0])
    print(f"f32 step 2's losses vs one process: {l2:.3e} (bound "
          f"{TP_LOSS2_REL:g})")
    report_checks(f"{m2}-pretrain-recon step 2", {
        "f32 step-2 losses": l2 <= TP_LOSS2_REL})

    phase(f"{m2}-finetune: F8's fine-tune with unfrozen_e2vid from "
          f"{m2}-pretrain's checkpoint, through Trainer on both model ranks "
          "(K3 and its backward on " + (
              "each band" if spatial else "C/2 of each gate")
          + "), a padded val_epoch with vis_dir, bf16, and in f32 against "
          "one process")
    ft, (ref,) = per[4], refs[4]
    ft32, (ref32,) = per[5], refs[5]
    pixels = int(ref["cm"].sum())
    counted = all(r["cm"].sum() == pixels for r in ft + ft32)

    def apart(a, b):  # pixels labelled otherwise
        return int(np.abs(a - b).sum()) // 2

    flips = max(apart(r["cm"], ref["cm"]) for r in ft)
    flips32 = max(apart(r["cm"], ref32["cm"]) for r in ft32)
    # per pixel: each rank's bf16 labels against one process's
    one = ref["val"]
    moves = label_moves(torch, one, ref32["val"],
                        [r["val"]["labels"] for r in ft])
    same_pixels = all(torch.equal(r["val"]["counted"], one["counted"])
                      for r in ft + ft32)
    loss = max(rel(r["epoch"][k], v) for r in ft
               for k, v in ref["epoch"].items())
    loss32 = max(rel(r["epoch"][k], v) for r in ft32
                 for k, v in ref32["epoch"].items())
    for r, res in enumerate(ft):
        moved = (f"received {res['halo_mb']:.2f} MB of halo rows"
                 if spatial else
                 f"gathered {res['gather_mb']:.1f} MB, summed "
                 f"{res['reduce_mb']:.1f} MB and took {res['sync_mb']:.1f} "
                 f"MB of replicated gradients")
        print(f"rank {r}: Trainer.train_epoch {res['epoch_ms']:.1f} ms a "
              f"step, step p50 {np.median(res['ms']):.1f} ms (CUDA "
              f"events), {moved} a step over the model group, sharded "
              f"parameters {res['sharded_mb']:.1f} MB, peak "
              f"{res['peak_gib']:.2f} GiB; launches {res['counts']}")
    print(f"one process (B = {TP_BATCH}): train_epoch {ref['epoch_ms']:.1f} "
          f"ms a step, step p50 {np.median(ref['ms']):.1f} ms; {label}")
    print(f"val_epoch over 3 samples (the second batch padded): pixels "
          f"counted {pixels} on every side: {counted}; f32 (TF32 off): "
          f"labelled otherwise than by one process {flips32} (bound "
          f"{DP_LABEL_FLIPS:g} of the pixels), step 1's losses max rel "
          f"{loss32:.3e} (bound {DP_F32_LOSS_REL:g}); bf16: labelled "
          f"otherwise by the confusion {flips}; {moves['text']}; epoch "
          f"losses max rel {loss:.3e} (bound {DP_BF16_LOSS_REL:g})")
    n = TP_FINETUNE_STEPS
    if spatial:
        dumps = dumps_apart(jobs[-1]["vis"], 440)
        print(f"f32 val_epoch dumps (rank 0's, each image gathered from "
              f"its bands) against one process's: files {dumps['files']}, "
              f"label panels equal {dumps['labels_equal']}, prediction "
              f"pixels apart {dumps['pred_apart']} (the f32 labels apart "
              f"over every val pixel: {flips32}), PCA map max |diff| "
              f"{dumps['pca_diff']} of 255; event previews equal "
              f"{dumps['events_equal']}")
        report_checks(f"{m2}-finetune dumps", {
            "five dumps on each side": dumps["files"] == 5,
            "label panels and event previews equal": dumps["labels_equal"]
            and dumps["events_equal"],
            "prediction panels apart only where the f32 labels are":
            dumps["pred_apart"] <= flips32})
    report_checks(f"{m2}-finetune", {
        "f32 val_epoch confusion": counted
        and flips32 <= DP_LABEL_FLIPS * pixels,
        "f32 step-1 losses": loss32 <= DP_F32_LOSS_REL,
        **label_checks(moves, same_pixels, pixels),
        "bf16 epoch losses": loss <= DP_BF16_LOSS_REL,
        "ranks bitwise equal": all(
            torch.equal(r["params"][k], runs[0]["params"][k])
            for runs in (ft, ft32) for r in runs[1:]
            for k in runs[0]["params"]),
        f"K1 {n}, K3 {60 * n}, K3 backward {60 * n} per rank": all(
            r["counts"]["K1"] == n and r["counts"]["K3"] == 60 * n
            and r["counts"]["K3_bwd"] == 60 * n for r in ft),
    })
    launches[f"{m2.lower()}_finetune"] = {k: sum(r["counts"][k] for r in ft)
                                          for k in ft[0]["counts"]}
    return launches


def tp_loss2(runs, ref):
    """Step 2's losses of the ranks' runs against one process's, the
    largest relative difference."""
    return max(rel(r["losses"][1][k], v) for r in runs
               for k, v in ref["losses"][1].items())


def dm4_report(torch, smi, jobs, ranks, bf16_ref, d2_f32, spatial=False):
    """DM4-pretrain (``spatial``: DSP4-pretrain) from the launch's results
    (``ranks``): the f32 step against D2's one-process runs and f64 step of
    the same job (``d2_f32``), the bf16 steps against the one-process run
    ``bf16_ref``. Returns the launches summed over the ranks."""
    dm4 = "DSP4" if spatial else "DM4"
    phase(f"{dm4}-pretrain: data 2 x model 2, four gloo ranks on the one "
          f"card (global B = {TP_DM4_BATCH}, 2 rows a data shard"
          + (", a band of their rows a model rank" if spatial else "")
          + "): the f32 step against one process, then bf16")
    label = ("host-staged gloo on one card shared by the ranks of DM4, "
             "DSP4 and M2 (and this process's work), not a multi-card "
             f"figure; on {smi}")
    none = dict.fromkeys(("K1", "K2", "K3", "K3_bwd", "K4", "K5", "K6"), 0)
    per = [[r[i][0] for r in ranks] for i in range(len(jobs))]
    launches = steps_report(
        torch, f"{dm4}-pretrain", per[1], per[0], bf16_ref, d2_f32["refs"],
        d2_f32["exact"], DP_EVENT_F32_GRAD_L2,
        none | {"K1": 1, "K3": 60, "K2": 2}, [], label)
    l2 = tp_loss2(per[0], d2_f32["refs"][0])
    rows = sorted({r["rows"] for r in per[1]})
    print(f"f32 step 2's losses vs one process: {l2:.3e} (bound "
          f"{TP_LOSS2_REL:g}); rows a rank {rows}")
    report_checks(f"{dm4}-pretrain step 2", {
        "f32 step-2 losses": l2 <= TP_LOSS2_REL})
    return launches


def rank_phases(torch, dev, smi, out_root, d2_f32, offline):
    """D1-nccl, the M phases (M2, DM4) and the SP phases (SP2, DSP4): the
    D1, M2 and SP2 launches side by side on the card, while this process
    runs the pretrain and recon one-process runs and the two halves of the
    offline tier (``offline``, two callables returning their launches);
    once M2 has ended, one after the other: the fine-tunes' one-process
    runs, DM4, its bf16 one-process run, DSP4, the f64 steps; then the
    reports.
    The SP jobs are the M jobs on bands, so their pretrain and recon
    one-process runs and f64 steps are the M jobs' (DSP4's bf16 one
    DM4's). Returns every phase's launches, the offline tier's included."""
    m_jobs, sp_jobs = tp_jobs(out_root), tp_jobs(out_root, spatial=True)
    dm4_jobs = tp_dm4_jobs()
    phase("D1-nccl (one NCCL rank), M2 and SP2 (two gloo ranks each) "
          "started side by side on the one card, this process running "
          "their pretrain and recon one-process runs and the offline tier "
          "meanwhile; then the fine-tunes' one-process runs, DM4 and DSP4 "
          "(four gloo ranks each) one after the other")
    print(f"this process holds {release(torch):.2f} GiB of the card")
    t0 = time.perf_counter()
    d1 = dp_start(1, "nccl", [D1_JOB], os.path.join(out_root, "d1"))
    m2 = dp_start(2, "gloo", m_jobs, os.path.join(out_root, "m2"), model=2)
    sp2 = dp_start(2, "gloo", sp_jobs, os.path.join(out_root, "sp2"),
                   model=2, spatial=True)
    with cache_weight_draws():
        refs = tp_refs(torch, dev, m_jobs)
    print(f"the M jobs' pretrain and recon one-process runs done at "
          f"{time.perf_counter() - t0:.1f} s")
    launches = offline[0]()
    d1_ranks, sp2_ranks = dp_wait(torch, d1), dp_wait(torch, sp2)
    print(f"D1's rank ran {d1['seconds']:.1f} s, SP2's "
          f"{sp2['seconds']:.1f} s")
    launches |= offline[1]()
    m2_ranks = dp_wait(torch, m2)
    # from here one thing at a time: the M2 and SP2 fine-tunes' f32 ranks
    # beside a one-process fine-tune, and DM4's f32 ranks beside anything
    # of size (one-process runs, or M2's or DSP4's ranks), overfill the
    # card's memory
    phase(f"M2's ranks ran {m2['seconds']:.1f} s; the M2 and SP2 "
          "fine-tunes' one-process runs, then DM4, DM4's bf16 one-process "
          "run, DSP4 and the M jobs' f64 steps, one after the other")
    t0 = time.perf_counter()
    with cache_weight_draws():
        sp_refs = refs | tp_refs(torch, dev, sp_jobs, sp2)
        refs |= tp_refs(torch, dev, m_jobs, m2)
    print(f"fine-tunes done in {time.perf_counter() - t0:.1f} s; this "
          f"process holds {release(torch):.2f} GiB of the card")
    dm4_ranks = dp_launch(torch, 4, "gloo", dm4_jobs,
                          os.path.join(out_root, "dm4"), model=2)
    t0 = time.perf_counter()
    with cache_weight_draws():
        bf16_ref = [dp_steps(torch, dm4_jobs[1], None, dev)]
    print(f"DM4's bf16 one-process run done in "
          f"{time.perf_counter() - t0:.1f} s; this process holds "
          f"{release(torch):.2f} GiB of the card")
    dsp4_ranks = dp_launch(torch, 4, "gloo", dm4_jobs,
                           os.path.join(out_root, "dsp4"), model=2,
                           spatial=True)
    t0 = time.perf_counter()
    with cache_weight_draws():
        exact = tp_f64_steps(torch, dev, m_jobs)
    print(f"f64 steps done in {time.perf_counter() - t0:.1f} s")
    refs = [refs[i] for i in range(len(m_jobs))]
    sp_refs = [sp_refs[i] for i in range(len(sp_jobs))]
    launches["d1_nccl"] = d1_nccl_report(torch, smi, d1_ranks,
                                         d1["seconds"])
    launches |= tp_report(torch, smi, m_jobs, m2_ranks, refs, exact)
    launches["dm4_pretrain"] = dm4_report(torch, smi, dm4_jobs, dm4_ranks,
                                          bf16_ref, d2_f32)
    launches |= tp_report(torch, smi, sp_jobs, sp2_ranks, sp_refs, exact,
                          spatial=True)
    launches["dsp4_pretrain"] = dm4_report(
        torch, smi, dm4_jobs, dsp4_ranks, bf16_ref, d2_f32, spatial=True)
    return launches


def offline_first(torch, dev, smi, root, zero_counts, read_counts):
    """The released checkpoints, then the offline tier's first half:
    reconstructions, superpixels, MaskCLIP's pseudo-labels and scoring
    (their files under ``root``). Returns their launches."""
    released_phase(torch, dev)
    launches = {}
    e2vid_path = seeded_e2vid_file(
        torch, os.path.join(root, "E2VID_lightweight.pth.tar"))
    launches["offline_recon_dsec"] = offline_recon_dsec_phase(
        torch, dev, smi, e2vid_path, zero_counts, read_counts)
    launches["offline_recon_file"] = offline_recon_file_phase(
        torch, smi, e2vid_path, root, zero_counts, read_counts)
    write_frame_trees(root, np.random.default_rng(15))
    offline_slic_phase(smi, root)
    files = write_maskclip_files(torch, root)
    launches["offline_pl"] = offline_pl_phase(
        torch, dev, smi, root, files, zero_counts, read_counts)
    launches["offline_eval"] = offline_eval_phase(
        torch, dev, smi, root, files, zero_counts, read_counts)
    return launches


def offline_second(torch, dev, smi, root, zero_counts, read_counts):
    """The offline tier's second half, on the frames the first wrote under
    ``root``: FC-CLIP's pseudo-labels, its f32 check and its scoring, and
    preflight. Returns their launches."""
    launches = {}
    fc = write_fcclip_files(torch, root)
    launches["offline_fcclip_pl"] = offline_fcclip_pl_phase(
        torch, dev, smi, root, fc, zero_counts, read_counts)
    fcclip_f32_phase(torch, dev, smi, root, fc)
    launches["offline_eval_fcclip"] = offline_eval_fcclip_phase(
        torch, dev, smi, root, fc, zero_counts, read_counts)
    preflight_phase(torch, smi, root, fc)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: needs a CUDA "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire
    from openess_tpu_torch.models.e2vid import initial_stream_state
    from openess_tpu_torch.native import chunk_events_windows_host
    from openess_tpu_torch.ops import _build
    from openess_tpu_torch.ops import lstm_gates as k3
    from openess_tpu_torch.ops import segment_pool as k2
    from openess_tpu_torch.ops import voxelize_chunked as k1
    from openess_tpu_torch.ops import voxelize_mxu as k56
    from openess_tpu_torch.serve_stream import (
        StreamServer,
        report,
        serve,
        synthetic_windows,
    )

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    host = []  # the host's numbers: packer, serving, loaders

    phase("device")
    smi = nvidia_smi()
    print(f"nvidia-smi name, power.limit: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"allow_tf32 by default: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}; both set to False here, so the "
          f"f32 comparisons run in full f32 (bf16 serving is unaffected)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build")
    t0 = time.perf_counter()
    sources = ("voxelize_chunked.cu", "segment_pool.cu", "voxelize_grid.cu",
               "lstm_gates.cu")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        lib_paths = list(pool.map(_build.build, sources))
    t_nvcc = time.perf_counter() - t0
    for src in sources:
        _build.load(src)
    spilled = []
    for name, lib_path in zip(("K1 and K4", "K2", "K5 and K6",
                               "K3 forward and backward"), lib_paths):
        print(f"{name} nvcc build+load (the sources in parallel "
              f"{t_nvcc:.1f} s) -> {lib_path}")
        for kernel, regs, spills in ptxas_kernels(lib_path):
            print(f"  ptxas: {kernel}: {regs} registers, {spills} bytes "
                  "spilled")
            spilled += [kernel] if spills else []
    if spilled:
        raise AssertionError(f"kernels spill registers: {spilled}")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = {}

    phase("K1 voxelize_chunked_trilinear vs plain (480x640, 100k ev, NW=8)")
    NW, K, H, W, BINS = 8, 100_000, 480, 640, 5
    wins = list(synthetic_windows(NW, K, H, W))
    xs, ys, ps, ts = (np.stack([w_[i] for w_ in wins]) for i in range(4))
    k1_err, k1_rows = 0.0, {}
    for t16 in (True, False):
        wire = chunk_events_windows_host(
            xs.astype(np.float32), ys.astype(np.float32),
            ps.astype(np.float32), ts, np.ones((NW, K), bool),
            height=H, width=W, t16=t16, trim=False,
            n_threads=os.cpu_count(),
        )
        d = upload_wire(dict(zip(WIRE_KEYS, wire)), dev)
        args = tuple(d[k] for k in WIRE_KEYS)
        run_k = lambda: k1.voxelize_chunked_trilinear(
            *args, num_bins=BINS, height=H, width=W)
        run_p = lambda: k1.voxelize_chunked_trilinear_plain(
            *args, num_bins=BINS, height=H, width=W)
        got, ref = run_k(), run_p()
        nan_err, _ = nan_prefilled(
            torch, lambda g: k1.voxelize_chunked_trilinear_into(g, *args),
            ref)
        torch.cuda.synchronize()
        err = max((got - ref).abs().max().item(), nan_err)
        scale = ref.abs().max().item()
        ok = err <= K1_REL_TOL * scale
        ms_k = cuda_ms(torch, run_k, flush)
        ms_p = cuda_ms(torch, run_p, flush)
        events = int(wire[4].sum())
        tbytes = 2 if t16 else 4
        nbytes = (events * (2 + 2 + 1 + tbytes) + wire[4].nbytes
                  + wire[5].nbytes + wire[6].nbytes + got.numel() * 4)
        b_ms, b_by = bound(nbytes, events * 8 * 6, F32_OPS_PER_S)
        tag = "v2 uint16" if t16 else "v1 f32"
        print(f"K1 [{tag} wire] max|kernel-plain| {err:.3e} (also "
              f"launched into a NaN-filled grid) "
              f"(max|plain| {scale:.3f}, bound {K1_REL_TOL:.0e} x max) "
              f"{'OK' if ok else 'FAIL'}; kernel_ms {ms_k:.4f} plain_ms "
              f"{ms_p:.4f} bound_ms {b_ms:.4f} ({b_by}; {events} events, "
              f"{nbytes / 1e6:.1f} MB)")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version: {err}")
        k1_err = max(k1_err, err)
        k1_rows[t16] = (ms_k, ms_p, b_ms, b_by)
    ms_k, ms_p, b_ms, b_by = k1_rows[True]
    kernels["K1"] = dict(
        name="K1 voxelize_chunked_trilinear", route="cuda",
        source="openess_tpu_torch/csrc/voxelize_chunked.cu",
        replaces="openess_tpu/ops/voxelize_chunked.py:281",
        max_abs_err=k1_err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        check=f"ok: max|kernel-plain| <= {K1_REL_TOL:g} x max|plain|, "
              "both time wires, NW = 8 and 160, each also launched into a "
              "NaN-filled grid, and on the edge cases",
    )
    kernels["K1"].update(k1_edge_phase(torch, k1, dev))

    phase("K3 fused_lstm_gates forward vs plain (bf16, 440x640 ConvLSTMs)")
    gen = torch.Generator(device=dev).manual_seed(1205)
    k3_err, sums = 0.0, np.zeros(4)
    for h, w, c in K3_SHAPES:
        gates = (torch.randn((1, h, w, 4 * c), generator=gen, device=dev)
                 * 2).to(torch.bfloat16)
        pc = torch.randn((1, h, w, c), generator=gen,
                         device=dev).to(torch.bfloat16)
        hp, cp = k3.fused_lstm_gates_plain(gates, pc)
        err, ulps = k3_fwd_check(torch, k3, gates, pc)
        ok = ulps <= 1.0
        run_k = lambda: k3.fused_lstm_gates(gates, pc)
        run_p = lambda: k3.fused_lstm_gates_plain(gates, pc)
        n = h * w
        run_l, (hl, cl) = k3_library_fwd(torch, gates, pc)
        lib_err = max((hl - hp.reshape(n, c)).abs().max().item(),
                      (cl - cp.reshape(n, c)).abs().max().item())
        ms_k = cuda_ms(torch, run_k, flush)
        ms_p = cuda_ms(torch, run_p, flush)
        ms_l = cuda_ms(torch, run_l, flush)
        nbytes = n * 7 * c * 2
        b_ms, _ = bound(nbytes, n * c * 30, F32_OPS_PER_S)
        print(f"K3 [{h}x{w}x{c}] max|kernel-plain| {err:.3e} = {ulps:.3f} "
              f"bf16 ulp (bound 1 ulp + {K3_ABS_SLACK:.0e}) "
              f"{'OK' if ok else 'FAIL'}; kernel_ms {ms_k:.4f} plain_ms "
              f"{ms_p:.4f} library_ms {ms_l:.4f} (_thnn_fused_lstm_cell, "
              f"max|lib-plain| {lib_err:.3e}) bound_ms {b_ms:.4f} "
              f"({nbytes / 1e6:.1f} MB; kernel at {b_ms / ms_k:.0%} of it)")
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version: {ulps}")
        k3_err = max(k3_err, err)
        sums += (ms_k, ms_p, ms_l, b_ms)
    us = k3_dispatch_us(torch, k3, gates, pc)
    extra_us = us["op"] - us["direct"]
    print(f"K3 through its torch.library op: {us['op']:.1f} us of host "
          f"time a call; its CUDA implementation called directly "
          f"{us['direct']:.1f} us: the op route adds {extra_us:.1f} us a "
          f"launch, {60 * extra_us / 1e3:.3f} ms over a train step's 60 "
          f"({h}x{w}x{c}, B=1)")
    kernels["K3"] = dict(
        name="K3 fused_lstm_gates forward (3 ConvLSTMs per window)",
        route="cuda", source="openess_tpu_torch/csrc/lstm_gates.cu",
        replaces="openess_tpu/ops/lstm_gates.py:75",
        max_abs_err=k3_err, ms=sums[0], plain_ms=sums[1], bound_ms=sums[3],
        bound_by="bytes", library_ms=sums[2],
        check="ok: |kernel-plain| <= 1 bf16 ulp + 1e-6 at every shape a main "
              "path launches: 440x640 levels at B = 1 and 8, 200x352 levels "
              "at B = 1 and 8, 480x640 levels at B = 1 (the offline "
              "reconstructions); ms is the B = 1 sum over the 440x640 "
              "levels",
        op_dispatch_us=us["op"], direct_dispatch_us=us["direct"],
    )
    k3_b8, kernels["K3_bwd"] = k3_b8_phase(torch, k3, dev, flush)
    k3_b8["max_abs_err"] = max(k3_b8["max_abs_err"], k3_err)
    kernels["K3"].update(k3_b8)
    # the model ranks' per-gate slices (channel TP at M = 2), before the
    # M phases run K3 there
    k3_fwd_half, k3_bwd_half = k3_tp_phase(torch, k3, dev, flush)
    kernels["K3"].update(k3_fwd_half)
    kernels["K3_bwd"].update(k3_bwd_half)
    k3_fwd_band, k3_bwd_band = k3_tp_phase(
        torch, k3, dev, flush, K3_BAND_SHAPES, "band",
        "a model rank's band (spatial, M = 2, B = 2 at 440x640)")
    kernels["K3"].update(k3_fwd_band)
    kernels["K3_bwd"].update(k3_bwd_band)
    t_k2 = time.perf_counter()
    k2_flushes = (torch.empty(K2_FLUSH_BYTES, dtype=torch.uint8, device=dev),
                  flush)
    kernels["K2"] = k2_phase(torch, k2, dev, k2_flushes)
    kernels["K2"].update(k2_band_phase(torch, k2, dev, k2_flushes))
    del k2_flushes
    print(f"K2 phases: {time.perf_counter() - t_k2:.1f} s")

    phase("serving: openess_tpu_torch.serve_stream at full width, bf16")
    print("settings: the values of configs/pretrain/DSEC/frame2voxel_fcclip_"
          "slic.yaml, built in code (config_option=frame2voxel); random "
          "weights, seed 0")
    counters = launch_counters()

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counters.items()}

    serving_launches = {k: 0 for k in counters}
    for label, fused, S, n in (
        ("S=1, plain gate path", False, 1, 10),
        ("S=1, K3 gates", True, 1, 10),
        ("S=8, K3 gates", True, 8, 3),
    ):
        s = flagship_settings(e2vid_fused_gates=fused)
        server = StreamServer(s, streams=S, device=dev)
        zero_counts()
        r = serve(server, synthetic_windows(n, 100_000, 480, 640))
        torch.cuda.synchronize()
        got = read_counts()
        n1, n3 = got["K1"], got["K3"]
        for k in got:
            serving_launches[k] += got[k]
        print(f"[{label}]")
        for line in report(r, 20.0, dev):
            print("  " + line)
        lat = r.latency_ms
        serving_row(host, f"S{S} DSEC, {label}", r, smi)
        print(f"  launches K1 {n1} K3 {n3}")
        finite = bool(torch.isfinite(r.logits).all())
        want = initial_stream_state(S, 440, 640, dtype=torch.bfloat16,
                                    device=dev)
        shapes_ok = all(
            a.shape == b.shape and a.dtype == b.dtype
            for pa, pb in zip(r.carry, want) for a, b in zip(pa, pb)
        ) and len(r.carry) == len(want)
        checks = {
            "logits finite": finite,
            "logits shape": tuple(r.logits.shape) == (S, 440, 640, 11),
            "labels uint8 [S,440,640]": r.labels.dtype == np.uint8
            and r.labels.shape == (S, 440, 640),
            "labels in [0, 11)": int(r.labels.max()) < 11,
            "carried state shapes": shapes_ok,
            "K1 once per window": n1 == n,
            "K3 three per window": n3 == (3 * n if fused else 0),
            "K2, K3 backward, K4, K5, K6 not on the DSEC serving path":
            got["K2"] == got["K3_bwd"] == got["K4"] == got["K5"]
            == got["K6"] == 0,
        }
        print("  checks: " + ", ".join(
            f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
        if not all(checks.values()):
            raise AssertionError(f"serving checks failed: {checks}")
        del server, r

    phase("serving trace: device busy time and idle share (S=1, K3 gates)")
    server = StreamServer(flagship_settings(e2vid_fused_gates=True), 1, dev)
    wins = list(synthetic_windows(7, 100_000, 480, 640))
    serve(server, wins[:2])  # warm-up: cuDNN algorithm choice
    served = []
    avg, wall, _ = device_profile(
        torch, lambda: served.append(serve(server, wins[2:])))
    print_profile(avg, wall, served[0].windows, "window", smi)
    del server, served

    phase("reference: f32 server on CUDA (K1, K3) vs on the CPU (plain)")
    s32 = flagship_settings(compute_dtype="float32", e2vid_fused_gates=True)
    gpu, cpu = (StreamServer(s32, 1, device=d) for d in (dev, "cpu"))
    cg, cc = gpu.initial_state(), cpu.initial_state()
    for i, (x, y, p, t) in enumerate(synthetic_windows(2, 100_000, 480, 640)):
        batch = gpu.pack(x, y, p, t)
        cg, lab_g, log_g = gpu.step(cg, upload_wire(batch, dev))
        cc, lab_c, log_c = cpu.step(cc, upload_wire(batch, "cpu"))
        err = (log_g.cpu() - log_c).abs().max().item()
        scale = log_c.abs().max().item()
        agree = (lab_g.cpu() == lab_c).float().mean().item()
        ok = err <= REF_REL_TOL * scale
        print(f"window {i}: max|cuda-cpu| logits {err:.3e} of max "
              f"{scale:.3f} (bound {REF_REL_TOL:.0e} x max) label "
              f"agreement {agree:.5f} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"CUDA server disagrees with CPU: {err}")

    packer_phase(smi, host)

    phase("pack one flagship batch (B=8, T=20, 100k events per window)")
    settings = flagship_settings(e2vid_fused_gates=True)
    host_batch, pack_s = flagship_batch(settings)
    print(f"C++ packer: {pack_s * 1e3:.0f} ms for {8 * 20} windows on "
          f"{os.cpu_count()} threads (host, set-up: the same batch feeds "
          f"every step below); wire chunk axis {host_batch['ev_x'].shape[2]}")

    kernels["K1"].update(k1_nw160_phase(torch, k1, dev, flush, host_batch))

    launches = {"serving": serving_launches}
    # the serving export: the streaming step at S = 1 and 8 and the batch
    # step exported on the card, then served and run beside the live
    # modules they were traced from
    with tempfile.TemporaryDirectory() as art_dir:
        phase("export: export_model's build functions on the card (440x640, "
              "bf16, K3 gates, seeded random weights)")
        exported = {}
        for name, S, streaming, nodes in (("streaming_S1", 1, True, 3),
                                          ("streaming_S8", 8, True, 3),
                                          ("batch_B8_T20", 8, False, 60)):
            es = flagship_settings(e2vid_fused_gates=True, batch_size_b=S)
            path, module, row = export_artifact(
                torch, dev, es, art_dir, name, streaming=streaming)
            host_row(host, **row)
            if row["lstm_gates_fwd_nodes"] != nodes:
                raise AssertionError(f"{name}: {row} lstm_gates_fwd nodes, "
                                     f"not {nodes}")
            exported[name] = (es, path, module)
        print(f"on {smi}")
        for S in (1, 8):
            phase(f"serving through the streaming artifact beside the live "
                  f"server (S={S}, {EXPORT_WINDOWS} windows)")
            es, path, _ = exported[f"streaming_S{S}"]
            launches[f"export_serving_s{S}"] = export_serving_phase(
                torch, dev, smi, host, es, path, S, EXPORT_WINDOWS,
                zero_counts, read_counts, "K1")
        es, path, module = exported["batch_B8_T20"]
        launches["export_batch"], row = export_batch_phase(
            torch, dev, es, module, path, host_batch, flush, zero_counts,
            read_counts)
        host_row(host, **row)
        del exported, module
    with tempfile.TemporaryDirectory() as ckpt_dir:
        launches["train"] = train_phase(
            torch, dev, smi, settings, host_batch, zero_counts, read_counts,
            ckpt_dir)
        train_reference_phase(torch, dev)

        # the stage after pretraining on DSEC: E2VID and the head start
        # from the checkpoint just written, the labels are the batch's
        # block pseudo-labels
        from openess_tpu_torch.training.checkpoint import read_model_state

        saved = read_model_state(ckpt_dir)
        loaded = {f"{n}.{k}": v for n in ("front_sensor_b", "back_end")
                  for k, v in saved[n].items()}
        ft_batch = {k: v for k, v in host_batch.items()
                    if k.startswith("ev_")}
        ft_batch["label"] = host_batch["pl"]
        ft_stats = {False: {}, True: {}}
        for s2d in (False, True):
            launches["finetune" + ("_s2d" if s2d else "")] = \
                downstream_phase(
                    torch, dev, smi,
                    "fine-tune: DSEC, unfrozen_e2vid, at full width, bf16 "
                    "(Trainer, from the pretrain checkpoint)"
                    + (", tpu.e2vid_s2d" if s2d else ""),
                    finetune_settings(e2vid_fused_gates=True,
                                      pretrained_file=ckpt_dir,
                                      e2vid_s2d=s2d),
                    ft_batch, {"K1": 1, "K3": 60, "K3_bwd": 60, "K2": 0,
                               "K4": 0, "K5": 0, "K6": 0},
                    lambda k: not k.endswith("text_embeddings"),
                    zero_counts, read_counts, loaded=loaded,
                    stats=ft_stats[s2d])
        phase("F8-finetune-DSEC: standard against tpu.e2vid_s2d")
        for s2d, st in ft_stats.items():
            print(f"{'s2d' if s2d else 'standard'}: p50 {st['p50']:.1f} ms "
                  f"p95 {st['p95']:.1f} ms, busy {st['busy']:.1f} ms per "
                  f"step; weight-gradient kernels, ms per step: " + "; ".join(
                      f"{k[:90]} x{c} {v:.2f}" for k, v, c in st["wgrad"]))
        print(f"on {smi}")
        s2d_wgrad_phase(torch, dev, smi)
        launches["dumps_dsec"] = dumps_phase(
            torch, dev, "visual dumps: val_epoch with vis_dir on the DSEC "
            "raw-wire batch (K1 previews)",
            finetune_settings(e2vid_fused_gates=True), ft_batch, "K1",
            zero_counts, read_counts)
        del saved, loaded, ft_batch
    del host_batch
    finetune_reference_phase(torch, dev)
    s2d_reference_phase(torch, dev)

    phase("pack one DDD17 batch (B=8, T=20, 32k events per window)")
    probe = ddd17_probe_settings(e2vid_fused_gates=True)
    ddd17_host, pack_s = ddd17_batch(probe)
    print(f"windows cut and C++ packer ({probe.num_cpu_workers} thread): "
          f"{pack_s * 1e3:.0f} ms for {8 * 20} windows (host, set-up); wire "
          f"chunk axis {ddd17_host['ev_x'].shape[2]}")
    kernels["K4"] = k4_phase(torch, k1, dev, flush, ddd17_host)
    launches["probe"] = downstream_phase(
        torch, dev, smi,
        "linear probe: DDD17 at full width, bf16 (Trainer)",
        probe, ddd17_host,
        {"K4": 1, "K3": 60, "K3_bwd": 0, "K1": 0, "K2": 0, "K5": 0,
         "K6": 0},
        lambda k: ".linear_probe." in k, zero_counts, read_counts)
    launches["dumps_ddd17"] = dumps_phase(
        torch, dev, "visual dumps: val_epoch with vis_dir on the DDD17 "
        "raw-wire batch (K4 previews)", probe, ddd17_host, "K4",
        zero_counts, read_counts)
    launches["serving_ddd17"] = ddd17_serving_phase(
        torch, dev, smi, zero_counts, read_counts, host)
    with tempfile.TemporaryDirectory() as art_dir:
        phase("export: the DDD17 streaming artifact (S=1, 200x352, bf16) "
              f"beside the live server ({EXPORT_DDD17_WINDOWS} windows)")
        es = ddd17_probe_settings(e2vid_fused_gates=True, batch_size_b=1)
        path, _, row = export_artifact(torch, dev, es, art_dir,
                                          "streaming_S1_DDD17",
                                          streaming=True)
        host_row(host, **row)
        if row["lstm_gates_fwd_nodes"] != 3:
            raise AssertionError(f"DDD17 streaming artifact: {row}")
        launches["export_serving_ddd17"] = export_serving_phase(
            torch, dev, smi, host, es, path, 1, EXPORT_DDD17_WINDOWS,
            zero_counts, read_counts, "K4")

    # the grid wire: K5 and K6 in the loaders, then the trainers on them
    windows = dsec_windows(flagship_settings())
    kernels["K5"] = k5_phase(torch, k56, dev, flush, windows)
    kernels["K6"] = k6_phase(torch, k56, dev, flush)
    del flush
    runs = [("K5", w) for w in GRID_WORKERS] + [
        ("host_voxelize", w) for w in GRID_WORKERS] + [
        ("histogram", GRID_WORKERS[-1])]
    for how, workers in runs:
        launches[f"dsec_grid_{how}_{workers}"] = dsec_grid_phase(
            torch, dev, smi, windows, zero_counts, read_counts, host,
            how=how, workers=workers)
    raw_wire_loader_phase(torch, dev, smi, windows)
    del windows
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        s = ddd17_probe_settings()
        need = s.nr_events_data_b * s.nr_events_window_b
        write_ddd17_tree(root, np.random.default_rng(4), need=need, images=5)
        print(f"DDD17 tree written in {time.perf_counter() - t0:.1f} s (6 "
              f"recordings of 5 masks, {need} events before the first)")
        for how in ("K6", "host_voxelize"):
            for workers in GRID_WORKERS:
                launches[f"ddd17_grid_{how}_{workers}"] = ddd17_disk_phase(
                    torch, dev, smi, zero_counts, read_counts, root, host,
                    how=how, workers=workers)

    # the frame/recon workloads: the DeepLabV3 student (K2 on its f32
    # features and the teacher's in the pretrain step)
    recon_host = recon_batch(recon_pretrain_settings())
    none = dict.fromkeys(("K1", "K2", "K3", "K3_bwd", "K4", "K5", "K6"), 0)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        launches["recon_pretrain"] = recon_phase(
            torch, dev, smi,
            "T8-pretrain-recon: pretrain frame2recon at full width, bf16 "
            "(Trainer)", recon_pretrain_settings(), recon_host, TRAIN_STEPS,
            none | {"K2": 2},
            {"contrastive_nce_loss", "dense_clip_loss", "total_loss"},
            zero_counts, read_counts, ckpt_dir=ckpt_dir)
        from openess_tpu_torch.training.checkpoint import read_model_state

        loaded = {f"model_recon.{k}": v for k, v in
                  read_model_state(ckpt_dir)["model_recon"].items()}
        launches["recon_finetune"] = recon_phase(
            torch, dev, smi,
            "F8-finetune-recon: fine-tune frame2recon at full width, bf16 "
            "(Trainer, from the T8-pretrain-recon checkpoint)",
            finetune_settings(config_option="frame2recon",
                              pretrained_file=ckpt_dir),
            recon_host, RECON_DOWNSTREAM_STEPS, none,
            {"semseg_loss", "total_loss"}, zero_counts, read_counts,
            loaded=loaded)
        del loaded
    launches["recon_uda"] = recon_phase(
        torch, dev, smi,
        "U8-uda-recon: UDA on frame2recon (two DeepLabV3 students) at full "
        "width, bf16 (Trainer)", uda_recon_settings(), recon_host,
        RECON_DOWNSTREAM_STEPS, none,
        {"semseg_frame_loss", "semseg_recon_loss", "cons_feat_loss",
         "cons_pred_loss", "total_loss"}, zero_counts, read_counts)
    del recon_host
    recon_reference_phase(torch, dev)

    # data parallelism: the D2 phases (two gloo ranks on the one card);
    # then D1 (one NCCL rank), channel TP (the M phases) and spatial
    # partitioning (the SP phases, on the same jobs), their ranks running
    # while this process runs the released checkpoints and the offline
    # tier
    with tempfile.TemporaryDirectory() as dp_root, \
            tempfile.TemporaryDirectory() as root:
        d2, d2_f32 = d2_phases(torch, dev, smi, dp_root)
        launches.update(d2)
        launches.update(rank_phases(torch, dev, smi, dp_root, d2_f32, (
            lambda: offline_first(torch, dev, smi, root, zero_counts,
                                  read_counts),
            lambda: offline_second(torch, dev, smi, root, zero_counts,
                                   read_counts))))
    launches["mfu_probe"] = mfu_probe_phase(torch, smi, zero_counts,
                                            read_counts)
    bench_phase(torch)

    phase("summary")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = []
    for key in ("K1", "K3", "K3_bwd", "K2", "K4", "K5", "K6"):
        row = kernels[key]
        for path, counts in launches.items():
            row[f"launches_{path}"] = counts[key]
        row["launches"] = sum(counts[key] for counts in launches.values())
        if row["launches"] <= 0:
            raise AssertionError(f"{key} was never launched on a main path")
        rows.append({k: row[k] for k in order}
                    | {k: v for k, v in row.items() if k not in order})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"host": host}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_rank_main(sys.argv[2]))
    try:
        sys.exit(main())
    finally:  # a failed phase stops the ranks still running
        for run in list(RANK_RUNS):
            dp_stop(run)
