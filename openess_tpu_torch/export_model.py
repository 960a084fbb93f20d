"""AOT export of the inference step as a ``torch.export`` artifact
(``.pt2``), the counterpart of ``tools/export_model.py``.

The whole segmentation forward (voxel windows -> E2VID over the windows ->
SemSegE2VID head -> argmax, or frame/recon -> DeepLabV3 -> argmax) is
traced once with the weights as the artifact's parameters and written to
one file. A server loads it and calls it with no model code, settings
plumbing or checkpoint.

Input contract (shapes fixed at export, the batch symbolic under
``--poly_batch``):
  voxel options (recon2voxel / frame2voxel): ``event`` [B, T, C, H, W] f32,
    the planar grid wire (the raw-event wire's chunk count depends on the
    data, so an artifact takes grids);
  frame2recon: ``recon`` [B, H, W, 3] f32 in [0, 1].
Output: ``(pred [B, H, W] int32, logits [B, H, W, num_classes])``.

``--streaming`` (voxel options) exports the serving step instead:
``(states, window [B, C, H, W] f32) -> (states, pred, logits)``, the
ConvLSTM states ``((h, c),) * 3`` (NHWC, the compute dtype,
``models/e2vid.initial_stream_state``) carried by the caller. It is the
module the live server (``serve_stream.StreamServer``) runs.

The ConvLSTM gates (``tpu.e2vid_fused_gates``) are the
``openess_tpu_torch::lstm_gates_fwd`` op (``ops/lstm_gates.py``), one node
of the graph each: 3 in a streaming step, 3 T in a batch step. An artifact
is tied to the device it was exported on (its parameters and constants live
there): export on the device it will serve from. :func:`load_artifact`
refuses another device.

Usage:
  python -m openess_tpu_torch.export_model --settings_file configs/<cfg>.yaml \\
      --output model.pt2 [--checkpoint <port checkpoint>] [--batch_size N] \\
      [--poly_batch | --streaming] [--selfcheck] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import zipfile

import numpy as np
import torch
from torch import nn

from openess_tpu_torch.training.build import (
    VOXEL_OPTIONS,
    build_models,
    serving_models,
)
from openess_tpu_torch.training.steps import StepBuilder

META_FILE = "openess_export.json"
F32_ATOL = 1e-5   # selfcheck in f32: JAX's bound (tools/export_model.py)
BF16_REL = 1e-3   # selfcheck in bf16, of max|logits|: an artifact runs the
                  # live module's kernels in its order (0 on an H100)


class InferStep(nn.Module):
    """``(event | recon) -> (pred int32, logits)``:
    :meth:`StepBuilder.infer` over the modules it reads, which are this
    module's submodules, so their weights are the artifact's parameters."""

    def __init__(self, s, mset):
        super().__init__()
        names = (("front_sensor_b", "back_end") if s.config_option
                 in VOXEL_OPTIONS else ("model_recon",))
        self.models = nn.ModuleDict({n: mset.modules[n] for n in names})
        self.sb = StepBuilder(s, mset)
        self.sb._set_mode(False)

    def forward(self, x):
        return self.sb.infer(x)


class StreamingStep(nn.Module):
    """``(states, window [B, C, H, W]) -> (states, pred int32, logits)``:
    one E2VID window from the carried states and the head, in the compute
    dtype (the window is cast to it)."""

    def __init__(self, models):
        super().__init__()
        self.e2vid = models.e2vid
        self.head = models.head
        self.dtype = models.dtype

    def forward(self, states, window):
        states, latent, _ = self.e2vid(states, window.to(self.dtype))
        logits, _ = self.head(latent)
        return states, logits.argmax(dim=-1).to(torch.int32), logits


def build_infer_fn(s, mset):
    """``(InferStep, example input)`` for the configured batch: the grid
    wire ``[B, T, C, H, W]`` on the voxel options, ``[B, H, W, 3]`` on
    ``frame2recon``, f32 on the models' device."""
    h, w = (int(v) for v in s.img_size_b)
    if s.config_option in VOXEL_OPTIONS:
        shape = (s.batch_size_b, s.nr_events_data_b, s.input_channels_b, h, w)
    else:
        shape = (s.batch_size_b, h, w, 3)
    return InferStep(s, mset), torch.zeros(shape, device=mset.device)


def build_streaming_fn(s, mset):
    """``(StreamingStep, (states, window))``: the serving step over
    ``serving_models(mset)`` (which converts the set's event path to the
    compute dtype, eval mode, in place) and zero example inputs for the
    configured batch."""
    from openess_tpu_torch.models.e2vid import initial_stream_state

    models = serving_models(mset)
    h, w = (int(v) for v in s.img_size_b)
    b = s.batch_size_b
    states = initial_stream_state(b, h, w, dtype=models.dtype,
                                  device=models.device)
    window = torch.zeros((b, s.input_channels_b, h, w), device=models.device)
    return StreamingStep(models), (states, window)


def export(module, args, *, poly_batch: bool = False):
    """``torch.export`` of ``module`` on ``args`` under ``no_grad`` (not
    ``inference_mode``, whose tensors the exported program would refuse),
    without the example inputs. ``poly_batch`` makes the single input's
    batch symbolic, from 2 up (an example batch of 0 or 1 would be
    specialized)."""
    dynamic = None
    if poly_batch:
        dynamic = ({0: torch.export.Dim("batch", min=2)},)
    with torch.no_grad():
        ep = torch.export.export(module, tuple(args), dynamic_shapes=dynamic,
                                 strict=False)
    # the program keeps its example inputs, which would be saved with it:
    # a B = 8, T = 20 grid batch is 901 MB beside 46 MB of weights
    ep.example_inputs = None
    return ep


def count_gate_nodes(ep) -> int:
    """Nodes of the exported graph that call K3's forward op."""
    op = torch.ops.openess_tpu_torch.lstm_gates_fwd.default
    return sum(n.op == "call_function" and n.target is op
               for n in ep.graph.nodes)


def input_specs(ep) -> list:
    """``(shape, dtype)`` of each user input of the exported program, in
    order (a symbolic dimension as its name)."""
    user = set(ep.graph_signature.user_inputs)
    out = []
    for node in ep.graph.nodes:
        if node.op == "placeholder" and node.name in user:
            val = node.meta["val"]
            out.append((tuple(d if isinstance(d, int) else str(d)
                              for d in val.shape), val.dtype))
    return out


def save_artifact(ep, path: str, meta: dict) -> int:
    """Write ``ep`` with ``meta`` (its ``kind``, ``"streaming"`` or
    ``"batch"``, and the ``device`` it was exported on) beside it; return
    the file's size."""
    torch.export.save(ep, path, extra_files={META_FILE: json.dumps(meta)})
    return os.path.getsize(path)


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda":
        cur = torch.cuda.current_device
        return (cur() if a.index is None else a.index) == (
            cur() if b.index is None else b.index)
    return True


def load_artifact(path: str, device):
    """``(ExportedProgram, meta)`` of an artifact written by this module.
    Raises when it was exported on another device than ``device``: its
    parameters and constants live on the export device, and it is never
    moved. K3's ops are registered first (``torch.export.load`` needs
    them)."""
    import openess_tpu_torch.ops.lstm_gates  # noqa: F401 (registers the ops)

    meta = read_meta(path)
    if not _same_device(meta["device"], device):
        raise ValueError(
            f"artifact {path!r} was exported on {meta['device']} and cannot "
            f"serve on {device}: export it on the device it will serve from")
    return torch.export.load(path), meta


def read_meta(path: str) -> dict:
    """What :func:`save_artifact` wrote beside the program, read from the
    archive without loading its tensors (which may live on a device this
    process lacks)."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist()
                 if n.endswith(f"/extra/{META_FILE}")]
        if not names:
            raise ValueError(f"{path!r} is not an openess_tpu_torch export "
                             f"(no {META_FILE} in it)")
        return json.loads(z.read(names[0]))


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def selfcheck(module, ep, args, streaming: bool, batch: int = 0) -> dict:
    """The deserialized artifact against the live module on random inputs
    (``numpy.random.default_rng(0)``, normal, std 0.5): the streaming form
    over 3 windows with each carry round-tripping through its own side, the
    batch form once (at ``batch`` samples when given: a symbolic batch).
    Pred must be equal; logits (and the carry) within ``F32_ATOL`` in f32,
    ``BF16_REL`` of max|logits| in bf16. Returns the measured gaps; raises
    past a bound."""
    run = ep.module()
    rng = np.random.default_rng(0)
    x = args[-1]
    shape = (batch or x.shape[0],) + tuple(x.shape[1:])
    data = torch.from_numpy(rng.normal(0, 0.5, shape).astype(
        np.float32)).to(x.device)
    gaps = {"logits": 0.0, "carry": 0.0, "logits_max": 0.0}
    with torch.no_grad():
        if streaming:
            live = art = args[0]
            for _ in range(3):
                live, pred_l, logits_l = module(live, data)
                art, pred_a, logits_a = run(art, data)
                if not torch.equal(pred_l, pred_a):
                    raise AssertionError("selfcheck: artifact labels differ")
                gaps["logits"] = max(gaps["logits"],
                                     _max_abs(logits_l, logits_a))
                gaps["logits_max"] = max(gaps["logits_max"], float(
                    logits_l.float().abs().max()))
                gaps["carry"] = max(gaps["carry"], *(
                    _max_abs(a, b) for la, aa in zip(live, art)
                    for a, b in zip(la, aa)))
        else:
            pred_l, logits_l = module(data)
            pred_a, logits_a = run(data)
            if not torch.equal(pred_l, pred_a):
                raise AssertionError("selfcheck: artifact labels differ")
            gaps["logits"] = _max_abs(logits_l, logits_a)
            gaps["logits_max"] = float(logits_l.float().abs().max())
    bf16 = logits_l.dtype == torch.bfloat16
    bound = BF16_REL * gaps["logits_max"] if bf16 else F32_ATOL
    gaps["bound"] = bound
    if gaps["logits"] > bound or gaps["carry"] > bound:
        raise AssertionError(f"selfcheck: artifact differs from the live "
                             f"module by {gaps} (bound {bound:.3g})")
    return gaps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings_file", required=True)
    ap.add_argument("--output", required=True, help="artifact path (.pt2)")
    ap.add_argument("--checkpoint", default="",
                    help="port checkpoint (file, or a directory of "
                         "ckpt_*.pt) whose weights the artifact carries")
    ap.add_argument("--batch_size", type=int, default=0,
                    help="override the config batch size for the artifact")
    ap.add_argument("--poly_batch", action="store_true",
                    help="export with a symbolic batch dimension (2 and "
                         "up): one artifact serves any such batch size")
    ap.add_argument("--streaming", action="store_true",
                    help="export the streaming serving step (voxel options "
                         "only): (states, window [B, bins, H, W]) -> "
                         "(states, pred, logits), one window a call with "
                         "caller-carried ConvLSTM state")
    ap.add_argument("--selfcheck", action="store_true",
                    help="deserialize and compare with the live module on "
                         "random inputs")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu: the "
                         "device the artifact is exported on and serves on")
    args = ap.parse_args(argv)

    from openess_tpu_torch.config.settings import load_settings

    s = load_settings(args.settings_file, generate_log=False)
    if args.batch_size:
        s.batch_size_b = args.batch_size
    if args.streaming:
        if s.config_option not in VOXEL_OPTIONS:
            raise SystemExit("--streaming requires a voxel config_option")
        if args.poly_batch:
            raise SystemExit("--streaming and --poly_batch are exclusive "
                             "(the carried state pins the batch size)")
    elif args.poly_batch and s.batch_size_b < 2:
        s.batch_size_b = 2  # a symbolic batch needs an example of 2 or more
    mset = build_models(s, seed=0, device=args.device)
    if args.checkpoint:
        from openess_tpu_torch.training.checkpoint import load_model_only

        load_model_only(args.checkpoint, mset)

    if args.streaming:
        module, ex = build_streaming_fn(s, mset)
    else:
        module, x = build_infer_fn(s, mset)
        ex = (x,)
    ep = export(module, ex, poly_batch=args.poly_batch)
    kind = "streaming" if args.streaming else "batch"
    size = save_artifact(ep, args.output, dict(kind=kind,
                                               device=str(mset.device)))
    if args.selfcheck:
        loaded, _ = load_artifact(args.output, mset.device)
        gaps = selfcheck(module, loaded, ex, args.streaming,
                         batch=2 if args.poly_batch else 0)
        print(f"selfcheck OK: {kind} artifact matches the live module "
              f"(max|logits diff| {gaps['logits']:.3g}, carry "
              f"{gaps['carry']:.3g}, bound {gaps['bound']:.3g})")
    specs = [(shape, str(dtype)) for shape, dtype in input_specs(ep)]
    print(f"exported {args.output}: {size / 1e6:.1f} MB, "
          f"device={mset.device}, input={tuple(ex[-1].shape)}, "
          f"in_avals={specs}, lstm_gates_fwd nodes {count_gate_nodes(ep)}")


if __name__ == "__main__":
    main()
