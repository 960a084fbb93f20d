"""openess_tpu_torch: the PyTorch/CUDA port of ``openess_tpu``.

The JAX package stays the reference; this package computes the same
functions with PyTorch, and every TPU (Pallas) kernel on a ported path is a
kernel written by hand for Hopper (``sm_90a``): CUDA C++ under ``csrc/``,
built with ``nvcc`` at first use. Each kernel wrapper keeps a
plain PyTorch version beside it, which it takes only for tensors on the CPU.

Ported so far: the streaming segmentation server (``serve_stream``):
event wire -> K1 voxelizer -> E2VID step (K3 gate kernel when
``tpu.e2vid_fused_gates``) -> SemSegE2VID head -> uint8 labels; and
training on the event path (``train``, ``test``, ``training/``): the
pretrain ``frame2voxel`` / ``recon2voxel`` step with the frozen ResNet-50
teacher and superpixel pooling through the K2 kernel, the ``sup_only``
step, the eval step, the trainer loop and checkpoints. The host's event
code (the sorted-chunk packer, the host voxelizers, the histogram) is C++
under ``csrc/``, built with the host compiler at first use and bound by
``native.py``; ``data/pipeline.PrefetchLoader`` assembles batches ahead of
the step.

Module names follow ``openess_tpu`` so each counterpart is easy to find.
Public functions keep the JAX package's NHWC layouts; convolutions run on
NCHW views of channels-last tensors inside.
"""
import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one. Raises when CUDA is asked for (the default) and no GPU is
    present, so a run never lands on the CPU by accident."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    return dev
