"""FLOP accounting for the train step and model FLOPs utilization (MFU),
the counterpart of ``openess_tpu/utils/flops.py``.

:func:`conv_flops` and :func:`e2vid_window_flops` are the JAX package's
analytic counts, copied. The JAX bench adds ``(T - 1)`` windows to XLA's
cost analysis, which counts the scan body once; the port runs the T
windows as a Python loop, so nothing needs correcting: :func:`count_flops`
runs one call (a train step: forward, backward, optimizer) under
``torch.utils.flop_counter.FlopCounterMode`` and returns what it counts,
the convolutions and matrix products (``2 x`` multiply-adds, backward
included). Elementwise work, reductions, the optimizer's updates and the
hand-written kernels (K1-K6, launched through ``ctypes``) add none.

MFU is those FLOPs per second against the card's dense bf16 peak, looked
up by ``torch.cuda.get_device_name()`` in :data:`PEAK_BF16_FLOPS`; a card
missing from the table raises rather than read as 0.
"""
from __future__ import annotations

import torch

# dense bf16 tensor-core peak, FLOP/s, without sparsity, by device name
PEAK_BF16_FLOPS = {
    # NVIDIA H100 SXM5 data sheet: 989.4 TFLOP/s bf16 dense at 700 W
    "NVIDIA H100 80GB HBM3": 989.4e12,
}


def conv_flops(px: int, k: int, cin: int, cout: int) -> int:
    """2 * MACs of a k x k conv evaluated at ``px`` output pixels."""
    return 2 * px * k * k * cin * cout


def e2vid_window_flops(
    batch: int, height: int, width: int, *, num_bins: int = 5,
    base: int = 32, num_encoders: int = 3, num_residual_blocks: int = 2,
    decode: bool = True,
) -> int:
    """Forward FLOPs of one UNetRecurrent window (``models/e2vid.py``) in
    its standard form. ``decode=False`` counts the latent-only build the
    trainers use: head and encoders, no resblocks, decoders or pred."""
    h, w = height, width
    px = batch * h * w
    total = conv_flops(px, 5, num_bins, base)              # head
    ch = base
    for i in range(num_encoders):
        out = base * (2 ** (i + 1))
        px = batch * (h // 2 ** (i + 1)) * (w // 2 ** (i + 1))
        total += conv_flops(px, 5, ch, out)                # strided encoder
        total += conv_flops(px, 3, 2 * out, 4 * out)       # ConvLSTM gates
        ch = out
    if not decode:
        return total
    px8 = batch * (h // 2 ** num_encoders) * (w // 2 ** num_encoders)
    for _ in range(num_residual_blocks):
        total += 2 * conv_flops(px8, 3, ch, ch)            # resblock convs
    for i in range(num_encoders):
        cin = base * (2 ** (num_encoders - i))
        px = batch * (h // 2 ** (num_encoders - i - 1)) * (
            w // 2 ** (num_encoders - i - 1)
        )
        # transposed conv == k5 conv over the 2x-dilated input: only ~1/4 of
        # taps land on real samples
        total += conv_flops(px, 5, cin, cin // 2) // 4
        cin //= 2
    total += conv_flops(batch * h * w, 1, base, 1)         # pred
    return total


def count_flops(fn, *args, **kwargs) -> tuple:
    """``(FLOPs, fn's result)`` of one call of ``fn``: the convolutions and
    matrix products ``FlopCounterMode`` sees, on every thread autograd
    runs the backward on."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return counter.get_total_flops(), out


def peak_bf16_flops(device_name: str) -> float:
    """The dense bf16 peak of the card named ``device_name``."""
    try:
        return PEAK_BF16_FLOPS[device_name]
    except KeyError:
        raise KeyError(
            f"no bf16 peak on record for {device_name!r}; add the card's "
            "data-sheet figure to PEAK_BF16_FLOPS") from None


def mfu_pct(flops: float, step_ms: float, device_name: str) -> float:
    """Model FLOPs utilization in percent: ``flops`` done in ``step_ms``
    against the card's dense bf16 peak."""
    return 100.0 * flops / (step_ms / 1e3) / peak_bf16_flops(device_name)
