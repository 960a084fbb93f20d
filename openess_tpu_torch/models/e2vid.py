"""E2VID recurrent ConvLSTM-UNet (the released ``E2VID_lightweight``
configuration: 5 bins, 3 encoders, base 32, 2 residual blocks, sum skips,
no norm, transposed-conv decoders), ported from ``openess_tpu/models/
e2vid.py``.

Module and parameter names are the reference's (``e2vid/model/unet.py``,
``submodules.py``), so the state-dict keys are the ones
``openess_tpu/models/torch_convert.py:convert_e2vid`` reads:
``unetrecurrent.head.conv2d.*``, ``encoders.{i}.conv.conv2d.*``,
``encoders.{i}.recurrent_block.Gates.*``, ``resblocks.{i}.conv{1,2}.*``,
``decoders.{i}.transposed_conv2d.*``, ``pred.conv2d.*``.

Layouts: the public functions take and return NHWC tensors as the JAX
package does (windows are planar ``[B, bins, H, W]`` where JAX's are).
Inside, every activation is an NCHW view of a channels-last tensor, so the
NHWC <-> NCHW conversions at the boundary are free permutations.

Dtypes: every conv of the head and the encoders computes in its input's
dtype and casts its parameters per call (:class:`CastConv2d`), so the
latent path computes in the dtype of the windows it is given (the decode
path's transposed convs, which never train here, want their stored dtype). A frozen E2VID is stored in that dtype and the cast is
a no-op; a trainable one (the ``unfrozen_e2vid`` fine-tune) keeps f32
parameters under a bf16 compute dtype, as the flax module does, and the
loop over the T windows runs under autograd.

Space-to-depth (``E2VIDReconstructor(s2d=True)``, ``tpu.e2vid_s2d``): the
head and enc0 run on the 2x2 space-to-depth window (``F.pixel_unshuffle``,
channel order ``c*4 + iy*2 + ix`` as the JAX package's ``space_to_depth``):
the 5x5 head conv becomes an exact 3x3 conv from ``4*bins`` to ``4*32``
channels at half the resolution, and enc0's strided 5x5 conv an exact 3x3
conv from 128 to 64 channels. Their kernels are gathered from the
unchanged 5x5 parameters on every call (:func:`s2d_kernel`), so the
parameters, the state dict and checkpoints are the standard form's, and
gradients flow back to the 5x5 parameters. Only the reconstructor takes
it; the streaming step runs the standard form.
"""
from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openess_tpu_torch.ops.lstm_gates import fused_lstm_gates

CL = torch.channels_last


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC tensor -> NCHW view (channels-last memory when ``x`` is
    contiguous)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW channels-last tensor -> contiguous NHWC tensor (a view when the
    memory is already channels-last)."""
    return x.permute(0, 2, 3, 1).contiguous()


class CastConv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in its input's dtype: the parameters are
    cast per call (a no-op when they already match). A trainable module
    keeps f32 parameters under a bf16 compute dtype, as the flax modules
    do."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


@functools.lru_cache(maxsize=None)
def _s2d_index(ci: int, co: int, s2d_out: bool):
    """Constant gather map of :func:`s2d_kernel`, the JAX package's: an
    index into the flattened HWIO ``[5, 5, ci, co]`` kernel (-1 = the
    appended zero slot) for every element of the rewritten HWIO
    ``[3, 3, 4ci, (4|1)co]`` kernel."""
    idx = np.full((3, 3, 4 * ci, (4 if s2d_out else 1) * co), -1, np.int32)
    src = np.arange(5 * 5 * ci * co, dtype=np.int32).reshape(5, 5, ci, co)
    for ky in range(5):
        for kx in range(5):
            for by in range(2 if s2d_out else 1):
                for bx in range(2 if s2d_out else 1):
                    vy = by + ky - 2 if s2d_out else ky - 2
                    vx = bx + kx - 2 if s2d_out else kx - 2
                    dy, iy = vy // 2 + 1, vy % 2
                    dx, ix = vx // 2 + 1, vx % 2
                    if s2d_out:
                        idx[dy, dx, iy * 2 + ix :: 4, by * 2 + bx :: 4] = (
                            src[ky, kx]
                        )
                    else:
                        idx[dy, dx, iy * 2 + ix :: 4, :] = src[ky, kx]
    return idx


@functools.lru_cache(maxsize=None)
def _s2d_index_oihw(ci: int, co: int, s2d_out: bool, device: torch.device):
    """:func:`_s2d_index` for torch's layouts, on ``device``: an index into
    the flattened OIHW ``[co, ci, 5, 5]`` weight with the zero slot at its
    end, laid out as the OIHW ``[(4|1)co, 4ci, 3, 3]`` rewritten weight.
    One per shape and device (three shapes at most)."""
    idx = _s2d_index(ci, co, s2d_out)
    ky, rest = np.divmod(idx, 5 * ci * co)
    kx, rest = np.divmod(rest, ci * co)
    c, o = np.divmod(rest, co)
    oihw = np.where(idx >= 0, ((o * ci + c) * 5 + ky) * 5 + kx, co * ci * 25)
    return torch.from_numpy(
        np.ascontiguousarray(oihw.transpose(3, 2, 0, 1)).astype(np.int64)
    ).to(device)


def s2d_kernel(weight: torch.Tensor, s2d_out: bool) -> torch.Tensor:
    """Exact space-to-depth rewrite of a 5x5 conv weight ``[Co, Ci, 5, 5]``
    (the JAX package's ``_s2d_kernel``). ``s2d_out=True``: the stride-1
    conv with s2d input and output -> ``[4Co, 4Ci, 3, 3]`` (the head);
    ``False``: the stride-2 conv on s2d input with standard output ->
    ``[Co, 4Ci, 3, 3]`` (enc0, the stride absorbed by the s2d grid). An
    original tap at offset v in -2..3 lands at s2d offset v // 2 with
    sub-pixel v % 2, so the rewritten conv computes the same sum (its
    extra taps are exact zeros). One gather, differentiable."""
    co, ci, k, _ = weight.shape
    if k != 5:
        raise ValueError(f"s2d rewrites 5x5 convs, not {k}x{k}")
    idx = _s2d_index_oihw(ci, co, s2d_out, weight.device)
    flat = torch.cat([weight.reshape(-1), weight.new_zeros(1)])
    return flat[idx]


class ConvLayer(nn.Module):
    """Conv + optional ReLU (submodules.py ConvLayer, norm=None).

    ``s2d``: ``"none"``, the conv as built; ``"in_out"``, the 5x5 stride-1
    conv on an s2d input giving an s2d output; ``"in"``, the 5x5 stride-2
    conv on an s2d input giving a standard output. Both s2d forms are exact
    rewrites over the same parameters (:func:`s2d_kernel`)."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 relu=True):
        super().__init__()
        self.conv2d = CastConv2d(in_ch, out_ch, kernel_size, stride, padding)
        self.relu = relu

    def forward(self, x, s2d: str = "none"):
        if s2d == "none":
            y = self.conv2d(x)
        else:
            s2d_out = s2d == "in_out"
            conv = self.conv2d
            weight = s2d_kernel(conv.weight, s2d_out).to(x.dtype)
            bias = conv.bias.to(x.dtype)
            if s2d_out:
                bias = bias.repeat_interleave(4)
            y = F.conv2d(x, weight, bias, padding=1)
        return F.relu(y) if self.relu else y


class ConvLSTMCell(nn.Module):
    """ConvLSTM with one fused gates conv (the reference ``ConvLSTM``);
    gate order along the conv output is (i, f, o, g).

    ``fused_gates=True`` runs the pointwise tail through the K3 kernel
    (``ops/lstm_gates.py``); ``False`` keeps the plain tensor code, in the
    activation dtype as the JAX package's jnp path does.
    """

    def __init__(self, in_ch, hidden, kernel_size=3, fused_gates=False):
        super().__init__()
        self.fused_gates = fused_gates
        self.Gates = CastConv2d(
            in_ch + hidden, 4 * hidden, kernel_size, padding=kernel_size // 2
        )

    def forward(self, x, state):
        prev_hidden, prev_cell = state
        gates = self.Gates(torch.cat([x, prev_hidden.to(x.dtype)], dim=1))
        if self.fused_gates:
            h, c = fused_lstm_gates(
                nhwc(gates), nhwc(prev_cell.to(gates.dtype))
            )
            hidden, cell = nchw(h), nchw(c)
            return hidden, (hidden, cell)
        i, f, o, g = gates.chunk(4, dim=1)
        i = torch.sigmoid(i)
        f = torch.sigmoid(f)
        o = torch.sigmoid(o)
        g = torch.tanh(g)
        cell = f * prev_cell.to(f.dtype) + i * g
        hidden = o * torch.tanh(cell)
        return hidden, (hidden, cell)


class RecurrentConvLayer(nn.Module):
    """Strided ConvLayer then ConvLSTM (submodules.py RecurrentConvLayer)."""

    def __init__(self, in_ch, out_ch, fused_gates=False):
        super().__init__()
        self.conv = ConvLayer(in_ch, out_ch, 5, 2, 2)
        self.recurrent_block = ConvLSTMCell(out_ch, out_ch, 3, fused_gates)

    def forward(self, x, state, s2d: str = "none"):
        return self.recurrent_block(self.conv(x, s2d), state)


class ResidualBlock(nn.Module):
    """3x3 conv -> relu -> 3x3 conv -> +residual -> relu."""

    def __init__(self, ch):
        super().__init__()
        self.conv1 = CastConv2d(ch, ch, 3, padding=1)
        self.conv2 = CastConv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        y = F.relu(self.conv1(x))
        return F.relu(self.conv2(y) + x)


class TransposedConvLayer(nn.Module):
    """torch ``ConvTranspose2d(k=5, s=2, p=2, output_padding=1)`` (exactly
    2x upsampling, the JAX package's ``ConvTranspose2dTorch``) + ReLU."""

    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.transposed_conv2d = nn.ConvTranspose2d(
            in_ch, out_ch, 5, stride=2, padding=2, output_padding=1
        )

    def forward(self, x):
        return F.relu(self.transposed_conv2d(x))


class UNetRecurrent(nn.Module):
    """Recurrent UNet over one NCHW channels-last window with carried
    ConvLSTM states. ``forward`` returns ``(img, states, latent)`` with
    ``latent = {"1": head, "2": enc0, "4": enc1, "8": enc2}``; with
    ``decode=False`` the resblocks, decoders and pred are not built and
    ``img`` is None (the latent depends only on head and encoders).
    ``s2d=True``: the window comes space-to-depth'd (``[B, 4*bins, H/2,
    W/2]``), the head and enc0 run in that form, and ``latent["1"]`` is
    returned in it (``[B, 4*32, H/2, W/2]``)."""

    def __init__(self, num_input_channels=5, num_output_channels=1,
                 num_encoders=3, base_num_channels=32, num_residual_blocks=2,
                 decode=True, fused_gates=False):
        super().__init__()
        base = base_num_channels
        enc_out = [base * 2 ** (i + 1) for i in range(num_encoders)]
        enc_in = [base] + enc_out[:-1]
        self.head = ConvLayer(num_input_channels, base, 5, 1, 2)
        self.encoders = nn.ModuleList(
            RecurrentConvLayer(i, o, fused_gates)
            for i, o in zip(enc_in, enc_out)
        )
        self.decode = decode
        if decode:
            self.resblocks = nn.ModuleList(
                ResidualBlock(enc_out[-1]) for _ in range(num_residual_blocks)
            )
            self.decoders = nn.ModuleList(
                TransposedConvLayer(o, o // 2) for o in reversed(enc_out)
            )
            self.pred = ConvLayer(base, num_output_channels, 1, 1, 0,
                                  relu=False)

    def forward(self, x, prev_states: Sequence, s2d: bool = False):
        x = self.head(x, "in_out" if s2d else "none")
        head = x
        blocks, states = [], []
        for i, (enc, st) in enumerate(zip(self.encoders, prev_states)):
            x, st = enc(x, st, "in" if s2d and i == 0 else "none")
            blocks.append(x)
            states.append(st)
        latent = {"1": head, "2": blocks[0], "4": blocks[1], "8": blocks[2]}
        if not self.decode:
            return None, states, latent
        if s2d:
            head = F.pixel_shuffle(head, 2)
        for rb in self.resblocks:
            x = rb(x)
        for dec, skip in zip(self.decoders, reversed(blocks)):
            x = dec(x + skip)
        img = torch.sigmoid(self.pred(x + head))
        return img, states, latent


def normalize_event_window(events: torch.Tensor) -> torch.Tensor:
    """Nonzero-mean/std normalization of each sample's event tensor, biased
    std (the reference EventPreprocessor). Statistics accumulate in f32; the
    normalization runs in ``events.dtype``. Layout-independent: it reduces
    over every dim but the first."""
    nz = events != 0
    ax = tuple(range(1, events.ndim))
    ef = events.float()
    zero = torch.zeros((), device=events.device)
    cnt = nz.sum(dim=ax, keepdim=True)
    cnt_safe = torch.clamp(cnt, min=1).float()
    mean = torch.where(nz, ef, zero).sum(dim=ax, keepdim=True) / cnt_safe
    sq = torch.where(nz, ef * ef, zero).sum(dim=ax, keepdim=True) / cnt_safe
    std = torch.sqrt(torch.clamp(sq - mean * mean, min=0.0))
    std_c = torch.clamp(std, min=1e-12).to(events.dtype)
    mean = mean.to(events.dtype)
    normed = torch.where(nz, (events - mean) / std_c,
                         torch.zeros((), dtype=events.dtype,
                                     device=events.device))
    return torch.where(cnt > 0, normed, events)


def initial_stream_state(batch: int, height: int, width: int, *,
                         num_encoders: int = 3, base_num_channels: int = 32,
                         dtype=torch.float32, device=None):
    """Zero NHWC ConvLSTM states ``((h, c), ...)`` for
    :class:`E2VIDStreamingStep`, the reset the reconstructor does at the
    start of every sequence."""
    states = []
    for i in range(num_encoders):
        ch = base_num_channels * 2 ** (i + 1)
        sh = (batch, height // 2 ** (i + 1), width // 2 ** (i + 1), ch)
        states.append((torch.zeros(sh, dtype=dtype, device=device),
                       torch.zeros(sh, dtype=dtype, device=device)))
    return tuple(states)


def _step(unet, normalize, states, win, s2d=False):
    """One recurrent window: NCHW window (any memory layout), NHWC states
    -> (NHWC states, NHWC latent, NHWC img or None). ``s2d``: the window
    is space-to-depth'd first and ``latent["1"]`` stays in that form."""
    if s2d:
        win = F.pixel_unshuffle(win, 2)
    win = win.contiguous(memory_format=CL)
    if normalize:
        # nonzero mean/std over the whole window: the s2d permutation
        # leaves it exact
        win = normalize_event_window(win)
    prev = [(nchw(h), nchw(c)) for h, c in states]
    img, new_states, latent = unet(win, prev, s2d)
    new_states = tuple((nhwc(h), nhwc(c)) for h, c in new_states)
    latent = {k: nhwc(v) for k, v in latent.items()}
    return new_states, latent, None if img is None else nhwc(img)


class E2VIDStreamingStep(nn.Module):
    """One window of the E2VID recurrence, for serving.

    ``forward(states, window)`` takes a planar ``[B, bins, H, W]`` voxel
    window and the carried NHWC ConvLSTM states (zeros from
    :func:`initial_stream_state` at stream start) and returns
    ``(new_states, latent, img)``: exactly one step of
    :class:`E2VIDReconstructor`, with the same parameters. ``latent_only``
    skips (and does not build) the decode path; ``img`` is then None.
    """

    def __init__(self, num_bins=5, normalize=True, latent_only=False,
                 base_num_channels=32, fused_gates=False, unet=None):
        super().__init__()
        self.normalize = normalize
        # ``unet``: share an existing UNet (and its parameters) instead of
        # building one; see E2VIDReconstructor.streaming_step
        self.unetrecurrent = unet if unet is not None else UNetRecurrent(
            num_input_channels=num_bins, base_num_channels=base_num_channels,
            decode=not latent_only, fused_gates=fused_gates,
        )

    def forward(self, states, window):
        return _step(self.unetrecurrent, self.normalize, states, window)


class E2VIDReconstructor(nn.Module):
    """The reconstructor over T windows: a Python loop over the streaming
    step, states reset at the start of each call.

    ``forward(windows)`` takes ``[B, T, H, W, bins]`` windows (or planar
    ``[B, T, bins, H, W]`` with ``planar_input``) and returns
    ``(imgs [B, T, H, W, 1] or None, final_latent)``. ``s2d`` runs the
    head and enc0 in the space-to-depth form (module docstring) when H and
    W are even, and the standard form otherwise, as the JAX package does;
    the outputs and the parameters are the same either way.
    """

    def __init__(self, num_bins=5, normalize=True, base_num_channels=32,
                 planar_input=False, latent_only=False, fused_gates=False,
                 s2d=False):
        super().__init__()
        self.normalize = normalize
        self.s2d = s2d
        self.planar_input = planar_input
        self.base_num_channels = base_num_channels
        self.unetrecurrent = UNetRecurrent(
            num_input_channels=num_bins, base_num_channels=base_num_channels,
            decode=not latent_only, fused_gates=fused_gates,
        )

    def streaming_step(self) -> E2VIDStreamingStep:
        """The one-window step over this reconstructor's own UNet (shared
        parameters, same state-dict keys)."""
        return E2VIDStreamingStep(normalize=self.normalize,
                                  unet=self.unetrecurrent)

    def forward(self, windows):
        if self.planar_input:
            b, t, _, h, w = windows.shape
        else:
            b, t, h, w = windows.shape[:4]
        states = initial_stream_state(
            b, h, w, num_encoders=len(self.unetrecurrent.encoders),
            base_num_channels=self.base_num_channels,
            dtype=windows.dtype, device=windows.device,
        )
        s2d = self.s2d and h % 2 == 0 and w % 2 == 0
        imgs, latent = [], None
        for ti in range(t):
            win = windows[:, ti]
            if not self.planar_input:
                win = nchw(win)
            states, latent, img = _step(
                self.unetrecurrent, self.normalize, states, win, s2d
            )
            imgs.append(img)
        if s2d:
            latent = dict(latent, **{"1": nhwc(F.pixel_shuffle(
                nchw(latent["1"]), 2))})
        if imgs[0] is None:
            return None, latent
        return torch.stack(imgs, dim=1), latent
