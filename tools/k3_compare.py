#!/usr/bin/env python3
"""K3 on one CUDA card: the kernels of ``openess_tpu_torch/csrc/lstm_gates.cu``
at every shape the port's main paths give them, against their plain
versions, PyTorch's fused LSTM cell, and (with ``--triton``) the Triton
kernels they replaced, timed in turns in one process.

Run from the root of a checkout::

    python3 tools/k3_compare.py [--triton OLD/openess_tpu_torch/ops/lstm_gates.py]

where ``OLD`` is an unpacked checkout of a commit whose K3 was Triton
(``git archive 681600a | tar -x -C OLD``; needs the ``triton`` package).
Shapes: the three ConvLSTM levels at 440x640 (``chip_smoke.K3_SHAPES``)
and 200x352 (``K3_DDD17_SHAPES``), B = 8 and 1; forward and backward;
bf16 and f32. Each row times, behind the 256 MB flush of
``chip_smoke.cuda_ms``, Triton, the CUDA kernel and the library call, then
the same in reverse order; it prints both turns' medians and each one's
host time per call (enqueue only), which bounds what the flush can hide.
The backward is also checked and timed with ``dc_next = None`` (the last
window) and checked with ``dh = None``. It
prints ``ptxas`` registers and spills of every CUDA kernel and ``n_regs``
and ``n_spills`` of the compiled Triton kernels, the card's name and power
limit, and a last line of JSON with every time. Exits non-zero if a kernel
disagrees with its plain version (1 bf16 ulp + 1e-6; f32: forward 2^-20 of
the value + 1e-6, backward 1e-5 of the plain result's max).
"""
import argparse
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def error_in_bounds(torch, got, ref, bf16, bwd):
    """Max over the outputs of |got - ref| in units of its bound."""
    worst = 0.0
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        if bf16:
            tol = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7 + cs.K3_ABS_SLACK
        elif bwd:
            tol = cs.K3_BWD_F32_REL_TOL * b.abs().max()
        else:
            tol = torch.maximum(a.abs(), b.abs()) * 2.0 ** -20 + 1e-6
        worst = max(worst, (diff / tol).max().item())
    return worst


def host_us(torch, fn, n=200):
    """Host microseconds a call takes to enqueue its work (a call that
    waits for nothing), over ``n`` calls after a warm-up."""
    import time

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def load_triton(path):
    spec = importlib.util.spec_from_file_location("k3_triton", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def triton_registers(torch, old, gates, pc):
    """``{kernel: (n_regs, n_spills)}`` of the Triton kernels compiled for
    these inputs, from the ``CompiledKernel`` that a launch returns."""
    triton, fwd, bwd = old._triton_kernel()
    n_rows, block_r, block_c = old._grid(triton, pc)
    grid = (triton.cdiv(n_rows, block_r),)
    kw = dict(C=pc.shape[-1], BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4)
    with torch.cuda.device(pc.device):
        h, c = torch.empty_like(pc), torch.empty_like(pc)
        kernels = {"fwd": fwd[grid](gates, pc, h, c, n_rows, **kw),
                   "bwd": bwd[grid](gates, pc, pc, pc, torch.empty_like(gates),
                                    h, n_rows, **kw)}
    return {k: (getattr(ck, "n_regs", None), getattr(ck, "n_spills", None))
            for k, ck in kernels.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--triton", help="lstm_gates.py of a checkout whose K3 "
                    "kernels were Triton")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_compare: needs a CUDA card", file=sys.stderr)
        return 1
    from openess_tpu_torch.ops import _build
    from openess_tpu_torch.ops import lstm_gates as k3

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(f"nvidia-smi name, power.limit: {smi}")
    lib = _build.build("lstm_gates.cu")
    for name, regs, spills in cs.ptxas_kernels(lib):
        print(f"ptxas {name}: {regs} registers, {spills} bytes spilled")
    old = load_triton(args.triton) if args.triton else None

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1205)
    ms = lambda fn: cs.cuda_ms(torch, fn, flush)

    rows, worst, regs_done = [], 0.0, set()
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        size = 2 if bf16 else 4
        for frame, shapes in (("440x640", cs.K3_SHAPES),
                              ("200x352", cs.K3_DDD17_SHAPES)):
            for b in (8, 1):
                for h, w, c in shapes:
                    n = b * h * w
                    gates = (torch.randn((b, h, w, 4 * c), generator=gen,
                                         device=dev) * 2).to(dtype)
                    pc, dh, dcn = (torch.randn((b, h, w, c), generator=gen,
                                               device=dev).to(dtype)
                                   for _ in range(3))
                    if old is not None and (dtype, c) not in regs_done:
                        regs_done.add((dtype, c))
                        print(f"triton {str(dtype)[6:]} C={c}: "
                              f"{triton_registers(torch, old, gates, pc)}")
                    fwd = {"triton": (lambda: old._launch_fwd(gates, pc))
                           if old else None,
                           "cuda": lambda: k3.fused_lstm_gates(gates, pc)}
                    fwd["library"], _ = cs.k3_library_fwd(torch, gates, pc)
                    bwd = {"triton": (lambda: old.fused_lstm_gates_bwd(
                               gates, pc, dh, dcn)) if old else None,
                           "cuda": lambda: k3.fused_lstm_gates_bwd(
                               gates, pc, dh, dcn),
                           "cuda_dcn_none": lambda: k3.fused_lstm_gates_bwd(
                               gates, pc, dh, None)}
                    bwd["library"], _ = cs.k3_library_bwd(torch, gates, pc,
                                                          dh, dcn)
                    # correctness first: the CUDA kernels against plain
                    cases = [(fwd["cuda"](),
                              k3.fused_lstm_gates_plain(gates, pc), False),
                             (bwd["cuda"](), k3.fused_lstm_gates_bwd_plain(
                                 gates, pc, dh, dcn), True)]
                    for g_, n_ in ((None, dcn), (dh, None)):
                        cases.append((
                            k3.fused_lstm_gates_bwd(gates, pc, g_, n_),
                            k3.fused_lstm_gates_bwd_plain(
                                gates, pc, torch.zeros_like(pc)
                                if g_ is None else g_,
                                torch.zeros_like(pc) if n_ is None else n_),
                            True))
                    torch.cuda.synchronize()
                    err = max(error_in_bounds(torch, g_, r_, bf16, bw)
                              for g_, r_, bw in cases)
                    worst = max(worst, err)
                    del cases
                    for direction, fns, values, ops in (
                            ("fwd", fwd, 7, 30), ("bwd", bwd, 12, 60)):
                        names = [k for k, v in fns.items() if v is not None]
                        turn1 = {k: ms(fns[k]) for k in names}
                        turn2 = {k: ms(fns[k]) for k in reversed(names)}
                        host = {k: host_us(torch, fns[k]) for k in names}
                        nbytes = n * values * c * size
                        b_ms, _ = cs.bound(nbytes, n * c * ops,
                                           cs.F32_OPS_PER_S)
                        row = dict(dir=direction, dtype=str(dtype)[6:],
                                   frame=frame, shape=[b, h, w, c],
                                   bound_ms=b_ms, mb=nbytes / 1e6,
                                   err_of_bound=err, host_us=host,
                                   **{k: [turn1[k], turn2[k]] for k in names})
                        rows.append(row)
                        share = {k: b_ms / np.mean(row[k]) for k in names}
                        print(f"K3 {direction} {row['dtype']:8s} {frame} "
                              f"{b}x{h}x{w}x{c}: bound {b_ms:.4f} ms "
                              f"({nbytes / 1e6:.1f} MB); " + "; ".join(
                                  f"{k} {turn1[k]:.4f}/{turn2[k]:.4f} "
                                  f"({share[k]:.0%} of bound, host "
                                  f"{host[k]:.0f} us)" for k in names)
                              + f"; max err {err:.3f} of its bound",
                              flush=True)
                    del gates, pc, dh, dcn, fwd, bwd
    print(f"worst error of the CUDA kernels: {worst:.3f} of its bound "
          f"{'OK' if worst <= 1.0 else 'FAIL'}")
    print(smi)
    print(json.dumps({"k3": rows, "device": smi}))
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
