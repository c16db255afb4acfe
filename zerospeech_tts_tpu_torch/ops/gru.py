"""Kernel 2: GRU recurrence over precomputed input projections (port of
``zerospeech_tts_tpu/ops/pallas_gru.py::pallas_gru_scan``; CUDA source
``csrc/gru.cu``).

Cell math (gate order r, z, n; models/layers.py GRU):

    hw = h @ wh + bh;   r = sig(xr + hw_r);  z = sig(xz + hw_z)
    n  = tanh(xn + r * hw_n);                h' = (1 - z) n + z h

``reverse`` scans back to front (outputs in original time order); with
``lengths`` the reversed state passes through steps at ``t >= lengths[b]``
so each row's first real step sees h0 = 0 (padding-invariant bucketed
encoding). :func:`gru_scan` launches the kernel on a CUDA tensor and runs
:func:`gru_scan_plain` on a CPU tensor; any other device raises.
"""

from __future__ import annotations

import torch

from zerospeech_tts_tpu_torch.ops import build

launches = 0  # kernel launches through gru_scan (one per whole recurrence)


def _check_args(xw, wh, bh, lengths, reverse):
    if lengths is not None and not reverse:
        raise NotImplementedError(
            "masked gru_scan implements the REVERSED padded-bucket semantics "
            "only; forward scans over padded buckets need no mask (pad steps "
            "trail the true tail and their outputs are discarded)"
        )
    b, t, h3 = xw.shape
    h = h3 // 3
    if h3 != 3 * h or tuple(wh.shape) != (h, h3) or tuple(bh.shape) != (h3,):
        raise ValueError(f"shapes xw {tuple(xw.shape)}, wh {tuple(wh.shape)}, bh {tuple(bh.shape)}")
    return b, t, h


def gru_scan_plain(xw, wh, bh, lengths=None, *, reverse: bool = False):
    """Plain PyTorch version: xw [B, T, 3H], wh [H, 3H], bh [3H], lengths
    [B] -> ys [B, T, H]."""
    b, t, h = _check_args(xw, wh, bh, lengths, reverse)
    hcur = xw.new_zeros(b, h)
    ys = xw.new_empty(b, t, h)
    for ti in range(t - 1, -1, -1) if reverse else range(t):
        hw = hcur @ wh + bh
        xr, xz, xn = xw[:, ti].split(h, dim=-1)
        hr, hz, hn = hw.split(h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        hnew = (1.0 - z) * n + z * hcur
        if lengths is not None:
            hnew = torch.where((ti < lengths)[:, None], hnew, hcur)
        ys[:, ti] = hnew
        hcur = hnew
    return ys


def gru_scan(xw, wh, bh, lengths=None, *, reverse: bool = False):
    """Same contract as :func:`gru_scan_plain`; the CUDA kernel (one launch
    per step, all issued from one C call) on a CUDA tensor."""
    if xw.device.type == "cpu":
        return gru_scan_plain(xw, wh, bh, lengths, reverse=reverse)
    b, t, h = _check_args(xw, wh, bh, lengths, reverse)
    build.require(xw, "gru xw", (b, t, 3 * h))
    build.require(wh, "gru wh", (h, 3 * h), device=xw.device)
    build.require(bh, "gru bh", (3 * h,), device=xw.device)
    if lengths is not None:
        build.require(lengths, "gru lengths", (b,), dtype=torch.int32, device=xw.device)
    ys = torch.empty(b, t, h, device=xw.device)
    lib = build.load("gru")
    fn = build.bind(lib, "zs_gru_scan", 5, 4)
    err = fn(
        xw.data_ptr(), wh.data_ptr(), bh.data_ptr(),
        None if lengths is None else lengths.data_ptr(), ys.data_ptr(),
        b, t, h, int(reverse), build.stream_of(xw),
    )
    build.check(lib, err, "gru kernel")
    global launches
    launches += 1
    return ys
