"""Kernels 2 and 3: the GRU recurrence over precomputed input projections
and its backward pass (ports of ``zerospeech_tts_tpu/ops/pallas_gru.py``
``pallas_gru_scan`` and ``_gru_bwd_call``; CUDA sources ``csrc/gru.cu`` and
``csrc/gru_bwd.cu``).

Cell math (gate order r, z, n; models/layers.py GRU):

    hw = h @ wh + bh;   r = sig(xr + hw_r);  z = sig(xz + hw_z)
    n  = tanh(xn + r * hw_n);                h' = (1 - z) n + z h

``reverse`` scans back to front (outputs in original time order); with
``lengths`` the reversed state passes through steps at ``t >= lengths[b]``
so each row's first real step sees h0 = 0 (padding-invariant bucketed
encoding). :func:`gru_scan` launches the kernel on a CUDA tensor and runs
:func:`gru_scan_plain` on a CPU tensor; any other device raises.

Two storage types, as ``pallas_gru_scan``: f32, or bf16 ``xw``/``wh``/``bh``
and ``ys`` (``ops.KERNELS["gru_bf16"]``, its own kernel ``csrc/gru_bf16.cu``,
the product on the tensor cores) with the state kept in f32 across the
whole scan, each step's product taking h rounded to bf16 (exact products,
f32 sums) and ``ys`` storing h rounded to bf16.

Training differentiates through :class:`GRUScan`: kernel 2 forward,
kernel 3 (:func:`gru_bwd`, plain version :func:`gru_bwd_plain`) backward.
Backward math (``pallas_gru.py:195-207``), walking the scan's steps
backwards with h_{t-1} = ys one step earlier in the scan's own order (0 at
its first step) and r, z, n recomputed from it:

    dh    += dys_t                   (carry from t+1 starts at 0)
    dn^    = dh (1-z) (1-n^2);       dz^ = dh (h_{t-1} - n) z (1-z)
    dr^    = dn^ hw_n r (1-r);       dxw_t = [dr^, dz^, dn^]
    dhw    = [dr^, dz^, dn^ r];      dh_{t-1} = dh z + dhw wh^T
    dwh   += h_{t-1}^T dhw;          dbh += sum_B dhw
"""

from __future__ import annotations

import ctypes
import functools

import torch

from zerospeech_tts_tpu_torch.ops import build

launches = 0  # kernel-2 f32 launches through gru_scan (one cooperative launch per scan)
bf16_launches = 0  # kernel-2 bf16 launches through gru_scan
bwd_launches = 0  # kernel-3 launches through gru_bwd (one per whole backward pass)

_DTYPES = (torch.float32, torch.bfloat16)  # kernel 2's storage types


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
    [B] -> ys [B, T, H] of xw's dtype. In bf16 the state and the gates are
    f32, each step's product takes h rounded to bf16 and sums in f32 (an
    f32 product of bf16 values: a bf16 ``@`` would round its sums), and
    ``ys`` stores h rounded to bf16. In f32 every cast is a no-op."""
    b, t, h = _check_args(xw, wh, bh, lengths, reverse)
    ct = torch.float32 if xw.dtype == torch.bfloat16 else xw.dtype  # the state's and the gates' type
    hcur = xw.new_zeros(b, h, dtype=ct)
    ys = xw.new_empty(b, t, h)
    wh_c, bh_c = wh.to(ct), bh.to(ct)
    for ti in range(t - 1, -1, -1) if reverse else range(t):
        hw = hcur.to(wh.dtype).to(ct) @ wh_c + bh_c
        xr, xz, xn = xw[:, ti].to(ct).split(h, dim=-1)
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


_BAR_WORDS = 32  # zs_gru_scan: barrier words a batch group (a 128-byte line each)


def scan_plan(device: torch.device, b: int, h: int, dtype: torch.dtype = torch.float32) -> tuple[int, ...]:
    """The spread of kernel 2 that ``zs_gru_scan`` (csrc/gru.cu) or, for
    bf16, ``zs_gru_scan_bf16`` (csrc/gru_bf16.cu) picks for b rows on
    ``device`` (their ``make_plan``): hidden columns a block, column
    groups, batch rows a block, batch groups, rows staged a chunk, a
    block's dynamic shared memory in bytes, rows a launch, 1 when a thread
    holds its share of wh in registers, Hs (the rows of a block's columns
    of wh on chip: h, unless the spread is wide and reads the rest from a
    packed copy through L2), and the elements of that copy; all 0 when
    none fits."""
    bf16 = dtype == torch.bfloat16
    lib = build.load("gru_bf16" if bf16 else "gru")
    plan = torch.zeros(10, dtype=torch.int32)
    with torch.cuda.device(device):
        err = build.bind(lib, "zs_gru_scan_bf16_plan" if bf16 else "zs_gru_scan_plan", 1, 2, stream=False)(
            plan.data_ptr(), b, h)
    build.check(lib, err, "gru plan")
    return tuple(plan.tolist())


@functools.lru_cache(maxsize=None)
def _pack_elems(device_index: int, b: int, h: int, dtype: torch.dtype) -> int:
    """Elements of kernel 2's packed copy of wh for this shape (0 unless
    the spread is wide); a pure function of the card and the shape."""
    return scan_plan(torch.device("cuda", device_index), b, h, dtype)[9]


def gru_scan(xw, wh, bh, lengths=None, *, reverse: bool = False):
    """Same contract as :func:`gru_scan_plain`; kernel 2 on a CUDA tensor,
    all in f32 (csrc/gru.cu) or all in bf16 (csrc/gru_bf16.cu: the product
    on the tensor cores, the f32 state on chip): ONE cooperative launch
    runs all T steps (at most a block per SM, each owning some hidden
    columns and batch rows with its columns of wh on chip, a barrier per
    batch group between steps). Any B (a batch too large for the shared
    memory runs in slices, a launch each) and any H: where a block's
    columns of wh (ceil(H / SMs) x 3H values) outgrow its shared memory (H
    above ~1,550 in f32, ~2,110 in bf16 on an H100), it keeps the first Hs
    rows there and reads the rest each step from a copy packed for it
    (scratch allocated here)."""
    if xw.device.type == "cpu":
        return gru_scan_plain(xw, wh, bh, lengths, reverse=reverse)
    b, t, h = _check_args(xw, wh, bh, lengths, reverse)
    dt = xw.dtype if xw.dtype in _DTYPES else torch.float32  # anything else fails require below
    build.require(xw, "gru xw", (b, t, 3 * h), dtype=dt)
    build.require(wh, "gru wh", (h, 3 * h), dtype=dt, device=xw.device)
    build.require(bh, "gru bh", (3 * h,), dtype=dt, device=xw.device)
    if lengths is not None:
        build.require(lengths, "gru lengths", (b,), dtype=torch.int32, device=xw.device)
    ys = torch.empty(b, t, h, device=xw.device, dtype=dt)
    n_sm = torch.cuda.get_device_properties(xw.device).multi_processor_count
    bar = torch.empty(_BAR_WORDS * n_sm, dtype=torch.int32, device=xw.device)  # scratch: group counters
    n_launches = ctypes.c_int(0)
    lib = build.load("gru" if dt == torch.float32 else "gru_bf16")
    n_pack = _pack_elems(xw.device.index, b, h, dt) if b else 0
    wpack = torch.empty(n_pack, device=xw.device, dtype=dt) if n_pack else None  # scratch: wh past Hs
    fn = build.bind(lib, "zs_gru_scan" if dt == torch.float32 else "zs_gru_scan_bf16", 8, 4)
    with build.on_card(xw):
        err = fn(xw.data_ptr(), wh.data_ptr(), bh.data_ptr(), None if lengths is None else lengths.data_ptr(),
                 None if wpack is None else wpack.data_ptr(), ys.data_ptr(), bar.data_ptr(),
                 ctypes.addressof(n_launches), b, t, h, int(reverse), build.stream_of(xw))
    build.check(lib, err, "gru kernel")
    global launches, bf16_launches
    if dt == torch.float32:
        launches += n_launches.value
    else:
        bf16_launches += n_launches.value
    return ys


def _bwd_check(xw, wh, bh, ys, dys):
    b, t, h = _check_args(xw, wh, bh, None, False)
    if tuple(ys.shape) != (b, t, h) or tuple(dys.shape) != (b, t, h):
        raise ValueError(f"shapes ys {tuple(ys.shape)}, dys {tuple(dys.shape)}: expected {(b, t, h)}")
    return b, t, h


def gru_bwd_plain(xw, wh, bh, ys, dys, *, reverse: bool = False):
    """Plain PyTorch version of kernel 3, the backward pass of the unmasked
    scan, step by step: (xw [B, T, 3H], wh [H, 3H], bh [3H], ys, dys
    [B, T, H]) -> (dxw [B, T, 3H], dwh [H, 3H], dbh [3H]). ``reverse``: the
    scan ran back to front (:func:`gru_scan` with ``reverse=True``), so
    h_{t-1} is ``ys[:, t+1]`` and the backward pass walks time forwards."""
    b, t, h = _bwd_check(xw, wh, bh, ys, dys)
    zero = ys.new_zeros(b, 1, h)
    hprev = torch.cat([ys[:, 1:], zero], dim=1) if reverse else torch.cat([zero, ys[:, :-1]], dim=1)
    dh = xw.new_zeros(b, h)
    dxw = torch.empty_like(xw)
    dwh = wh.new_zeros(h, 3 * h)
    dbh = bh.new_zeros(3 * h)
    for ti in range(t) if reverse else range(t - 1, -1, -1):
        hp = hprev[:, ti]
        hw = hp @ wh + bh
        xr, xz, xn = xw[:, ti].split(h, dim=-1)
        hr, hz, hn = hw.split(h, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        dh = dh + dys[:, ti]
        dn = dh * (1.0 - z) * (1.0 - n * n)
        dz = dh * (hp - n) * z * (1.0 - z)
        dr = dn * hn * r * (1.0 - r)
        dxw[:, ti] = torch.cat([dr, dz, dn], dim=-1)
        dhw = torch.cat([dr, dz, dn * r], dim=-1)
        dh = dh * z + dhw @ wh.T
        dwh = dwh + hp.T @ dhw
        dbh = dbh + dhw.sum(0)
    return dxw, dwh, dbh


def bwd_plan(device: torch.device, b: int, h: int) -> tuple[int, ...]:
    """The spread of kernel 3's dh recurrence that ``zs_gru_bwd`` picks
    on ``device`` (csrc/gru_bwd.cu ``make_plan``): dh columns and batch
    rows a block, staged rows a chunk, column groups, batch groups, a
    block's dynamic shared memory in bytes, and Hs (the rows of wh a batch
    group holds in shared memory: h, unless the spread is wide and reads
    the rest from wh each step); all 0 when none fits."""
    lib = build.load("gru_bwd")
    plan = torch.zeros(7, dtype=torch.int32)
    with torch.cuda.device(device):
        err = build.bind(lib, "zs_gru_bwd_plan", 1, 2, stream=False)(plan.data_ptr(), b, h)
    build.check(lib, err, "gru_bwd plan")
    return tuple(plan.tolist())


def gru_bwd(xw, wh, bh, ys, dys, *, reverse: bool = False):
    """Same contract as :func:`gru_bwd_plain`; kernel 3 (csrc/gru_bwd.cu)
    on a CUDA tensor: a parallel pass for hw = h_{t-1} wh + bh, ONE
    cooperative launch for the whole serial dh recurrence (at most a block
    per SM, each owning some batch rows and columns of dh with its rows of
    wh resident in shared memory, a barrier per batch group between
    steps), then a tiled reduction for dwh and a column sum for dbh, all
    issued from one C call. Any B and any H: where a block's rows of wh
    (ceil(H / SMs) x 3H f32) outgrow its shared memory (H above ~1,480 on
    an H100), it keeps the first of them there and reads the others from
    wh each step."""
    if xw.device.type == "cpu":
        return gru_bwd_plain(xw, wh, bh, ys, dys, reverse=reverse)
    b, t, h = _bwd_check(xw, wh, bh, ys, dys)
    for arr, what, shape in ((xw, "xw", (b, t, 3 * h)), (wh, "wh", (h, 3 * h)), (bh, "bh", (3 * h,)),
                             (ys, "ys", (b, t, h)), (dys, "dys", (b, t, h))):
        build.require(arr, f"gru_bwd {what}", shape, device=xw.device)
    dev = xw.device
    dxw = torch.empty(b, t, 3 * h, device=dev)
    dwh = torch.empty(h, 3 * h, device=dev)
    dbh = torch.empty(3 * h, device=dev)
    hw = torch.empty(b, t, 3 * h, device=dev)  # scratch: h_{t-1} wh + bh
    dhw = torch.empty(b, t, 3 * h, device=dev)  # scratch: recurrent-gate grads
    carry = torch.empty(2, b, h, device=dev)  # scratch: the dh carry (dh z, dhw wh^T)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    bar = torch.empty(2 * n_sm, dtype=torch.int32, device=dev)  # scratch: group barriers
    lib = build.load("gru_bwd")
    fn = build.bind(lib, "zs_gru_bwd", 13, 4)
    with build.on_card(xw):
        err = fn(
            xw.data_ptr(), wh.data_ptr(), bh.data_ptr(), ys.data_ptr(), dys.data_ptr(),
            dxw.data_ptr(), dwh.data_ptr(), dbh.data_ptr(), hw.data_ptr(), dhw.data_ptr(),
            carry[0].data_ptr(), carry[1].data_ptr(), bar.data_ptr(), b, t, h, int(reverse),
            build.stream_of(xw),
        )
    build.check(lib, err, "gru_bwd kernel")
    global bwd_launches
    bwd_launches += 1
    return dxw, dwh, dbh


class GRUScan(torch.autograd.Function):
    """Differentiable unmasked GRU scan (the counterpart of
    ``pallas_gru.py::gru_scan_diff``): kernel 2 forward, kernel 3 backward
    on CUDA tensors, their plain versions on CPU tensors. Both walk a
    reverse scan's time the other way themselves (no flipped copies)."""

    @staticmethod
    def forward(ctx, xw, wh, bh, reverse: bool):
        xw = xw.contiguous()
        ys = gru_scan(xw, wh, bh, reverse=reverse)
        ctx.reverse = reverse
        ctx.save_for_backward(xw, wh, bh, ys)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xw, wh, bh, ys = ctx.saved_tensors
        dxw, dwh, dbh = gru_bwd(xw, wh, bh, ys, dys.contiguous(), reverse=ctx.reverse)
        return dxw, dwh, dbh, None
