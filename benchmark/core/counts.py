"""The yardstick's arithmetic: the H100's peaks, the least time of a
piece of work, and the least work of each kernel's function from its
shapes. A frozen copy of ``chip_smoke.py``'s ``bound``, ``rfft_flops``
and ``work``, taking shapes in place of tensors.

Least work: each input byte read once and each output byte written once,
an rfft or irfft of n_fft points for each frame whatever the kernel runs
(2.5 n log2 n operations), masked GRU steps only passing the state on.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, dense bf16 on them, HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# kernel -> the device functions that carry it, as the trace names them
# (csrc/*.cu of the port); a kernel off the path leaves its roofline silent
KERNEL_SYMBOLS = {
    "gru_fwd": ("gru_scan_kernel", "gru_scan_bf16_kernel", "pack_overflow_kernel", "pack_fragments_kernel"),
    "gru_bwd": ("hprev_gemm_kernel", "sum_partials_kernel", "gru_bwd_rec_kernel", "col_sum_kernel"),
    "griffin_lim": ("gl_iter_kernel",),
}


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The card's least time for the work: the larger of the operations at
    the peak of their type and the bytes at the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def rfft_flops(n: int) -> float:
    """One real FFT (or inverse) of n points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def gru_fwd(b: int, t: int, h: int, dtype: str = "float32", steps: int | None = None) -> tuple[float, float]:
    """(FLOPs, bytes) of a GRU recurrence over precomputed input
    projections xw [b, t, 3h] -> ys [b, t, h] with wh [h, 3h], bh [3h];
    ``steps``: the row-steps that update the state (all b x t unless
    masked). The state stays on chip; bf16 stores 2 bytes an element."""
    steps = b * t if steps is None else steps
    el = 2 if dtype == "bfloat16" else 4
    return 2.0 * steps * h * 3 * h, el * (b * t * 3 * h + b * t * h + h * 3 * h + 3 * h)


def gru_bwd(b: int, t: int, h: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the GRU's backward pass (f32): the recurrent
    product again, dh through wh^T and dwh, from xw, ys, dys to dxw, dwh,
    dbh."""
    return 3 * 2.0 * b * t * h * 3 * h, 4 * (2 * b * t * 3 * h + 2 * b * t * h + 2 * h * 3 * h + 2 * 3 * h)


def griffin_lim(b: int, t: int, ac: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of Griffin-Lim over magnitudes [b, t, F] with
    ac["gl_iters"] iterations: one synthesis (irfft, window, overlap-add,
    envelope), then iterations + 1 rounds of analysis (window, rfft,
    projection on the magnitudes) and synthesis, the momentum a sample in
    each iteration."""
    n_iters, win, hop = ac["gl_iters"], ac["win_length"], ac["hop_length"]
    n_freq = ac["n_fft"] // 2 + 1
    syn = rfft_flops(ac["n_fft"]) + 2 * win + hop
    ana = win + rfft_flops(ac["n_fft"]) + 8 * n_freq
    fl = b * t * (syn + (n_iters + 1) * (ana + syn) + n_iters * 3 * hop)
    return fl, 4 * (b * t * n_freq + b * (t - 1) * hop)

