#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zerospeech_tts_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Refuses to run without a CUDA card (or outside a checkout of the repo).
2. Builds the hand-written kernels from their four csrc/ sources with nvcc
   (sm_90a), all at once, and prints kernel 2's spread and its widest H in
   f32 and in bf16.
3. Holds each kernel against its plain PyTorch version on the card at its
   path's flagship shapes (kernel 1 also on full-scale frames) and times
   both, beside the card's least time for
   the same work and, where one PyTorch call computes the same function,
   that call's time; holds GRUScan's gradients against cuDNN nn.GRU;
   prints kernel 2's spread (column x batch groups, shared memory) at the
   paths' batch sizes and its time a step at B=16 for T=64 and T=512 (the
   per-step chain apart from the launch's fixed cost); kernel 2's bf16 mode
   at the test shapes and its widest H, within 2^-8 of its plain version
   and far nearer it than a control that rounds the state to bf16 between
   steps, timed beside its bound and cuDNN nn.GRU forward in bf16.
4. Conversion path: converts a seeded 8-wav, 2-target corpus at flagship
   width (hps/zerospeech.json, random weights from a seed, GL-100) through
   the port's CLI, counting kernel launches and keeping each kernel's
   inputs, checks the outputs, times kernels 1, 2 and 4 at the path's own
   inputs (beside their plain versions and bounds; kernel 2 also per
   step), holds kernels 1 and 2 at those inputs (hold_path_calls) and
   Griffin-Lim at GL-100 on each of the path's buckets
   against its plain version (and times the same recurrence as a loop of
   torch.fft calls, a yardstick), and holds the card's conversion of one
   utterance against the plain CPU path.
4b. The same conversion with --bf16 and with --bf16 --enc-f32 (units
   against the exact route: > 0.9 and >= 0.999; kernel 2 in both modes and
   kernel 4 held at every captured input), then the serve verb in a thread
   on 127.0.0.1 (two bursts of 8 /convert and 4 /units: fewer dispatches
   than requests, the CLI's units, 16 kHz PCM16, p50/p95 latency).
5. Corpus path: a seeded test split (4 speakers x 6 wavs of 1-8 s and one
   of 27 s) through the CLI at flagship width with the same bundle:
   preprocess (kernel 1) -> convert from the corpus (a) --units-only, (b)
   uniform buckets at GL-100, (c) --adaptive-buckets 4 --bucket-cost-model
   executed --frame-budget 8192 at GL-100 -> convert --units-only
   --from-wavs (kernels 1, 2) -> eval --units -> submission -> submission
   --validate, each route's launches counted apart and each kernel's
   inputs kept. Holds kernels 1, 2 and 4 at every input a route gave them
   against their plain versions (hold_path_calls states the bars). Checks
   (a) == (b) bit for bit, every bit where (c) differs from (b) within a
   1e-4 logit margin of the plain CPU encoder, no Griffin-Lim launch on a
   units-only route and no frontend launch on a corpus-feature route, and
   the validator's ok; runs (b) and (c) again (order b, c, c, b, b, c)
   and prints their conversion seconds (the CLI's own) and walls, plan
   and kernel path times, and kernel 2's time a step at 128, 192 and 256
   rows.
6. Training path: a seeded 6-speaker wav corpus through the CLI at
   flagship width: preprocess -> train1 (4 iterations a phase) -> train1
   resumed -> train2 (one GAN cycle) -> export, counting kernel launches
   and timing kernel 3 at the path's own inputs, then convert with the
   trained bundle, counted apart; checks losses,
   parameter updates and gradients; then one pretrain_AE and one train
   step on the card against the CPU from the same state and the same draws,
   with the CPU replaying the card's hard decisions and few of its own
   differing. Then a mel run at flagship width (n_feat = 80): preprocess ->
   train1 -> train2 --data-bf16 -> export --feat mel -> convert, kernel
   4's lifted magnitudes held against a float64 lift.
7. Prints the card (nvidia-smi name, power limit), one JSON line with the
   kernels' results (``launches``: the count on the path the kernel's slice
   ported, conversion or training; ``launches_by_path``: each path's own
   count, the corpus routes among them; ``ms``/``plain_ms``/``bound_ms`` at the test shapes, ``path_*``
   summed over that path's calls), and as the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check raises, so the run exits non-zero and prints no last line.
Scratch files go to build/chip_smoke/ inside the checkout.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "chip_smoke"
SRC = "zerospeech_tts_tpu_torch/csrc"
REPLACES = {
    "frontend": "zerospeech_tts_tpu/ops/pallas_frontend.py:74",
    "gru": "zerospeech_tts_tpu/ops/pallas_gru.py:84",
    "gru_bf16": "zerospeech_tts_tpu/ops/pallas_gru.py:84 (bf16 mode)",
    "gru_bwd": "zerospeech_tts_tpu/ops/pallas_gru.py:218",
    "griffin_lim": "zerospeech_tts_tpu/ops/pallas_gl.py:470",
}
# H100 SXM peaks: f32 outside the tensor cores, dense bf16 on them, HBM
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16_ULP = 2.0**-8  # kernel 2's bf16 bar: one bf16 ulp at |y| in [0.5, 1), the GRU's range
# and its second: mean |kernel - plain| at most this share of mean |control
# - plain|, the control rounding its state to bf16 between steps (a kernel
# doing that sits near 1; summation order alone, far below)
BF16_CONTROL_RATIO = 0.5
BF16_CONTROL = {}  # where -> the kernel's and the control's distances from the plain version


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    from zerospeech_tts_tpu_torch.tools.workload import card

    line = card()
    check(line != "", "nvidia-smi named no card")
    return line.splitlines()[0]


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> dict:
    """The card's least time for the work: the larger of FLOPs at the peak
    of their type (f32 unless given) and bytes (each input read once, each
    output written once) at the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


PEAKS = {"gru_bf16": PEAK_BF16_FLOPS}  # a kernel's operations at their type's peak (f32 otherwise)


def rfft_flops(n: int) -> float:
    """Operations of one real FFT (or inverse) of n points: 2.5 n log2 n,
    half the usual 5 n log2 n of a complex one. The least work of a DFT,
    whatever the kernel does (kernels 1 and 4 run packed complex four-step
    FFTs, kernel 1 also direct sums for its near-floor bins)."""
    return 2.5 * n * math.log2(n)


def rel_l2(a, b) -> float:
    import torch

    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


# kernel -> (module in ops/, wrapper, plain version): both take the same
# arguments; kernel 2's two modes share a wrapper, which dispatches on xw's dtype
KERNEL_FNS = {
    "frontend": ("frontend", "fused_frontend", "frontend_plain"),
    "gru": ("gru", "gru_scan", "gru_scan_plain"),
    "gru_bf16": ("gru", "gru_scan", "gru_scan_plain"),
    "gru_bwd": ("gru", "gru_bwd", "gru_bwd_plain"),
    "griffin_lim": ("griffin_lim", "griffin_lim", "griffin_lim_plain"),
}


def kernel_fns(name: str):
    import importlib

    mod_name, fn, plain = KERNEL_FNS[name]
    mod = importlib.import_module(f"zerospeech_tts_tpu_torch.ops.{mod_name}")
    return mod, getattr(mod, fn), getattr(mod, plain)


@contextmanager
def capture(names, store: dict):
    """While active, each named kernel wrapper keeps a copy of the inputs
    of its first call with each distinct signature (tensor shapes and the
    other arguments) and counts the calls, in store[name][key] = [args,
    kwargs, count], then calls through; "gru" keeps its bf16 calls under
    "gru_bf16" (kernel 2's bf16 mode). The wrapper is replaced in every
    module of the port that holds it, and restored on exit."""
    import torch

    def sig(a):
        return ("tensor", tuple(a.shape)) if isinstance(a, torch.Tensor) else repr(a)

    def keep(a):
        return a.detach().clone() if isinstance(a, torch.Tensor) else a

    patched = []
    for name in names:
        orig = kernel_fns(name)[1]
        calls = store.setdefault(name, {})

        def wrapper(*args, _orig=orig, _calls=calls, _name=name, **kw):
            if _name == "gru" and args[0].dtype == torch.bfloat16:
                _calls = store.setdefault("gru_bf16", {})
            key = tuple(sig(a) for a in args) + tuple((k, sig(v)) for k, v in sorted(kw.items()))
            if key not in _calls:
                _calls[key] = [[keep(a) for a in args], {k: keep(v) for k, v in kw.items()}, 0]
            _calls[key][2] += 1
            return _orig(*args, **kw)

        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("zerospeech_tts_tpu_torch") \
                    and getattr(mod, KERNEL_FNS[name][1], None) is orig:
                setattr(mod, KERNEL_FNS[name][1], wrapper)
                patched.append((mod, KERNEL_FNS[name][1], orig))
    try:
        yield store
    finally:
        for mod, attr, orig in patched:
            setattr(mod, attr, orig)


def work(name: str, args, kw) -> tuple[float, float]:
    """(FLOPs, bytes) of the least work of one call of a kernel's function
    on these inputs: each input read once, each output written once; for
    the frontend and Griffin-Lim an rfft or irfft of n_fft points per frame,
    whatever the kernel runs, and for the frontend's mel product the mel
    basis's nonzeros only (each bin lies in at most two bands)."""
    if name == "frontend":
        from zerospeech_tts_tpu_torch.ops.frontend import mel_bands

        ypad, cfg, t = args
        b, nf, nm = ypad.shape[0], cfg.n_freq, cfg.n_mels
        nnz = mel_bands(cfg)[1].size
        # a frame: window, rfft, |.|, mel product over the nonzeros, both dB-norms
        fl = b * t * (cfg.win_length + rfft_flops(cfg.n_fft) + 4 * nf + 2 * nnz + 5 * (nf + nm))
        return fl, 4 * (ypad.numel() + nnz + cfg.win_length + b * t * (nf + nm))
    if name in ("gru", "gru_bf16"):  # bf16: 2-byte xw, wh, bh and ys (the f32 state is scratch)
        xw, wh, bh = args[:3]
        lengths = args[3] if len(args) > 3 else kw.get("lengths")
        b, t, h3 = xw.shape
        h = h3 // 3
        steps = b * t if lengths is None else int(lengths.sum())  # masked steps only pass the state on
        return 2 * steps * h * h3, xw.element_size() * (b * t * h3 + b * t * h + h * h3 + h3)
    if name == "gru_bwd":
        b, t, h3 = args[0].shape
        h = h3 // 3
        return 3 * 2 * b * t * h * h3, 4 * (2 * b * t * h3 + 2 * b * t * h + 2 * h * h3 + 2 * h3)
    mag, cfg = args[:2]
    n_iters = kw.get("n_iters", args[2] if len(args) > 2 else None)
    n_iters = cfg.gl_iters if n_iters is None else n_iters
    b, t, _ = mag.shape
    win, hop = cfg.win_length, cfg.hop_length
    # a frame: synthesis = irfft, window, overlap-add, wss scale; analysis =
    # window, rfft, projection onto the magnitudes; the momentum per sample.
    # One synthesis, then n_iters + 1 rounds of both, momentum in n_iters.
    syn = rfft_flops(cfg.n_fft) + 2 * win + hop
    ana = win + rfft_flops(cfg.n_fft) + 8 * cfg.n_freq
    fl = b * t * (syn + (n_iters + 1) * (ana + syn) + n_iters * 3 * hop)
    return fl, 4 * (mag.numel() + b * (t - 1) * hop)


def path_times(name: str, calls: dict) -> dict:
    """A kernel's time, its plain version's time and the bound, summed over
    the calls of a main path: each distinct signature timed once and
    weighted by its count."""
    from zerospeech_tts_tpu_torch.tools.workload import cuda_ms

    _, kfn, pfn = kernel_fns(name)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0, shapes=[])
    for args, kw, count in calls.values():
        k_ms = cuda_ms(lambda: kfn(*args, **kw), 3)
        p_ms = cuda_ms(lambda: pfn(*args, **kw), 1)
        bnd = bound(*work(name, args, kw), peak=PEAKS.get(name, PEAK_F32_FLOPS))["bound_ms"]
        tot["ms"] += count * k_ms
        tot["plain_ms"] += count * p_ms
        tot["bound_ms"] += count * bnd
        tot["launches"] += count
        tot["shapes"].append(dict(shape=[tuple(a.shape) for a in args if hasattr(a, "shape")][0],
                                  count=count, ms=k_ms, plain_ms=p_ms, bound_ms=bnd))
    return tot


def gl_consistency(out, amp, cfg) -> float:
    """Griffin-Lim's spectral consistency: rel-L2 of the STFT magnitude of
    the signal ``out`` against the magnitudes ``amp`` it was made from,
    four frames in from each end."""
    import torch

    from zerospeech_tts_tpu_torch.dsp import audio

    re, im = audio.stft(out, cfg)
    m2 = torch.sqrt(re * re + im * im)[:, 4:-4]
    m = amp[:, 4:-4]
    return (torch.linalg.norm(m2 - m) / torch.linalg.norm(m)).item()


def frontend_f64(ypad, cfg, n_frames):
    """The plain frontend's linear magnitudes [B, T, F] in float64 (its f32
    bases and signal, summed exactly enough to arbitrate between two f32
    sums near the dB floor)."""
    import torch

    from zerospeech_tts_tpu_torch.dsp import audio

    ca, sa, _, _ = audio._fused_bases(cfg)
    segs = audio._fused_segments(ypad.double(), cfg, n_frames)
    re = segs @ torch.from_numpy(ca).to(ypad.device).double()
    im = segs @ torch.from_numpy(sa).to(ypad.device).double()
    return torch.sqrt(re * re + im * im + 1e-12)


def hold_path_calls(name: str, calls: dict, where: str) -> float:
    """Each distinct input a kernel met on a main path (as ``capture`` kept
    it) through the kernel and its plain version; fails on a bar, returns
    the largest kernel-vs-plain difference (kernel 4: of consistency).

    Kernel 2, and kernel 1's mel: max_abs_err <= 1e-4; kernel 2 in bf16:
    within one bf16 ulp at the top of the GRU's range (2^-8; the share of
    equal elements is printed: the kernel and the plain version sum each
    product in other f32 orders, and once a state on a bf16 rounding
    boundary rounds apart for the next product the two drift ~1e-4 apart),
    and, over all the calls, a mean |kernel - plain| at most
    BF16_CONTROL_RATIO of the mean |control - plain| of a control that
    rounds the state to bf16 between steps (tools/workload.py
    ``gru_scan_bf16_state``), which the one-ulp bar alone does not tell
    from an f32 state on a short scan. Kernel 4: the two
    signals' consistency with the magnitudes within 1e-3. Kernel 1's
    magnitudes: within 1e-4 of the plain version's, except near the dB
    floor, where the norm's slope (0.087 / m) turns the rounding of any
    f32 sum into more: an element that differs by more than 1e-4 must lie
    in the kernel's near-floor range (float64 magnitude from 9e-5 to the
    larger of 1e-2 and 3e-4 of its frame's largest), and there the kernel
    must be no farther from the float64 evaluation than the larger of 1e-4
    and the plain version's own largest distance from it in that call."""
    import torch

    from zerospeech_tts_tpu_torch.dsp import audio
    from zerospeech_tts_tpu_torch.tools.workload import gru_scan_bf16_state

    _, kfn, pfn = kernel_fns(name)
    worst = 0.0
    far = dict(kernel=0.0, control=0.0, equal_kernel=0, equal_control=0, n=0)  # gru_bf16: sums over the calls
    for args, kw, _ in calls.values():
        out_k = kfn(*args, **kw)
        torch.cuda.synchronize()
        out_p = pfn(*args, **kw)
        shape = tuple(args[0].shape)
        if name == "griffin_lim":
            err = abs(gl_consistency(out_k, args[0], args[1]) - gl_consistency(out_p, args[0], args[1]))
            check(bool(torch.isfinite(out_k).all()) and err <= 1e-3,
                  f"{where}: griffin_lim at {shape}: consistency differs from the plain version's by {err}")
        elif name == "gru":
            err = (out_k - out_p).abs().max().item()
            check(err <= 1e-4, f"{where}: gru at {shape} {kw}: max_abs_err {err} (atol 1e-4)")
        elif name == "gru_bf16":
            d = (out_k.float() - out_p.float()).abs()
            d_c = (gru_scan_bf16_state(*args, **kw).float() - out_p.float()).abs()
            err, equal = d.max().item(), (d == 0).float().mean().item()
            print(f"  {where}: gru_bf16 at {shape} {kw}: max_abs_err {err:.3e} (<= 2^-8), {equal:.4%} of the "
                  f"elements equal; mean |diff| {d.mean().item():.3e}, the bf16-state control's "
                  f"{d_c.mean().item():.3e} ({(d_c == 0).float().mean().item():.4%} equal)", flush=True)
            check(out_k.dtype == torch.bfloat16 and err <= BF16_ULP,
                  f"{where}: gru_bf16 at {shape} {kw}: max_abs_err {err} (<= 2^-8)")
            for key, dd in (("kernel", d), ("control", d_c)):
                far[key] += dd.sum().item()
                far[f"equal_{key}"] += int((dd == 0).sum())
            far["n"] += d.numel()
        else:
            (mel_k, mag_k), (mel_p, mag_p) = out_k, out_p
            err_mel = (mel_k - mel_p).abs().max().item()
            check(err_mel <= 1e-4, f"{where}: frontend mel at {shape}: max_abs_err {err_mel} (atol 1e-4)")
            d = (mag_k - mag_p).abs()
            err = max(err_mel, d.max().item())
            over = d > 1e-4
            if over.any():
                lin = frontend_f64(*args)
                ref = audio.amp_to_db_norm(lin, args[1])
                near = (lin >= 9e-5) & (lin < torch.clamp(3e-4 * lin.amax(-1, keepdim=True), min=1e-2))
                e_k = (mag_k.double() - ref).abs()[over].max().item()
                e_p = (mag_p.double() - ref).abs().max().item()
                print(f"  {where}: frontend at {shape}: {int(over.sum())} magnitudes differ from the plain "
                      f"version's by more than 1e-4 (largest {d.max().item():.3e}), all near the floor: "
                      f"{bool(near[over].all())}; there the kernel is {e_k:.3e} from float64, the plain "
                      f"version up to {e_p:.3e}", flush=True)
                check(bool(near[over].all()) and e_k <= max(1e-4, e_p),
                      f"{where}: frontend at {shape}: magnitudes {err} from the plain version's; near floor "
                      f"{bool(near[over].all())}, kernel {e_k} and plain {e_p} from float64")
        worst = max(worst, err)
    if far["n"]:
        mean_k, mean_c = far["kernel"] / far["n"], far["control"] / far["n"]
        BF16_CONTROL[where] = dict(mean_kernel=mean_k, mean_control=mean_c, ratio=mean_k / max(mean_c, 1e-30),
                                   equal_kernel=far["equal_kernel"] / far["n"],
                                   equal_control=far["equal_control"] / far["n"], elements=far["n"])
        print(f"  {where}: gru_bf16 over {len(calls)} inputs: mean |kernel - plain| {mean_k:.3e}, mean "
              f"|control - plain| {mean_c:.3e} (bf16 state between steps), ratio "
              f"{BF16_CONTROL[where]['ratio']:.3f} (<= {BF16_CONTROL_RATIO})", flush=True)
        check(mean_k <= BF16_CONTROL_RATIO * mean_c,
              f"{where}: gru_bf16 is {mean_k} from the plain version on average, the bf16-state control "
              f"{mean_c}: the kernel's state is not kept in f32")
    return worst


def gl_fft_loop(mag, cfg, n_iters: int):
    """The Griffin-Lim recurrence of ops/griffin_lim.py written as a loop
    of torch.fft.rfft / irfft calls (cuFFT): a printed yardstick for
    kernel 4, never called by the port."""
    import numpy as np
    import torch

    from zerospeech_tts_tpu_torch.dsp import audio
    from zerospeech_tts_tpu_torch.ops.griffin_lim import _trim, _wss_inv

    b, t, _ = mag.shape
    n, win, hop = cfg.n_fft, cfg.win_length, cfg.hop_length
    r, lpad = win // hop, (n - win) // 2
    window = torch.from_numpy(np.ascontiguousarray(audio._window(cfg)[lpad : lpad + win])).to(mag.device)
    wss_inv = _wss_inv(cfg, t, str(mag.device))

    def istft(spec):
        frames = (torch.fft.irfft(spec, n=n)[..., lpad : lpad + win] * window).reshape(b, t, r, hop)
        acc = mag.new_zeros(b, t - 1 + r, hop)
        for k in range(r):
            acc[:, k : k + t] += frames[:, :, k]
        return acc.reshape(b, -1) * wss_inv

    def project(x):
        segs = torch.nn.functional.pad(x.unfold(-1, win, hop) * window, (lpad, n - win - lpad))
        spec = torch.fft.rfft(segs, n=n)
        return mag * spec / torch.clamp(spec.abs(), min=1e-8)

    v = u = istft(mag.to(torch.complex64))
    for _ in range(n_iters):
        ui = istft(project(v))
        v = ui + cfg.gl_momentum * (ui - u)
        u = ui
    return _trim(istft(project(v)), cfg, t)


def gru_bf16_at_test_shapes(dev, results: dict, widest: dict) -> dict:
    """Kernel 2's bf16 mode at the test shapes against its plain version
    (hold_path_calls' bar: 2^-8): the decoder's B=16 T=512 H=512
    forward and the encoder's B=8 T=64 reverse masked, timed beside the
    plain version, the bound (bf16 bytes; operations at the dense bf16
    peak) and cuDNN nn.GRU forward in bf16 (input 640, so it includes the
    projection: the bf16 projection + kernel 2 is timed beside it); and at
    the widest bf16 H that fits, against the f32 mode's limit."""
    import torch

    from zerospeech_tts_tpu_torch.ops import gru
    from zerospeech_tts_tpu_torch.tools.workload import cuda_ms

    def inputs(b, t, h, seed):
        g = torch.Generator().manual_seed(seed)
        xw = torch.randn(b, t, 3 * h, generator=g).to(dev, torch.bfloat16)
        wh = (torch.randn(h, 3 * h, generator=g) / math.sqrt(h)).to(dev, torch.bfloat16)
        bh = (0.1 * torch.randn(3 * h, generator=g)).to(dev, torch.bfloat16)
        return xw, wh, bh

    out, errs = {}, []
    lens8 = torch.tensor([64, 61, 40, 64, 33, 9, 57, 1], dtype=torch.int32, device=dev)
    for tag, b, t, h, rev, ln in (("decoder fwd", 16, 512, 512, False, None),
                                  ("encoder rev masked", 8, 64, 512, True, lens8),
                                  ("widest H", 2, 16, widest["bfloat16"], False, None)):
        xw, wh, bh = inputs(b, t, h, 30 + len(errs))
        kw = {"reverse": rev}
        calls = {0: [[xw, wh, bh] + ([ln] if ln is not None else []), kw, 1]}
        errs.append(hold_path_calls("gru_bf16", calls, f"gru_bf16 {tag}"))
        line = f"gru_bf16 {tag} B={b} T={t} H={h}: max_abs_err {errs[-1]:.3e} (<= 2^-8)"
        if tag == "decoder fwd":
            k_ms = cuda_ms(lambda: gru.gru_scan(xw, wh, bh), 5)
            p_ms = cuda_ms(lambda: gru.gru_scan_plain(xw, wh, bh), 3)
            out.update(ms=k_ms, plain_ms=p_ms,
                       **bound(*work("gru_bf16", (xw, wh, bh), {}), peak=PEAK_BF16_FLOPS))
            line += f"  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms  bound {out['bound_ms']:.4f} ms"
        print(line, flush=True)
    # cuDNN nn.GRU forward in bf16 against the bf16 projection + kernel 2,
    # alternating over 7 rounds (medians), at B=16 T=512 I=640 H=512
    g = torch.Generator().manual_seed(40)
    x16 = torch.randn(16, 512, 640, generator=g).to(dev, torch.bfloat16)
    wi = (torch.randn(640, 1536, generator=g) / math.sqrt(640)).to(dev, torch.bfloat16)
    bi = (0.1 * torch.randn(1536, generator=g)).to(dev, torch.bfloat16)
    _, wh, bh = inputs(1, 1, 512, 41)
    ref = torch.nn.GRU(640, 512, batch_first=True).to(dev, torch.bfloat16)

    def cudnn_fwd():
        with torch.no_grad():
            ref(x16)

    pairs = {"projection_fwd_ms": (lambda: gru.gru_scan((x16 @ wi + bi).contiguous(), wh, bh), []),
             "cudnn_fwd_ms": (cudnn_fwd, [])}
    for _ in range(7):
        for fn, runs in pairs.values():
            runs.append(cuda_ms(fn, 4))
    med = {k: statistics.median(runs) for k, (_, runs) in pairs.items()}
    results["gru_bf16_vs_cudnn"] = {k: dict(median=med[k], runs=runs) for k, (_, runs) in pairs.items()}
    print(f"gru_bf16: projection + kernel 2 {med['projection_fwd_ms']:.3f} ms vs cuDNN nn.GRU bf16 fwd "
          f"{med['cudnn_fwd_ms']:.3f} ms (B=16 T=512 I=640, medians of 7): "
          f"{med['projection_fwd_ms'] / med['cudnn_fwd_ms']:.3f}x", flush=True)
    return dict(max_abs_err=max(errs), library_ms=med["cudnn_fwd_ms"], widest_h=widest, **out)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    try:
        import numpy as np

        from zerospeech_tts_tpu_torch import ops
        from zerospeech_tts_tpu_torch.config import AudioConfig
        from zerospeech_tts_tpu_torch.dsp import audio
        from zerospeech_tts_tpu_torch.ops import build, frontend, griffin_lim, gru
        from zerospeech_tts_tpu_torch.tools.workload import (
            TARGETS, WAV_SAMPLES, cuda_ms, fullscale, speechlike, write_workload,
        )
    except ImportError as e:
        fail(f"zerospeech_tts_tpu_torch is not importable beside {__file__} ({e})")

    dev = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ops.SOURCES)) as pool:  # one nvcc per source, all at once
        list(pool.map(build.load, ops.SOURCES))
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {len(ops.KERNELS)} kernels from "
          f"{len(ops.SOURCES)} sources", flush=True)
    for src in ops.SOURCES:
        print(f"  nvcc {src}.cu: {build.build_seconds[src]:.2f} s", flush=True)
        for line in build.build_log.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")
    for dt in (torch.float32, torch.bfloat16):
        for b in (1, 2, 6, 16, 32, 64):  # kernel 2: the conversion paths' rows, the test shape, training's
            kc, n_k, nb, n_b, cb, smem, rows, wreg = gru.scan_plan(dev, b, 512, dt)
            print(f"  gru {str(dt)[6:]} recurrence B={b} H=512: {n_k} column groups x {n_b} batch groups = "
                  f"{n_k * n_b} blocks of {kc} columns x {nb} rows ({cb} staged at a time), {smem} B dynamic "
                  f"shared memory each, wh in {'registers and ' if wreg else ''}shared memory, {rows} rows "
                  "a launch")
    widest = {}
    for dt in (torch.float32, torch.bfloat16):  # the widest H kernel 2 takes (wider raises ValueError)
        lo, hi = 512, 4096
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if gru.scan_plan(dev, 16, mid, dt)[0] else (lo, mid - 1)
        widest[str(dt)[6:]] = lo
    print(f"  gru widest H that fits (B=16): {widest}", flush=True)
    for b, h in ((32, 512), (64, 512), (128, 512)):  # kernel 3's recurrence, training shapes
        kc, nb, cb, n_k, n_b, smem = gru.bwd_plan(dev, b, h)
        print(f"  gru_bwd recurrence B={b} H={h}: {n_k} column groups x {n_b} batch groups = "
              f"{n_k * n_b} blocks of {kc} columns x {nb} rows ({cb} staged at a time), "
              f"{smem} B dynamic shared memory each")

    # ------------------------------------------- kernels vs plain versions
    cfg = AudioConfig()
    results = {}
    n = 512 * cfg.hop_length - 1  # 512 frames
    y = torch.from_numpy(np.stack([speechlike(n, s) for s in range(8)])).to(dev)
    lens = torch.tensor([n, n - 900, 90000, 70000, n, 60001, 99999, 81234], device=dev)
    ypad = audio.mirror_pad(audio.preemphasis(y, cfg.preemphasis), cfg.n_fft // 2, lens).contiguous()
    mel_k, mag_k = frontend.fused_frontend(ypad, cfg, 512)
    torch.cuda.synchronize()
    mel_p, mag_p = frontend.frontend_plain(ypad, cfg, 512)
    err = max((mel_k - mel_p).abs().max().item(), (mag_k - mag_p).abs().max().item())
    ms = cuda_ms(lambda: frontend.fused_frontend(ypad, cfg, 512), 20)
    plain_ms = cuda_ms(lambda: frontend.frontend_plain(ypad, cfg, 512), 20)
    print(f"frontend 8x512: max_abs_err {err:.3e} (atol 1e-4)  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms")
    check(err <= 1e-4, f"frontend kernel disagrees with its plain version: {err}")
    # full-scale frames: loud tones over quiet ones, a square wave, loud speech
    y_loud = torch.from_numpy(np.stack([fullscale(n, s) for s in range(8)])).to(dev)
    ypad_loud = audio.mirror_pad(audio.preemphasis(y_loud, cfg.preemphasis), cfg.n_fft // 2).contiguous()
    mel_k, mag_k = frontend.fused_frontend(ypad_loud, cfg, 512)
    torch.cuda.synchronize()
    mel_l, mag_l = frontend.frontend_plain(ypad_loud, cfg, 512)
    err_loud = max((mel_k - mel_l).abs().max().item(), (mag_k - mag_l).abs().max().item())
    ms_loud = cuda_ms(lambda: frontend.fused_frontend(ypad_loud, cfg, 512), 20)
    print(f"frontend 8x512 full scale: max_abs_err {err_loud:.3e} (atol 1e-4)  kernel {ms_loud:.3f} ms")
    check(err_loud <= 1e-4, f"frontend kernel disagrees with its plain version on loud frames: {err_loud}")
    err = max(err, err_loud)
    results["frontend"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                               **bound(*work("frontend", (ypad, cfg, 512), {})))

    def gru_weights(b, t, h, seed):
        g = torch.Generator().manual_seed(seed)
        xw = torch.randn(b, t, 3 * h, generator=g).to(dev)
        wh = (torch.randn(h, 3 * h, generator=g) / math.sqrt(h)).to(dev)
        bh = (0.1 * torch.randn(3 * h, generator=g)).to(dev)
        return xw, wh, bh

    def cudnn_gru_fwd_bwd(b, t, i, h):
        """cuDNN nn.GRU forward + backward at the same sizes (input size i:
        it includes the input projection the port hoists out of the
        kernel) - a yardstick."""
        ref = torch.nn.GRU(i, h, batch_first=True).to(dev)
        x = torch.randn(b, t, i, device=dev, requires_grad=True)
        dy = torch.randn(b, t, h, device=dev)
        return cuda_ms(lambda: ref(x)[0].backward(dy), 10)

    gru_errs, gru_ms = [], {}
    for tag, b, t, rev, masked in (("decoder fwd", 16, 512, False, False),
                                   ("encoder rev masked", 8, 64, True, True)):
        h = 512
        xw, wh, bh = gru_weights(b, t, h, len(gru_errs))
        ln = torch.tensor([64, 61, 40, 64, 33, 9, 57, 1], dtype=torch.int32, device=dev) if masked else None
        ys_k = gru.gru_scan(xw, wh, bh, ln, reverse=rev)
        torch.cuda.synchronize()
        ys_p = gru.gru_scan_plain(xw, wh, bh, ln, reverse=rev)
        e = (ys_k - ys_p).abs().max().item()
        k_ms = cuda_ms(lambda: gru.gru_scan(xw, wh, bh, ln, reverse=rev), 5)
        p_ms = cuda_ms(lambda: gru.gru_scan_plain(xw, wh, bh, ln, reverse=rev), 3)
        print(f"gru {tag} B={b} T={t} H={h}: max_abs_err {e:.3e} (atol 1e-4)  "
              f"kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms")
        check(e <= 1e-4, f"gru kernel ({tag}) disagrees with its plain version: {e}")
        gru_errs.append(e)
        gru_ms[tag] = (k_ms, p_ms)
    # kernel 2's time a step at B=16: T=64 against T=512 separates the
    # per-step chain from the launch's fixed cost
    step_us = {}
    for t in (64, 512):
        xw, wh, bh = gru_weights(16, t, 512, 20)
        step_us[t] = 1e3 * cuda_ms(lambda: gru.gru_scan(xw, wh, bh), 5) / t
    fixed_us = (step_us[64] - step_us[512]) * 64 * 512 / (512 - 64)
    print(f"gru B=16 H=512 per step: {step_us[64]:.3f} us at T=64, {step_us[512]:.3f} us at T=512 "
          f"(chain {(512 * step_us[512] - 64 * step_us[64]) / (512 - 64):.3f} us a step, fixed "
          f"{fixed_us:.1f} us a launch)", flush=True)
    b, t, h = 16, 512, 512
    results["gru"] = dict(  # library_ms: cuDNN nn.GRU forward, timed below beside the projection + kernel 2
        max_abs_err=max(gru_errs), ms=gru_ms["decoder fwd"][0], plain_ms=gru_ms["decoder fwd"][1],
        **bound(*work("gru", gru_weights(b, t, h, 0), {})))
    results["gru_bf16"] = gru_bf16_at_test_shapes(dev, results, widest)

    # kernel 3: decoder shape, encoder shape forward and reverse, the
    # encoder at twice the batch (rows staged in two chunks), ragged B and
    # H, T = 1 (where dwh vanishes: h_{t-1} = 0)
    bwd_errs, bwd_times = [], {}
    for tag, b, t, h, rev in (("decoder", 32, 128, 512, False), ("encoder fwd", 64, 16, 512, False),
                              ("encoder rev", 64, 16, 512, True), ("encoder wide", 128, 16, 512, False),
                              ("ragged", 3, 7, 40, False),
                              ("ragged rev", 3, 7, 40, True), ("T=1", 5, 1, 40, False)):
        xw, wh, bh = gru_weights(b, t, h, 10 + len(bwd_errs))
        ys = gru.gru_scan(xw, wh, bh, reverse=rev)
        dys = torch.randn(b, t, h, generator=torch.Generator().manual_seed(7)).to(dev)
        out_k = gru.gru_bwd(xw, wh, bh, ys, dys, reverse=rev)
        torch.cuda.synchronize()
        out_p = gru.gru_bwd_plain(xw, wh, bh, ys, dys, reverse=rev)
        e = (out_k[0] - out_p[0]).abs().max().item()
        r_wh = (out_k[1] - out_p[1]).abs().max().item() if t == 1 else rel_l2(out_k[1], out_p[1])
        r_bh = rel_l2(out_k[2], out_p[2])
        line = (f"gru_bwd {tag} B={b} T={t} H={h}: dxw max_abs_err {e:.3e} (<= 1e-4)  "
                f"dwh {'max_abs_err' if t == 1 else 'rel-L2'} {r_wh:.3e} dbh rel-L2 {r_bh:.3e} (<= 1e-4)")
        if tag in ("decoder", "encoder fwd"):
            k_ms = cuda_ms(lambda: gru.gru_bwd(xw, wh, bh, ys, dys), 5)
            p_ms = cuda_ms(lambda: gru.gru_bwd_plain(xw, wh, bh, ys, dys), 2)
            lib_ms = cudnn_gru_fwd_bwd(b, t, 640 if tag == "decoder" else 1024, h)
            bwd_times[tag] = (k_ms, p_ms, lib_ms)
            line += f"  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms  cuDNN GRU fwd+bwd {lib_ms:.3f} ms"
        print(line, flush=True)
        check(e <= 1e-4, f"gru_bwd kernel ({tag}) dxw disagrees with its plain version: {e}")
        check(r_wh <= 1e-4 and r_bh <= 1e-4, f"gru_bwd kernel ({tag}) dwh/dbh {r_wh} {r_bh}")
        bwd_errs.append(e)
    b, t, h = 32, 128, 512
    results["gru_bwd"] = dict(
        max_abs_err=max(bwd_errs), ms=bwd_times["decoder"][0], plain_ms=bwd_times["decoder"][1],
        library_ms=bwd_times["decoder"][2],
        **bound(*work("gru_bwd", gru_weights(b, t, h, 0), {})))

    # GRUScan (kernels 2 + 3) against cuDNN nn.GRU, decoder training shape
    b, t, i, h = 32, 128, 640, 512
    g = torch.Generator().manual_seed(3)
    x = torch.randn(b, t, i, generator=g).to(dev)
    wi = (torch.randn(i, 3 * h, generator=g) / math.sqrt(i)).to(dev)
    bi = (0.1 * torch.randn(3 * h, generator=g)).to(dev)
    _, wh, bh = gru_weights(1, 1, h, 4)
    dys = torch.randn(b, t, h, generator=g).to(dev)
    ours = [a.clone().requires_grad_(True) for a in (x, wi, bi, wh, bh)]
    ys = gru.GRUScan.apply((ours[0] @ ours[1] + ours[2]).contiguous(), ours[3], ours[4], False)
    ys.backward(dys)
    ref = torch.nn.GRU(i, h, batch_first=True).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(wi.T)
        ref.weight_hh_l0.copy_(wh.T)
        ref.bias_ih_l0.copy_(bi)
        ref.bias_hh_l0.copy_(bh)
    xr = x.clone().requires_grad_(True)
    yr, _ = ref(xr)
    yr.backward(dys)
    rels = [rel_l2(ys.detach(), yr.detach())] + [
        rel_l2(a, r) for a, r in ((ours[0].grad, xr.grad), (ours[1].grad, ref.weight_ih_l0.grad.T),
                                  (ours[2].grad, ref.bias_ih_l0.grad), (ours[3].grad, ref.weight_hh_l0.grad.T),
                                  (ours[4].grad, ref.bias_hh_l0.grad))]
    print("GRUScan vs cuDNN nn.GRU (B=32 T=128 H=512): rel-L2 ys, dx, dwi, dbi, dwh, dbh "
          + " ".join(f"{r:.3e}" for r in rels) + " (<= 1e-4)", flush=True)
    check(max(rels) <= 1e-4, f"GRUScan disagrees with cuDNN nn.GRU: {rels}")

    # Like for like with cuDNN, which computes the input projection too:
    # GRUScan (projection, kernel 2, kernel 3 and the projection's backward)
    # against nn.GRU forward + backward, both at B=32 T=128 I=640; and the
    # projection + kernel 2 against nn.GRU forward at kernel 2's shape.
    # cuDNN's times move between runs by up to 70%, so each pair alternates
    # over 7 rounds and the medians are compared.
    x16 = torch.randn(16, 512, i, generator=g).to(dev)
    ref16 = torch.nn.GRU(i, h, batch_first=True).to(dev)

    def gruscan_fwd_bwd():
        gru.GRUScan.apply((ours[0] @ ours[1] + ours[2]).contiguous(), ours[3], ours[4], False).backward(dys)

    def cudnn_fwd():
        with torch.no_grad():
            ref16(x16)

    pairs = {"gruscan_fwd_bwd_ms": (gruscan_fwd_bwd, []), "cudnn_fwd_bwd_ms": (lambda: ref(xr)[0].backward(dys), []),
             "projection_fwd_ms": (lambda: gru.gru_scan((x16 @ wi + bi).contiguous(), wh, bh), []),
             "cudnn_fwd_ms": (cudnn_fwd, [])}
    for _ in range(7):
        for fn, runs in pairs.values():
            runs.append(cuda_ms(fn, 4))
    med = {k: statistics.median(runs) for k, (_, runs) in pairs.items()}
    results["gru_vs_cudnn"] = {k: dict(median=med[k], runs=runs) for k, (_, runs) in pairs.items()}
    results["gru"]["library_ms"] = med["cudnn_fwd_ms"]  # the one cuDNN forward reading of this run
    print(f"GRUScan fwd+bwd (projection + kernels 2, 3) {med['gruscan_fwd_bwd_ms']:.3f} ms vs cuDNN nn.GRU "
          f"fwd+bwd {med['cudnn_fwd_bwd_ms']:.3f} ms (B=32 T=128 I=640, medians of 7): "
          f"{med['gruscan_fwd_bwd_ms'] / med['cudnn_fwd_bwd_ms']:.3f}x; projection + kernel 2 "
          f"{med['projection_fwd_ms']:.3f} ms vs cuDNN fwd {med['cudnn_fwd_ms']:.3f} ms (B=16 T=512 I=640): "
          f"{med['projection_fwd_ms'] / med['cudnn_fwd_ms']:.3f}x", flush=True)

    def row_rel(a, b):  # signal rel-L2 of each row
        return torch.linalg.norm(a - b, dim=-1) / torch.linalg.norm(b, dim=-1)

    # Bars on the kernel's signal against the plain version's (both f32):
    # pooled, the worst row, and the worst row over its first and last
    # win_length samples alone, where the untrimmed overlap-add tails and
    # the full wss envelope act. Measured on an H100 at 16 x 512: 4.4e-4
    # pooled, 1.2e-3 worst row (momentum 0.99 amplifies the two summation
    # orders' rounding), 5e-5 at the edges. A row gone wrong reads ~1.
    edge = cfg.win_length
    gl_errs = []
    amp16 = audio.db_norm_to_amp(torch.cat([mag_p, mag_p.flip(0)]), cfg) ** cfg.gl_power
    n_long = 2499 * cfg.hop_length + 100
    _, mag_long = audio.wav_to_features(torch.from_numpy(speechlike(n_long, 9)).to(dev)[None], cfg)
    amp_long = audio.db_norm_to_amp(mag_long, cfg) ** cfg.gl_power
    for tag, amp in (("16x512", amp16.contiguous()), ("1x2500", amp_long.contiguous())):
        out_k = griffin_lim.griffin_lim(amp, cfg, n_iters=8)
        torch.cuda.synchronize()
        out_p = griffin_lim.griffin_lim_plain(amp, cfg, n_iters=8)
        check(out_k.shape == out_p.shape == (amp.shape[0], (amp.shape[1] - 1) * cfg.hop_length),
              f"griffin-lim output shape {tuple(out_k.shape)}")
        ck, cp = gl_consistency(out_k, amp, cfg), gl_consistency(out_p, amp, cfg)
        rel = rel_l2(out_k, out_p)
        rel_row = row_rel(out_k, out_p).max().item()
        ends = lambda x: torch.cat([x[:, :edge], x[:, -edge:]], -1)  # noqa: E731
        rel_edge = row_rel(ends(out_k), ends(out_p)).max().item()
        e = (out_k - out_p).abs().max().item()
        line = (f"griffin-lim {tag} x8 iters: consistency kernel {ck:.5f} plain {cp:.5f} "
                f"(|diff| <= 1e-3)  signal rel-L2 {rel:.3e} (<= 1e-3), worst row {rel_row:.3e} "
                f"(<= 2e-3), worst row edges {rel_edge:.3e} (<= 1e-3)  max_abs_err {e:.3e}")
        if tag == "16x512":
            k_ms = cuda_ms(lambda: griffin_lim.griffin_lim(amp, cfg, n_iters=8), 3)
            p_ms = cuda_ms(lambda: griffin_lim.griffin_lim_plain(amp, cfg, n_iters=8), 3)
            line += f"  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms"
            results["griffin_lim"] = dict(
                ms=k_ms, plain_ms=p_ms, rel_l2=rel, library_ms=None,
                **bound(*work("griffin_lim", (amp, cfg, 8), {})))
        print(line, flush=True)
        check(abs(ck - cp) <= 1e-3, f"griffin-lim kernel ({tag}) consistency {ck} vs plain {cp}")
        check(rel <= 1e-3, f"griffin-lim kernel ({tag}) signal rel-L2 {rel}")
        check(rel_row <= 2e-3, f"griffin-lim kernel ({tag}) worst row rel-L2 {rel_row}")
        check(rel_edge <= 1e-3, f"griffin-lim kernel ({tag}) worst row edge rel-L2 {rel_edge}")
        gl_errs.append(e)
    results["griffin_lim"]["max_abs_err"] = max(gl_errs)
    torch.cuda.synchronize()

    # ------------------------------------------- conversion path, end to end
    import scipy.io.wavfile

    from zerospeech_tts_tpu_torch import cli
    from zerospeech_tts_tpu_torch.convert import Converter, read_units
    from zerospeech_tts_tpu_torch.dsp.wavio import load_wav
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.params import from_flax

    hps, acfg, speakers, n_params = write_workload(OUT, seed=0)
    wav_dir, result_dir = OUT / "wavs", OUT / "result"
    print(f"conversion path: {len(WAV_SAMPLES)} wavs x {len(TARGETS)} targets, flagship width "
          f"({n_params} params), GL-{acfg.gl_iters}", flush=True)

    conv_calls: dict = {}
    with capture(("frontend", "gru", "griffin_lim"), conv_calls):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cli.main([
            "convert", "--from-export", str(OUT / "bundle"), "--from-wavs", str(wav_dir),
            "-result_dir", str(result_dir), "--target", *TARGETS, "--device", "cuda",
        ])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        conv_launches = ops.launch_counts()
    print(f"conversion wall {wall:.3f} s: {len(WAV_SAMPLES) / wall:.3f} utterances/s, "
          f"{out['n_wavs'] / wall:.3f} wav/s; launches {conv_launches}", flush=True)
    for name in ("frontend", "gru", "griffin_lim"):
        check(conv_launches[name] > 0, f"kernel {name} was not launched on the conversion path")

    for i, ns in enumerate(WAV_SAMPLES):
        t = 1 + ns // acfg.hop_length
        u = read_units(result_dir / "units" / f"utt{i}.txt")
        check(u.shape == (-(-t // hps.downsample), hps.emb_size), f"utt{i} units shape {u.shape}")
        check(bool(((u == 0) | (u == 1)).all()), f"utt{i} units are not 0/1")
        for tgt in TARGETS:
            sr, pcm = scipy.io.wavfile.read(result_dir / tgt / f"utt{i}.wav")
            check(sr == 16000 and pcm.dtype == np.int16, f"{tgt}/utt{i}: {sr} Hz {pcm.dtype}")
            check(pcm.shape == ((t - 1) * acfg.hop_length,), f"{tgt}/utt{i}: {pcm.shape} samples")
            check(int(np.abs(pcm.astype(np.int32)).max()) > 100, f"{tgt}/utt{i} is silent")

    # each conversion kernel at the path's own shapes: its calls, each
    # distinct input timed once and weighted by its count
    path = {name: path_times(name, conv_calls[name]) for name in ("frontend", "gru", "griffin_lim")}
    for name, pt in path.items():
        check(pt["launches"] == conv_launches[name], f"{name}: {pt['launches']} captured calls, "
              f"{conv_launches[name]} launches")
        print(f"{name} on the conversion path: {pt['launches']} launches, {len(pt['shapes'])} shapes: "
              f"kernel {pt['ms']:.3f} ms  plain {pt['plain_ms']:.3f} ms  bound {pt['bound_ms']:.4f} ms", flush=True)
    for name in ("frontend", "gru"):  # Griffin-Lim at GL-100 below
        path[name]["held"] = hold_path_calls(name, conv_calls[name], "conversion")
        print(f"{name} at the conversion path's inputs against its plain version: {path[name]['held']:.3e}",
              flush=True)
    steps = sum(count * args[0].shape[1] for args, kw, count in conv_calls["gru"].values())
    path["gru"]["steps"] = steps
    print(f"gru on the conversion path: {steps} steps, {1e3 * path['gru']['ms'] / steps:.3f} us a step",
          flush=True)

    # Griffin-Lim at GL-100 on the path's own inputs (the decoder's
    # magnitudes, one call per bucket): consistency within 1e-3 of the
    # plain version's; the signal rel-L2 printed without a bar (momentum
    # 0.99 over 100 iterations amplifies rounding). The same recurrence as
    # a loop of torch.fft calls (cuFFT) is timed beside it as a yardstick.
    fft_loop_ms, gl100 = 0.0, []
    for args, kw, count in conv_calls["griffin_lim"].values():
        amp, acfg_gl = args[0], args[1]
        n_it = acfg_gl.gl_iters if kw.get("n_iters") is None else kw["n_iters"]
        out_k = griffin_lim.griffin_lim(amp, acfg_gl, n_iters=n_it)
        torch.cuda.synchronize()
        out_p = griffin_lim.griffin_lim_plain(amp, acfg_gl, n_iters=n_it)
        out_f = gl_fft_loop(amp, acfg_gl, n_it)
        ck, cp, cf = (gl_consistency(o, amp, acfg_gl) for o in (out_k, out_p, out_f))
        f_ms = cuda_ms(lambda: gl_fft_loop(amp, acfg_gl, n_it), 1)
        fft_loop_ms += count * f_ms
        row = dict(shape=tuple(amp.shape), iters=n_it, consistency_kernel=ck, consistency_plain=cp,
                   consistency_fft_loop=cf, rel_l2=rel_l2(out_k, out_p), fft_loop_ms=f_ms)
        gl100.append(row)
        print(f"griffin-lim GL-{n_it} {tuple(amp.shape)}: consistency kernel {ck:.5f} plain {cp:.5f} "
              f"(|diff| <= 1e-3) cuFFT loop {cf:.5f}  signal rel-L2 {row['rel_l2']:.3e} (no bar)  "
              f"cuFFT loop {f_ms:.3f} ms", flush=True)
        check(torch.isfinite(out_k).all().item() and abs(ck - cp) <= 1e-3,
              f"griffin-lim GL-{n_it} {tuple(amp.shape)}: consistency {ck} vs plain {cp}")
    path["griffin_lim"]["fft_loop_ms"] = fft_loop_ms
    print(f"griffin-lim on the conversion path: kernel {path['griffin_lim']['ms']:.3f} ms, "
          f"cuFFT loop yardstick {fft_loop_ms:.3f} ms", flush=True)

    # reference: the card's conversion of the shortest utterance against the
    # plain path on the CPU (same bundle, GL-4)
    b = load_export(OUT / "bundle")
    enc_sd, dec_sd = from_flax({"enc": b.enc, "dec": b.dec})
    wav = load_wav(wav_dir / f"utt{len(WAV_SAMPLES) - 1}.wav", acfg.sr)
    ref = {}
    for device in ("cuda", "cpu"):
        conv = Converter(b.hps, b.acfg, enc_sd, dec_sd, gl_iters=4, stats=b.stats, device=device)
        ref[device] = conv.convert_wavs_multi(
            [wav], [speakers[t] for t in TARGETS], tgt_names=list(TARGETS)
        )
    agree = float((ref["cuda"][0][0] == ref["cpu"][0][0]).mean())

    def spec(pcm):
        re, im = audio.stft(torch.from_numpy(pcm.astype(np.float32) / 32768.0)[None], acfg)
        return torch.sqrt(re * re + im * im)

    pcm_rel = max(rel_l2(spec(ref["cuda"][1][k][0]), spec(ref["cpu"][1][k][0])) for k in range(len(TARGETS)))
    print(f"reference (utt{len(WAV_SAMPLES) - 1}, GL-4, card vs CPU plain): unit agreement "
          f"{agree:.6f} (>= 0.999)  PCM STFT-magnitude rel-L2 {pcm_rel:.3e} (<= 1e-2)")
    check(agree >= 0.999, f"units on the card disagree with the CPU reference: {agree}")
    check(pcm_rel <= 1e-2, f"audio on the card disagrees with the CPU reference: {pcm_rel}")

    # ------------------------------ bf16 conversion routes and serve, end to end
    bf16 = bf16_routes(OUT, wav_dir, result_dir)
    path["gru_bf16"] = bf16.pop("path")
    served = serve_path(OUT, wav_dir, result_dir)

    # ------------------------------------------------ corpus path, end to end
    corpus = corpus_path(OUT / "corpus", OUT / "bundle")

    # ---------------------------------------------- training path, end to end
    train = train_path(OUT / "train")
    mel = mel_path(OUT / "mel")
    by_path = {"conversion": conv_launches, **bf16.pop("launches"), "serve": served.pop("launches"),
               **corpus.pop("launches"), "training": train.pop("launches"),
               "convert_after_training": train.pop("convert_launches"), **mel.pop("launches")}
    path["gru_bwd"] = train.pop("path")
    step_check = card_vs_cpu_steps()
    check("jax" not in sys.modules, "jax was imported")

    kernels = []
    for name in ops.KERNELS:
        r, pt = results[name], path[name]
        on = {"gru_bwd": "training", "gru_bf16": "conversion_bf16"}.get(name, "conversion")
        kernels.append(dict(
            name=name, route="cuda", source=f"{SRC}/{ops.KERNELS[name][2]}.cu", replaces=REPLACES[name],
            launches=by_path[on][name], launches_path=on,
            launches_by_path={p: c[name] for p, c in by_path.items()}, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], path_ms=pt["ms"], path_plain_ms=pt["plain_ms"],
            path_bound_ms=pt["bound_ms"]))
    (OUT / "result.json").write_text(json.dumps(
        dict(kernels=kernels, launches_by_path=by_path, conversion_wall_s=wall,
             utterances_per_s=len(WAV_SAMPLES) / wall,
             gru_like_for_like=results["gru_vs_cudnn"], gru_step_us_b16=step_us,
             gl_rel_l2=results["griffin_lim"]["rel_l2"], gl100_conversion=gl100, path=path,
             reference_unit_agreement=agree,
             reference_pcm_rel_l2=pcm_rel, corpus=corpus, training=train,
             gru_bf16_like_for_like=results["gru_bf16_vs_cudnn"], gru_bf16_control=BF16_CONTROL,
             bf16_routes=bf16, serve=served, mel=mel,
             card_vs_cpu_steps=step_check, card=card_line()), indent=2) + "\n")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def unit_files_agreement(dir_a: Path, dir_b: Path) -> tuple[float, int]:
    """(share of equal unit bits, bits) over the unit files of dir_a/units,
    each against its namesake in dir_b/units (same shapes required)."""
    from zerospeech_tts_tpu_torch.convert import read_units

    same = bits = 0
    for p in sorted((dir_a / "units").glob("*.txt")):
        ua, ub = read_units(p), read_units(dir_b / "units" / p.name)
        check(ua.shape == ub.shape, f"{p.name}: units {ua.shape} against {ub.shape}")
        same += int((ua == ub).sum())
        bits += ua.size
    check(bits > 0, f"no unit files in {dir_a}")
    return same / bits, bits


def bf16_routes(out: Path, wav_dir: Path, exact_dir: Path, device: str = "cuda") -> dict:
    """``convert --bf16`` and ``convert --bf16 --enc-f32`` through the CLI on
    the conversion path's wavs and bundle (flagship width, GL-100), each
    route's launches counted apart (0 just before, read just after) and its
    kernel inputs kept: the all-bf16 route runs kernel 2 in bf16 for the
    encoder and the decoder, the enc-f32 route f32 for the encoder; neither
    takes the plain route. Unit agreement with the exact route's files:
    >= 0.999 for enc-f32, > 0.9 for all-bf16. Kernel 2 (both modes) and
    kernel 4 are held at every input the routes gave them; kernel 2's bf16
    path times come from the all-bf16 route."""
    import scipy.io.wavfile
    import torch

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS

    routes = {"conversion_bf16": ["--bf16"], "conversion_bf16_enc_f32": ["--bf16", "--enc-f32"]}
    launches, calls, agree, walls = {}, {}, {}, {}
    for route, flags in routes.items():
        calls[route] = {}
        res = out / f"result_{route}"
        with capture(("frontend", "gru", "griffin_lim"), calls[route]):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cli.main(["convert", "--from-export", str(out / "bundle"), "--from-wavs", str(wav_dir),
                      "-result_dir", str(res), "--target", *TARGETS, *flags, "--device", device])
            torch.cuda.synchronize()
            walls[route] = time.perf_counter() - t0
            launches[route] = ops.launch_counts()
        want = {"frontend", "gru_bf16", "griffin_lim"} | ({"gru"} if "--enc-f32" in flags else set())
        for name in ("frontend", "gru", "gru_bf16", "griffin_lim", "gru_bwd"):
            n = launches[route][name]
            check(n > 0 if name in want else n == 0, f"{route}: kernel {name} launched {n} times")
        agree[route] = unit_files_agreement(res, exact_dir)[0]
        for p in sorted((exact_dir / TARGETS[0]).glob("*.wav")):
            for tgt in TARGETS:
                sr, pcm = scipy.io.wavfile.read(res / tgt / p.name)
                check(sr == 16000 and pcm.dtype == "int16" and pcm.shape == scipy.io.wavfile.read(p)[1].shape,
                      f"{route} {tgt}/{p.name}: {sr} Hz {pcm.dtype} {pcm.shape}")
        print(f"{route}: wall {walls[route]:.3f} s; launches {launches[route]}; unit agreement with the "
              f"exact route {agree[route]:.6f}", flush=True)
    check(agree["conversion_bf16_enc_f32"] >= 0.999,
          f"--bf16 --enc-f32 units agree with the exact route at {agree['conversion_bf16_enc_f32']} (< 0.999)")
    check(agree["conversion_bf16"] > 0.9, f"--bf16 units agree with the exact route at {agree['conversion_bf16']}")
    held = {}
    for route in routes:
        for name in ("frontend", "gru", "gru_bf16", "griffin_lim"):
            c = calls[route].get(name, {})
            n = sum(count for _, _, count in c.values())
            check(n == launches[route][name], f"{route}: {n} captured {name} calls, {launches[route][name]} launches")
            if c and name != "frontend":  # the frontend's inputs are the exact route's, held there
                held[f"{name} {route}"] = hold_path_calls(name, c, route)
    print("kernels at the bf16 routes' inputs against their plain versions: "
          + "; ".join(f"{k} {v:.3e}" for k, v in held.items()), flush=True)
    pt = path_times("gru_bf16", calls["conversion_bf16"]["gru_bf16"])
    print(f"gru_bf16 on the conversion_bf16 path: {pt['launches']} launches, shapes "
          + ", ".join(f"{x['shape']} x{x['count']}" for x in pt["shapes"])
          + f": kernel {pt['ms']:.3f} ms  plain {pt['plain_ms']:.3f} ms  bound {pt['bound_ms']:.4f} ms", flush=True)
    return dict(launches=launches, agreement=agree, held=held, path=pt, walls_s=walls)


def serve_path(out: Path, wav_dir: Path, exact_dir: Path, device: str = "cuda") -> dict:
    """The ``serve`` verb in a thread of this process (cli.cmd_serve, the
    verb's own code) on 127.0.0.1, port 0, with the conversion path's bundle
    and ``--warmup-buckets`` of the path's buckets; once it serves, 8
    concurrent /convert requests (the path's 8 wavs to V001 and V002) and 4
    /units requests, twice (the first burst meets batch shapes the warmup's
    single rows did not), launches counted from just before the first
    request to just after the last. Checks: fewer dispatches than requests
    in each burst; the units equal
    those of ``convert --from-wavs`` on the same wavs except bits whose
    plain-CPU logit margin is < 1e-4; /convert answers 16 kHz PCM16 of the
    CLI's lengths; no plain route. Prints p50/p95 request latency."""
    import base64
    import io
    import threading
    import urllib.request

    import numpy as np
    import scipy.io.wavfile
    import torch

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.convert import read_units
    from zerospeech_tts_tpu_torch.dsp import audio
    from zerospeech_tts_tpu_torch.dsp.wavio import load_wav, trim_silence
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.models import Encoder
    from zerospeech_tts_tpu_torch.params import from_flax
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS

    args = cli.build_parser().parse_args([
        "serve", "--from-export", str(out / "bundle"), "--host", "127.0.0.1", "--port", "0",
        "--warmup-buckets", "128,256,320,384,512", "--warmup-targets", str(len(TARGETS)),
        "--batch-size", "8", "--batch-window-ms", "50", "--device", device])
    ready, result, bound_ev = [], {}, threading.Event()

    def on_serving(httpd, svc):
        ready.append((httpd, svc))
        bound_ev.set()

    t0 = time.perf_counter()
    th = threading.Thread(target=lambda: result.update(cli.cmd_serve(args, on_serving)), daemon=True)
    th.start()
    check(bound_ev.wait(600), "serve did not start within 600 s")
    start_s = time.perf_counter() - t0
    httpd, svc = ready[0]
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    wav_paths = sorted(wav_dir.glob("*.wav"))
    bodies = {p.stem: p.read_bytes() for p in wav_paths}
    reqs = [("convert", p.stem) for p in wav_paths] + [("units", p.stem) for p in wav_paths[:4]]

    def send(req):
        kind, stem = req
        url = f"{base}/convert?targets={','.join(TARGETS)}" if kind == "convert" else f"{base}/units"
        t = time.perf_counter()
        with urllib.request.urlopen(urllib.request.Request(url, data=bodies[stem], method="POST"),
                                    timeout=300) as resp:
            body = json.loads(resp.read())
        return kind, stem, body, time.perf_counter() - t

    rounds = []  # two bursts: the first meets the batch shapes the warmup's single rows did not
    try:
        ops.reset_launches()
        for _ in range(2):
            d0, s0 = svc.dispatches, svc.served
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with ThreadPoolExecutor(len(reqs)) as pool:
                answers = list(pool.map(send, reqs))
            torch.cuda.synchronize()
            rounds.append(dict(answers=answers, wall=time.perf_counter() - t1, dispatches=svc.dispatches - d0,
                               served=svc.served - s0))
        launches = ops.launch_counts()
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        th.join(60)
    check(not th.is_alive(), "the serve verb did not return after shutdown")
    for name in ("frontend", "gru", "griffin_lim"):
        check(launches[name] > 0, f"serve: kernel {name} was not launched")
    check(launches["gru_bf16"] == 0 and launches["gru_bwd"] == 0, f"serve launches {launches}")
    for rd in rounds:
        check(rd["served"] == len(reqs) and rd["dispatches"] < len(reqs),
              f"serve: {rd['dispatches']} dispatches for {rd['served']} of {len(reqs)} requests")
    check(health["ok"] and health["platform"] == ("gpu" if device == "cuda" else device), f"healthz {health}")

    b = load_export(out / "bundle")
    cpu_enc = None
    flips = bits = 0
    margin_max = 0.0
    for kind, stem, body, _ in [a for rd in rounds for a in rd["answers"]]:
        u = np.array([[int(v) for v in row.split()] for row in body["units"].splitlines()], np.int32)
        ref = read_units(exact_dir / "units" / f"{stem}.txt")
        check(u.shape == ref.shape, f"serve {kind} {stem}: units {u.shape}, the CLI's {ref.shape}")
        bits += u.size
        if (u != ref).any():
            if cpu_enc is None:
                cpu_enc = Encoder(b.hps)
                cpu_enc.load_state_dict(from_flax({"enc": b.enc, "dec": b.dec})[0])
                cpu_enc.eval()
            y = trim_silence(load_wav(wav_dir / f"{stem}.wav", b.acfg.sr), b.acfg.top_db)
            _, mag = audio.wav_to_features(torch.from_numpy(y)[None], b.acfg)
            x = torch.from_numpy(b.stats.normalize(mag[0].numpy(), "__global__"))
            with torch.inference_mode():
                lg = cpu_enc(x[None])[0].numpy()
            m = np.abs(lg[..., 0] - lg[..., 1])[u != ref]
            flips += m.size
            margin_max = max(margin_max, float(m.max()))
            check(bool((m < 1e-4).all()), f"serve {kind} {stem}: units flip bits with margins {m[m >= 1e-4]}")
        if kind == "convert":
            check(set(body["wavs"]) == set(TARGETS), f"serve {stem}: wavs for {sorted(body['wavs'])}")
            for tgt, b64 in body["wavs"].items():
                sr, pcm = scipy.io.wavfile.read(io.BytesIO(base64.b64decode(b64)))
                want = scipy.io.wavfile.read(exact_dir / tgt / f"{stem}.wav")[1]
                check(sr == 16000 and pcm.dtype == np.int16 and pcm.shape == want.shape,
                      f"serve {tgt}/{stem}: {sr} Hz {pcm.dtype} {pcm.shape}, want {want.shape}")
    report = []
    for i, rd in enumerate(rounds):
        lat = {k: [a[3] for a in rd["answers"] if a[0] == k] for k in ("convert", "units")}
        lat["all"] = [a[3] for a in rd["answers"]]
        pct = {k: dict(p50=float(np.percentile(v, 50)), p95=float(np.percentile(v, 95))) for k, v in lat.items()}
        report.append(dict(wall_s=rd["wall"], dispatches=rd["dispatches"], latency_s=pct))
        print(f"serve burst {i + 1}: {len(reqs)} concurrent requests ({len(wav_paths)} /convert to {len(TARGETS)} "
              f"targets, 4 /units) in {rd['wall']:.3f} s, {rd['dispatches']} dispatches; latency p50/p95 "
              + ", ".join(f"{k} {v['p50']:.3f}/{v['p95']:.3f} s" for k, v in pct.items()), flush=True)
    print(f"serve: up (bundle load, warmup of 5 buckets x {len(TARGETS)} targets) in {start_s:.2f} s; launches "
          f"over both bursts {launches}; units equal the CLI's but {flips} of {bits} bits (largest plain-CPU "
          f"margin {margin_max:.3e}, < 1e-4); 16 kHz PCM16", flush=True)
    return dict(launches=launches, start_s=start_s, requests=len(reqs), bursts=report, unit_flips=flips,
                unit_bits=bits, result=result)


def mel_path(work: Path, device: str = "cuda") -> dict:
    """``--feat mel`` at flagship width: the flagship hps with n_feat = 80
    (n_mels), written under ``work``, and a seeded 6-speaker corpus through
    the CLI on the card: preprocess -> train1 --feat mel (2 iterations a
    phase) -> train2 --feat mel --data-bf16 (one GAN cycle, the features
    kept on the card in bf16) -> export --feat mel, its
    launches counted; then convert --from-export --from-wavs at GL-100,
    counted apart, with every magnitude array kernel 4 received (the mel
    lift, dsp/audio.py mel_to_gl_magnitudes) held against the float64 lift
    of the same mel input (rel-L2 and largest difference within 1e-5 of the
    largest magnitude), and kernel 4 held at those inputs."""
    import dataclasses
    import shutil

    import numpy as np
    import scipy.io.wavfile
    import torch

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs
    from zerospeech_tts_tpu_torch.convert import read_units
    from zerospeech_tts_tpu_torch.dsp import audio
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS, write_train_corpus

    shutil.rmtree(work, ignore_errors=True)
    corpus = write_train_corpus(work, seed=1)
    hps, acfg = load_configs(DEFAULT_HPS_PATH)
    d = dataclasses.asdict(hps.replace(n_feat=acfg.n_mels))
    d["audio"] = dataclasses.asdict(acfg)
    (work / "hps_mel.json").write_text(json.dumps(d))
    ds, ck, bundle = str(work / "ds"), str(work / "ck"), str(work / "bundle")
    c = ["--hps", str(work / "hps_mel.json"), "--device", device]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["preprocess", "--corpus", str(corpus), "-dataset_path", ds, *c])
    r1 = cli.main(["train1", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "2", "--feat", "mel", *c])
    r1.pop("state")
    r2 = cli.main(["train2", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "1", "--feat", "mel",
                   "--data-bf16", "--targets", *TARGETS, *c])
    r2.pop("state")
    ex = cli.main(["export", "-dataset_path", ds, "-ckpt_dir", ck, "--out", bundle, "--feat", "mel", *c])
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = ops.launch_counts()
    for name in ("frontend", "gru", "gru_bwd"):
        check(train_launches[name] > 0, f"kernel {name} was not launched on the mel training path")
    check(r1["step"] == 6 and r2["step"] == 6 + hps.n_critic + 1 and ex["feat"] == "mel",
          f"mel training: steps {r1['step']}, {r2['step']}, export feat {ex['feat']}")
    for k, v in {**r1["phases"], **r2["phases"]}.items():
        check(all(np.isfinite(x) for x in v["last"].values()), f"mel {k}: non-finite losses {v['last']}")
    print(f"mel training path (n_feat {acfg.n_mels}) wall {train_wall:.2f} s; launches {train_launches}", flush=True)

    lifts, calls = [], {}
    orig = audio.mel_to_gl_magnitudes

    def record(mel_norm, cfg):
        amp = orig(mel_norm, cfg)
        lifts.append((mel_norm.detach().clone(), amp.detach().clone(), cfg))
        return amp

    audio.mel_to_gl_magnitudes = record
    try:
        with capture(("griffin_lim",), calls):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cv = cli.main(["convert", "--from-export", bundle, "--from-wavs", str(corpus / "test"),
                           "-result_dir", str(work / "out"), "--target", *TARGETS, "--device", device])
            torch.cuda.synchronize()
            cv_wall = time.perf_counter() - t0
            cv_launches = ops.launch_counts()
    finally:
        audio.mel_to_gl_magnitudes = orig
    for name in ("frontend", "gru", "griffin_lim"):
        check(cv_launches[name] > 0, f"kernel {name} was not launched on the mel conversion path")
    n_gl = sum(count for _, _, count in calls["griffin_lim"].values())
    check(len(lifts) == n_gl == cv_launches["griffin_lim"],
          f"mel convert: {len(lifts)} lifts, {n_gl} captured Griffin-Lim calls, {cv_launches['griffin_lim']} launches")
    lift_err = []
    for mel_norm, amp, cfg in lifts:
        pinv = torch.from_numpy(audio._mel_pinv(cfg)).to(mel_norm.device).double()
        amp64 = torch.clamp(audio.db_norm_to_amp(mel_norm.double(), cfg) @ pinv.T, min=1e-10) ** cfg.gl_power
        rel = (torch.linalg.norm(amp.double() - amp64) / torch.linalg.norm(amp64)).item()
        top = ((amp.double() - amp64).abs().max() / amp64.abs().max()).item()
        lift_err.append(dict(shape=tuple(amp.shape), rel_l2=rel, max_rel_to_top=top))
        check(rel <= 1e-5 and top <= 1e-5, f"mel lift {tuple(amp.shape)}: rel-L2 {rel}, max diff {top} of the top")
    gl_held = hold_path_calls("griffin_lim", calls["griffin_lim"], "mel convert")
    u = read_units(work / "out" / "units" / "T001_0.txt")
    check(u.shape[1] == hps.emb_size and cv["n_wavs"] == len(TARGETS), f"mel convert: {cv}, units {u.shape}")
    for tgt in TARGETS:
        sr, pcm = scipy.io.wavfile.read(work / "out" / tgt / "T001_0.wav")
        check(sr == 16000 and pcm.dtype == np.int16 and len(pcm) > 1000, f"mel {tgt}: {sr} Hz {pcm.dtype}")
    print(f"mel convert (GL-100) wall {cv_wall:.3f} s; launches {cv_launches}; kernel 4's {len(lifts)} lifted "
          f"magnitude arrays vs the float64 lift: rel-L2 up to {max(e['rel_l2'] for e in lift_err):.3e}, largest "
          f"difference {max(e['max_rel_to_top'] for e in lift_err):.3e} of the top (<= 1e-5); kernel 4 at those "
          f"inputs: consistency |diff| {gl_held:.3e} (<= 1e-3)", flush=True)
    return dict(launches={"mel_training": train_launches, "mel_convert": cv_launches}, train_wall_s=train_wall,
                convert_wall_s=cv_wall, lift=lift_err, gl_held=gl_held)


def corpus_path(work: Path, bundle: Path, device: str = "cuda") -> dict:
    """The challenge-artifact routes through the CLI on ``device`` (the
    card) with the flagship bundle: preprocess a test split, convert it
    from the corpus three ways, units from its wavs, eval, submission. Each
    route's kernel launches are counted apart (set to 0 just before it,
    read just after)."""
    import shutil

    import numpy as np
    import torch

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.convert import load_corpus_split, read_units
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.models import Encoder
    from zerospeech_tts_tpu_torch.ops import griffin_lim, gru
    from zerospeech_tts_tpu_torch.params import from_flax
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS, cuda_ms, write_test_corpus

    shutil.rmtree(work, ignore_errors=True)
    corpus = write_test_corpus(work, seed=0)
    ds, dev = str(work / "ds"), ["--device", device]
    src = ["--from-export", str(bundle), "-dataset_path", ds]
    routes = {
        "corpus_preprocess": ["preprocess", "--corpus", str(corpus), "-dataset_path", ds],
        "corpus_units_only": ["convert", *src, "-result_dir", str(work / "a"), "--units-only"],
        "corpus_uniform": ["convert", *src, "-result_dir", str(work / "b"), "--target", *TARGETS],
        "corpus_adaptive": ["convert", *src, "-result_dir", str(work / "c"), "--target", *TARGETS,
                            "--adaptive-buckets", "4", "--bucket-cost-model", "executed",
                            "--frame-budget", "8192"],
        "wavs_units_only": ["convert", "--from-export", str(bundle), "--from-wavs",
                            str(corpus / "test"), "-result_dir", str(work / "d"), "--units-only"],
    }
    launches, outs, calls, walls = {}, {}, {}, {}
    for route, argv in routes.items():
        calls[route] = {}
        with capture(("frontend", "gru", "griffin_lim"), calls[route]):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[route] = cli.main([*argv, *dev])
            torch.cuda.synchronize()
            walls[route] = time.perf_counter() - t0
            launches[route] = ops.launch_counts()
        print(f"{route}: wall {walls[route]:.3f} s; launches {launches[route]}", flush=True)
    n_utt = outs["corpus_preprocess"]["counts"]["test"]
    for route, want in (("corpus_preprocess", ("frontend",)), ("corpus_units_only", ("gru",)),
                        ("corpus_uniform", ("gru", "griffin_lim")), ("corpus_adaptive", ("gru", "griffin_lim")),
                        ("wavs_units_only", ("frontend", "gru"))):
        for name in ("frontend", "gru", "griffin_lim"):
            n = launches[route][name]
            check(n > 0 if name in want else n == 0, f"{route}: kernel {name} launched {n} times")
        if route != "corpus_preprocess":
            check(outs[route]["n_utterances"] == n_utt, f"{route}: {outs[route]['n_utterances']} utterances")

    # every kernel at each route's own captured inputs against its plain
    # version (shapes no earlier phase reaches: kernel 4 at 24 x 640 frames,
    # past the L2, and at 2 x 2,176; kernel 2 masked at 24 rows x 640
    # steps); a wrapper's captured calls are its launches
    held = {}
    for route in routes:
        for name in ("frontend", "gru", "griffin_lim"):
            n = sum(count for _, _, count in calls[route][name].values())
            check(n == launches[route][name], f"{route}: {n} captured {name} calls, "
                  f"{launches[route][name]} launches")
            if calls[route][name]:
                held.setdefault(name, {})[route] = hold_path_calls(name, calls[route][name], route)
    print("kernels at the corpus routes' inputs against their plain versions: " + "; ".join(
        f"{name} {' '.join(f'{r} {e:.3e}' for r, e in by.items())} "
        f"({'consistency |diff|, bar 1e-3' if name == 'griffin_lim' else 'max_abs_err, bar 1e-4'}"
        f"{' beside float64 near the dB floor' if name == 'frontend' else ''})"
        for name, by in held.items()), flush=True)

    # outputs: (a) == (b) bit for bit; (c) agrees with (b) up to bits whose
    # plain CPU logit margin is < 1e-4; (d) well formed
    bun = load_export(bundle)
    hps = bun.hps
    feats, names, srcs = load_corpus_split(ds, "test")
    flips, flip_margin, n_bits = 0, 0.0, 0
    cpu_enc = None
    for f, utt, spk in zip(feats, names, srcs):
        ub = read_units(work / "b" / "units" / f"{utt}.txt")
        check(ub.shape == (-(-f.shape[0] // hps.downsample), hps.emb_size), f"{utt} units {ub.shape}")
        check(np.array_equal(read_units(work / "a" / "units" / f"{utt}.txt"), ub),
              f"{utt}: units-only units differ from the full conversion's")
        uc = read_units(work / "c" / "units" / f"{utt}.txt")
        n_bits += ub.size
        if (uc != ub).any():
            if cpu_enc is None:
                cpu_enc = Encoder(hps)
                cpu_enc.load_state_dict(from_flax({"enc": bun.enc, "dec": bun.dec})[0])
                cpu_enc.eval()
            x = torch.from_numpy(bun.stats.normalize(f, spk)).to(torch.bfloat16).float()
            with torch.inference_mode():
                lg = cpu_enc(x[None])[0].numpy()
            m = np.abs(lg[..., 0] - lg[..., 1])[uc != ub]
            flips += m.size
            flip_margin = max(flip_margin, float(m.max()))
            check(bool((m < 1e-4).all()), f"{utt}: adaptive units flip bits with margins {m[m >= 1e-4]}")
        for tgt in TARGETS:
            for d in ("b", "c"):
                check((work / d / tgt / f"{utt}.wav").exists(), f"{d}/{tgt}/{utt}.wav missing")
    for p in sorted((corpus / "test").glob("*.wav")):
        u = read_units(work / "d" / "units" / f"{p.stem}.txt")
        check(u.shape[1] == hps.emb_size and bool(((u == 0) | (u == 1)).all()), f"d/{p.stem} units")
    print(f"units: units-only == uniform on all {n_utt} utterances; adaptive vs uniform {flips} of "
          f"{n_bits} bits differ (largest plain-CPU margin {flip_margin:.3e}, < 1e-4)", flush=True)

    ev = cli.main(["eval", "--units", str(work / "b" / "units")])
    sub = cli.main(["submission", "--lang", f"english={work / 'b'}:{TARGETS[0]}", "-o", str(work / "s.zip")])
    val = cli.main(["submission", "--validate", str(work / "s.zip")])
    check(sub["ok"] and val["ok"] and val["languages"]["english"]["n_utterances"] == n_utt,
          f"submission: {val['problems'][:5]}")
    print(f"eval: {ev['bitrate']['bitrate_bits_per_second']} bits/s over {ev['bitrate']['n_frames']} "
          f"frames; submission --validate ok", flush=True)

    # more runs of (b) and (c), uncounted, in the order c, b, b, c after the
    # counted b, c: the wall around cli.main (bundle load and Converter set-up
    # included) and the CLI's own conversion seconds (features in, files out)
    walls_of = {r: [walls[r]] for r in ("corpus_uniform", "corpus_adaptive")}
    secs_of = {r: [outs[r]["seconds"]] for r in walls_of}
    for i, route in enumerate(("corpus_adaptive", "corpus_uniform", "corpus_uniform", "corpus_adaptive")):
        argv = [*routes[route], *dev]
        argv[argv.index("-result_dir") + 1] = str(work / f"{route}_again{i}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        secs_of[route].append(cli.main(argv)["seconds"])
        torch.cuda.synchronize()
        walls_of[route].append(time.perf_counter() - t0)

    report = {}
    for route in ("corpus_uniform", "corpus_adaptive"):
        out = outs[route]
        pt = {name: path_times(name, calls[route][name]) for name in ("gru", "griffin_lim")}
        big = max(calls[route]["gru"].values(), key=lambda c: c[0][0].shape[0])
        rows, t_big = big[0][0].shape[0], big[0][0].shape[1]
        step_us = 1e3 * cuda_ms(lambda: gru.gru_scan(*big[0], **big[1]), 3) / t_big
        warm = float(np.median(secs_of[route][1:]))  # the counted first run carries one-time costs
        kernel_s = sum(v["ms"] for v in pt.values()) / 1e3
        report[route] = dict(
            walls_s=walls_of[route], seconds=secs_of[route], warm_seconds=warm,
            utterances_per_s=n_utt / warm, kernel_share_of_warm_seconds=kernel_s / warm,
            griffin_lim_shapes=pt["griffin_lim"]["shapes"],
            **{k: out[k] for k in ("n_dispatches", "padding_overhead", "executed_overhead", "bucket_edges")},
            launches=launches[route], path_ms={k: v["ms"] for k, v in pt.items()},
            path_plain_ms={k: v["plain_ms"] for k, v in pt.items()},
            path_bound_ms={k: v["bound_ms"] for k, v in pt.items()},
            gru_largest_rows=rows, gru_largest_rows_us_a_step=step_us)
        print(f"{route}: conversion seconds (CLI) {', '.join(f'{x:.4f}' for x in secs_of[route])}, walls "
              f"{', '.join(f'{x:.4f}' for x in walls_of[route])} s (runs in the order b, c, c, b, b, c); "
              f"warm median {warm:.4f} s, {n_utt / warm:.3f} utterances/s; {out['n_dispatches']} dispatches, "
              f"edges {out['bucket_edges']}, padding overhead {out['padding_overhead']}, executed overhead "
              f"{out['executed_overhead']}; "
              + "; ".join(f"{k} {v['launches']} launches, kernel {v['ms']:.3f} ms, plain {v['plain_ms']:.3f} ms, "
                          f"bound {v['bound_ms']:.4f} ms" for k, v in pt.items())
              + f"; kernels 2 + 4 {100 * kernel_s / warm:.1f}% of the warm seconds"
              + f"; gru at its largest {rows} rows (T={t_big}): {step_us:.3f} us a step", flush=True)
        print(f"  griffin_lim by shape: " + ", ".join(
            f"{x['shape']} x{x['count']} {x['ms']:.3f} ms" for x in pt["griffin_lim"]["shapes"]), flush=True)

    # kernel 4 (GL-20) at rows x 640 frames: time a launch (n_iters + 2 a
    # call) and a frame-iteration, beside the complex spectra's bytes
    gl_rows = {}
    cfg = bun.acfg
    for rows in (2, 4, 8, 16, 24, 32):
        g = torch.Generator().manual_seed(rows)
        amp = (torch.rand(rows, 640, cfg.n_freq, generator=g) ** 3).to(device)
        ms = cuda_ms(lambda: griffin_lim.griffin_lim(amp, cfg, n_iters=20), 3)
        spec_mb = rows * 640 * cfg.n_freq * 8 / 1e6
        gl_rows[rows] = dict(ms=ms, us_a_launch=1e3 * ms / 22, ns_a_frame_iteration=1e6 * ms / (22 * rows * 640),
                             spectra_mb=spec_mb)
        print(f"griffin_lim GL-20 {rows} x 640: {ms:.3f} ms, {gl_rows[rows]['us_a_launch']:.1f} us a launch, "
              f"{gl_rows[rows]['ns_a_frame_iteration']:.2f} ns a frame-iteration, complex spectra "
              f"{spec_mb:.1f} MB (L2 50 MB)", flush=True)

    # kernel 2 at the frame budget's row counts: 128 utterance rows, and the
    # decoder's 2 x 128 and the encoder's 192 beside them
    big_rows = {}
    for b in (128, 192, 256):
        g = torch.Generator().manual_seed(b)
        xw = torch.randn(b, 64, 1536, generator=g).to(device)
        wh = (torch.randn(512, 1536, generator=g) / math.sqrt(512)).to(device)
        bh = (0.1 * torch.randn(1536, generator=g)).to(device)
        lens = torch.randint(1, 65, (b,), generator=g, dtype=torch.int32).to(device)
        before = gru.launches
        ys = gru.gru_scan(xw, wh, bh)
        torch.cuda.synchronize()
        n_launch = gru.launches - before
        err = max((ys - gru.gru_scan_plain(xw, wh, bh)).abs().max().item(),
                  (gru.gru_scan(xw, wh, bh, lens, reverse=True)
                   - gru.gru_scan_plain(xw, wh, bh, lens, reverse=True)).abs().max().item())
        check(err <= 1e-4, f"gru B={b}: max_abs_err {err}")
        us = 1e3 * cuda_ms(lambda: gru.gru_scan(xw, wh, bh), 5) / 64
        rows_a_launch = gru.scan_plan(xw.device, b, 512)[6]
        big_rows[b] = dict(us_a_step=us, launches_a_scan=n_launch, rows_a_launch=rows_a_launch, max_abs_err=err)
        print(f"gru B={b} T=64 H=512: {us:.3f} us a step, {n_launch} launch(es) a scan of {rows_a_launch} rows "
              f"each, one after another on the stream; max_abs_err fwd / masked rev {err:.3e} (atol 1e-4)",
              flush=True)
    return dict(launches=launches, routes=report, held_at_path=held, gru_big_rows=big_rows,
                gl_rows_640=gl_rows, unit_flips=flips,
                unit_bits=n_bits, flip_margin=flip_margin, bitrate=ev["bitrate"],
                preprocess_s=walls["corpus_preprocess"], wavs_units_only_s=walls["wavs_units_only"],
                units_only_s=walls["corpus_units_only"])


def train_path(work: Path) -> dict:
    """preprocess -> train1 -> train1 (resumed) -> train2 -> export through
    the CLI at flagship width on the card, kernel launches counted from just
    before preprocess to just after export; then a convert with the trained
    bundle, its launches counted apart."""
    import shutil

    import numpy as np
    import torch

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs
    from zerospeech_tts_tpu_torch.convert import read_units
    from zerospeech_tts_tpu_torch.train import init_state
    from zerospeech_tts_tpu_torch.tools.workload import write_train_corpus

    shutil.rmtree(work, ignore_errors=True)
    corpus = write_train_corpus(work, seed=0)
    ds, ck = str(work / "ds"), str(work / "ck")
    hps, _ = load_configs(DEFAULT_HPS_PATH)
    common = ["--device", "cuda"]
    calls: dict = {}
    with capture(("gru_bwd",), calls):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre = cli.main(["preprocess", "--corpus", str(corpus), "-dataset_path", ds, *common])
        r1 = cli.main(["train1", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "4", *common])
        state1 = r1.pop("state")
        r1b = cli.main(["train1", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "5", *common])
        r1b.pop("state")
        r2 = cli.main(["train2", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "1",
                       "--targets", "V001", "V002", *common])
        state2 = r2.pop("state")
        ex = cli.main(["export", "-dataset_path", ds, "-ckpt_dir", ck, "--out", str(work / "bundle"),
                       *common])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    print(f"training path wall {wall:.2f} s; launches {launches}", flush=True)
    for name in ("frontend", "gru", "gru_bwd"):
        check(launches[name] > 0, f"kernel {name} was not launched on the training path")

    # the trained bundle converts: a path of its own, counted apart
    ops.reset_launches()
    cv = cli.main(["convert", "--from-export", str(work / "bundle"), "--from-wavs", str(corpus / "test"),
                   "-result_dir", str(work / "out"), "--target", "V001", "--gl-iters", "8", *common])
    torch.cuda.synchronize()
    cv_launches = ops.launch_counts()
    print(f"convert after training: launches {cv_launches}", flush=True)
    for name in ("frontend", "gru", "griffin_lim"):
        check(cv_launches[name] > 0, f"kernel {name} was not launched converting with the trained bundle")

    check(r1["step"] == 12 and r1["resumed_from"] is None, f"train1 ran to step {r1['step']}")
    check(r1b["resumed_from"] == 12 and r1b["step"] == 15,
          f"resumed train1: from {r1b['resumed_from']} to {r1b['step']} (want 12 -> 15)")
    check(r2["step"] == 15 + hps.n_critic + 1 and ex["step"] == r2["step"], f"train2/export step {r2['step']}")
    phases = {**r1["phases"], **{f"{k} (resumed)": v for k, v in r1b["phases"].items()},
              **r2["phases"]}
    check(set(phases) == {"pretrain_AE", "pretrain_C", "train", "train (resumed)", "patchGAN"},
          f"phases run: {sorted(phases)}")
    for k, v in phases.items():
        print(f"  {k}: {v['steps']} steps, {v['seconds']:.3f} s, {v['steps_per_s']:.3f} steps/s; "
              + " ".join(f"{m}={x:.4g}" for m, x in v["last"].items()))
        check(all(np.isfinite(x) for x in v["last"].values()), f"{k}: non-finite losses {v['last']}")
    init = init_state(hps, device="cuda")
    for name in ("enc", "dec"):
        for (pname, p), p0 in zip(state1.modules[name].named_parameters(), init.modules[name].parameters()):
            check(p.grad is not None and bool(p.grad.abs().sum() > 0), f"{name}.{pname} got no gradient")
            check(not torch.equal(p.detach(), p0.detach()), f"{name}.{pname} did not change in train1")
    for gname in ("enc.rnn.fwd.wh", "enc.rnn.bwd.wh", "dec.rnn.wh"):
        mod, rest = gname.split(".", 1)
        p = state1.modules[mod].get_parameter(rest)
        print(f"  {gname}: |grad| {p.grad.norm().item():.4e}, moved "
              f"{(p - init.modules[mod].get_parameter(rest)).norm().item():.4e}")
    for (pname, p), p0 in zip(state2.dis.named_parameters(), init.dis.parameters()):
        if pname != "patch_head.bias":  # cancels in mean(real) - mean(fake): zero gradient
            check(not torch.equal(p.detach(), p0.detach()), f"dis.{pname} did not change in train2")
    u = read_units(work / "out" / "units" / "T001_0.txt")
    check(cv["n_wavs"] == 1 and u.shape[1] == hps.emb_size, f"convert after training: {cv}, units {u.shape}")
    print(f"  set-up (corpus to the card, model init): train1 {r1['setup_s']:.2f} s, train2 "
          f"{r2['setup_s']:.2f} s; preprocess {pre['seconds']:.2f} s for {pre['counts']} utterances",
          flush=True)
    path = path_times("gru_bwd", calls["gru_bwd"])
    check(path["launches"] == launches["gru_bwd"], f"gru_bwd: {path['launches']} captured calls")
    print(f"gru_bwd on the training path: {path['launches']} launches, shapes "
          + ", ".join(f"{x['shape']} x{x['count']}" for x in path["shapes"])
          + f": kernel {path['ms']:.3f} ms  plain {path['plain_ms']:.3f} ms  bound {path['bound_ms']:.4f} ms",
          flush=True)
    return dict(launches=launches, convert_launches=cv_launches, path=path, wall_s=wall, phases=phases,
                setup_s=[r1["setup_s"], r2["setup_s"]], preprocess_s=pre["seconds"])


def card_vs_cpu_steps() -> dict:
    """A pretrain_AE step and a train step at flagship width with batch 4
    on the card and on the CPU, from the same state, the same draws and
    the card's hard decisions (tools/step_parity.py, seed 0): losses
    within 1e-4 relative, each module's gradient within 1e-3 rel-L2, and
    at most 1e-5 of the CPU's own decisions differing from the card's
    (an element within f32 rounding of a decision: 0-3 of 3.7-5.2 M over
    8 seeds on an H100), so a fault that moves many decisions on the card
    is not copied onto the CPU unseen."""
    from zerospeech_tts_tpu_torch.tools.step_parity import card_vs_cpu

    report = card_vs_cpu(seed=0)
    for step, r in report.items():
        print(f"card vs CPU {step} (flagship, batch 4, seed 0): loss rel "
              + " ".join(f"{k} {v:.2e}" for k, v in r["loss_rel"].items())
              + " (<= 1e-4); grad rel-L2 " + " ".join(f"{k} {v:.2e}" for k, v in r["grad_rel_l2"].items())
              + f" (<= 1e-3); CPU decisions replayed from the card: {r['flips']} of "
              f"{r['decisions']} differed (<= 1e-5 of them)", flush=True)
        want = {"enc", "dec"} | ({"clf"} if step == "step_train" else set())
        check(set(r["modules"]) == want, f"{step}: gradients of {r['modules']}")
        check(r["decisions"] > 0 and r["flips"] <= 1e-5 * r["decisions"],
              f"{step}: {r['flips']} of {r['decisions']} CPU decisions differ from the card's")
        check(max(r["grad_rel_l2"].values()) <= 1e-3, f"{step} gradients: {r['grad_rel_l2']}")
        check(max(r["loss_rel"].values()) <= 1e-4, f"{step} losses: {r['loss_rel']}")
    return report


if __name__ == "__main__":
    main()
