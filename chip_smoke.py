#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zerospeech_tts_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Refuses to run without a CUDA card (or outside a checkout of the repo).
2. Builds the four hand-written kernels from csrc/ with nvcc (sm_90a), all
   at once.
3. Holds each kernel against its plain PyTorch version on the card at its
   path's flagship shapes (kernel 1 also on full-scale frames) and times
   both, beside the card's least time for
   the same work and, where one PyTorch call computes the same function,
   that call's time; holds GRUScan's gradients against cuDNN nn.GRU;
   prints kernel 2's spread (column x batch groups, shared memory) at the
   paths' batch sizes and its time a step at B=16 for T=64 and T=512 (the
   per-step chain apart from the launch's fixed cost).
4. Conversion path: converts a seeded 8-wav, 2-target corpus at flagship
   width (hps/zerospeech.json, random weights from a seed, GL-100) through
   the port's CLI, counting kernel launches and keeping each kernel's
   inputs, checks the outputs, times kernels 1, 2 and 4 at the path's own
   inputs (beside their plain versions and bounds; kernel 2 also per
   step), holds Griffin-Lim at GL-100 on each of the path's buckets
   against its plain version (and times the same recurrence as a loop of
   torch.fft calls, a yardstick), and holds the card's conversion of one
   utterance against the plain CPU path.
5. Training path: a seeded 6-speaker wav corpus through the CLI at
   flagship width: preprocess -> train1 (4 iterations a phase) -> train1
   resumed -> train2 (one GAN cycle) -> export, counting kernel launches
   and timing kernel 3 at the path's own inputs, then convert with the
   trained bundle, counted apart; checks losses,
   parameter updates and gradients; then one pretrain_AE and one train
   step on the card against the CPU from the same state and the same draws,
   with the CPU replaying the card's hard decisions and few of its own
   differing.
6. Prints the card (nvidia-smi name, power limit), one JSON line with the
   kernels' results (``launches``: the count on the path the kernel's slice
   ported, conversion or training; ``launches_by_path``: each path's own
   count; ``ms``/``plain_ms``/``bound_ms`` at the test shapes, ``path_*``
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
    "gru_bwd": "zerospeech_tts_tpu/ops/pallas_gru.py:218",
    "griffin_lim": "zerospeech_tts_tpu/ops/pallas_gl.py:470",
}
# H100 SXM peaks: f32 outside the tensor cores, HBM
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


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


def bound(flops: float, nbytes: float) -> dict:
    """The card's least time for the work: the larger of f32 FLOPs at the
    f32 peak and bytes (each input read once, each output written once) at
    the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def rfft_flops(n: int) -> float:
    """Operations of one real FFT (or inverse) of n points: 2.5 n log2 n,
    half the usual 5 n log2 n of a complex one. The least work of a DFT,
    whatever the kernel does (kernels 1 and 4 run packed complex four-step
    FFTs, kernel 1 also direct sums for its near-floor bins)."""
    return 2.5 * n * math.log2(n)


def rel_l2(a, b) -> float:
    import torch

    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


# kernel -> (module in ops/, wrapper, plain version): both take the same arguments
KERNEL_FNS = {
    "frontend": ("frontend", "fused_frontend", "frontend_plain"),
    "gru": ("gru", "gru_scan", "gru_scan_plain"),
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
    kwargs, count], then calls through. The wrapper is replaced in every
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

        def wrapper(*args, _orig=orig, _calls=calls, **kw):
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
    if name == "gru":
        xw, wh, bh = args[:3]
        lengths = args[3] if len(args) > 3 else kw.get("lengths")
        b, t, h3 = xw.shape
        h = h3 // 3
        steps = b * t if lengths is None else int(lengths.sum())  # masked steps only pass the state on
        return 2 * steps * h * h3, 4 * (b * t * h3 + b * t * h + h * h3 + h3)
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
        bnd = bound(*work(name, args, kw))["bound_ms"]
        tot["ms"] += count * k_ms
        tot["plain_ms"] += count * p_ms
        tot["bound_ms"] += count * bnd
        tot["launches"] += count
        tot["shapes"].append(dict(shape=[tuple(a.shape) for a in args if hasattr(a, "shape")][0],
                                  count=count, ms=k_ms, plain_ms=p_ms, bound_ms=bnd))
    return tot


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
            TARGETS, WAV_SAMPLES, cuda_ms, fullscale, speechlike, write_train_corpus, write_workload,
        )
    except ImportError as e:
        fail(f"zerospeech_tts_tpu_torch is not importable beside {__file__} ({e})")

    dev = torch.device("cuda")
    print(f"card: {card_line()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ops.KERNELS)) as pool:  # one nvcc per source, all at once
        list(pool.map(build.load, ops.KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {len(ops.KERNELS)} kernels", flush=True)
    for name in ops.KERNELS:
        print(f"  nvcc {name}: {build.build_seconds[name]:.2f} s", flush=True)
        for line in build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    for b in (1, 2, 6, 16, 32, 64):  # kernel 2: the conversion path's rows, the test shape, training's
        kc, n_k, nb, n_b, cb, smem, rows, wreg = gru.scan_plan(dev, b, 512)
        print(f"  gru recurrence B={b} H=512: {n_k} column groups x {n_b} batch groups = {n_k * n_b} "
              f"blocks of {kc} columns x {nb} rows ({cb} staged at a time), {smem} B dynamic shared "
              f"memory each, wh in {'registers and ' if wreg else ''}shared memory, {rows} rows a launch")
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

    def consistency(out, amp):
        re, im = audio.stft(out, cfg)
        m2 = torch.sqrt(re * re + im * im)[:, 4:-4]
        m = amp[:, 4:-4]
        return (torch.linalg.norm(m2 - m) / torch.linalg.norm(m)).item()

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
        ck, cp = consistency(out_k, amp), consistency(out_p, amp)
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
        ck, cp, cf = consistency(out_k, amp), consistency(out_p, amp), consistency(out_f, amp)
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

    # ---------------------------------------------- training path, end to end
    train = train_path(OUT / "train")
    by_path = {"conversion": conv_launches, "training": train.pop("launches"),
               "convert_after_training": train.pop("convert_launches")}
    path["gru_bwd"] = train.pop("path")
    step_check = card_vs_cpu_steps()
    check("jax" not in sys.modules, "jax was imported")

    kernels = []
    for name in ops.KERNELS:
        r, pt = results[name], path[name]
        on = "training" if name == "gru_bwd" else "conversion"
        kernels.append(dict(
            name=name, route="cuda", source=f"{SRC}/{name}.cu", replaces=REPLACES[name],
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
             reference_pcm_rel_l2=pcm_rel, training=train,
             card_vs_cpu_steps=step_check, card=card_line()), indent=2) + "\n")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


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
