#!/usr/bin/env python3
"""Smoke run of the PyTorch port (zerospeech_tts_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

1. Refuses to run without a CUDA card (or outside a checkout of the repo).
2. Builds the hand-written kernels from their five csrc/ sources with nvcc
   (sm_90a) and the native wav reader (native/wav_reader.cpp, g++), all at
   once, and prints kernel 2's spread and the widest H whose columns of wh
   stay whole on chip in f32 and in bf16 (every shipped path's spread
   keeps them whole: Hs = H, checked for kernels 2 and 3).
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
3b. Wide H: kernel 2 in f32 at H = 2,048 and 4,096 and in bf16 at 2,304
   (B=16, T=64, forward and reverse masked) and kernel 3 at H = 2,048
   (B=16, T=32) run their wide mode (Hs < H rows of wh on chip, the rest
   read through L2 each step), one counted launch each, held against
   their plain versions with the bars above; Hs, ms, the bound and the L2
   bytes a step are printed.
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
   4's lifted magnitudes held against a float64 lift. These runs train
   from the arena on the card (--device-data).
6b. Host data path (the JAX package's default training input) at flagship
   width: the 6-speaker training corpus through preprocess -index_path
   --workers 2 (two shard subprocesses running kernel 1, then the merge),
   held against a single-process build (arenas within 1e-6, stats within
   1e-10, the sorted speaker map, the same segment index); train1 from the
   SegmentLoader (4 iterations a phase) with --check-numerics --profile,
   whose trace must name kernels 2 and 3; train2 (one GAN cycle) from the
   loader; then steps/s of the loader route beside the --device-data route
   on the same 20-iteration schedule (printed, no bar).
6c. Wires (wire_routes, matmul_precision_arms) at flagship width, each
   route counted apart and every kernel input it met held against the
   plain version: convert --from-wavs --wire-mulaw (kernels 1, 2 and 4;
   units > 0.95 of the exact route's, int16 wavs of its shapes), the
   corpus route with --wire-uint8 (kernels 2 and 4; units > 0.95 of the
   bf16 wire's) and with --adaptive-buckets 4 --bucket-cost-model executed
   --frame-budget 8192 --dispatch-cost-frames N at N = 0 and at the
   smallest power of two that changes the plan (fewer dispatches, the
   planner's edges), serve --wire-mulaw (one request: PCM16 of the int16
   wire's length); then --matmul-precision float32, tensorfloat32 and
   bfloat16, each a GL-100 conversion and one train1 step a phase, the
   lower arms held to cli.MATMUL_PRECISION_BARS against float32 (units,
   losses) and the package's pin (TF32 off, 'highest') restored and
   checked after every arm.
6d. Multi-device at flagship width (multi_device_path): tools/dp_parity.py
   with two ranks on cuda:0 over gloo (and over NCCL on two cards where two
   are visible), one step of each kind from Adam moments that are not zero
   against the single-process step (ranks bit-equal; parameters, gradients
   and pre-clip gradient norms within 1e-5 relative; metrics within 1e-4),
   and again with a planted fault (the gradient all_reduce left undivided
   by the world size), which every step must fail;
   train1 --mesh data=2 from the SegmentLoader and with --device-data on
   the host phase's corpus (rank 0 alone prints and writes, its checkpoint
   loads, finite losses, kernels 2 and 3 launched), its steps/s beside one
   process's; train1 over NCCL at world 1 (the data-parallel code path);
   the conversion workload through Converter(devices=["cuda:0", "cuda:0"])
   against one device (units bit for bit or within a 1e-4 logit margin,
   PCM within 1 LSB, kernels 1, 2 and 4 held at this route's inputs).
   Tensor parallelism over model=2 (the flagship's min_size): dp_parity at
   data=1,model=2 (2 ranks) and data=2,model=2 (4 ranks) on cuda:0 over
   gloo (over NCCL on cards 0-1 and 0-3 where visible), at the same bars
   with the blocks gathered, each rank's resident state
   (memory_allocated, once placed and after a step of each kind) within 2%
   of its device0_bytes count and below world 1's; a planted swap of
   gradient blocks between the model ranks, which every step must fail;
   train1 --mesh data=1,model=2 from the loader (rank 0 alone writes, its
   step loads at world 1), steps/s beside one process's. Every launched
   world runs RANK_CLI: kernels 2 and 3 launched as often as called, and
   rank 0 holds every input they met against the plain versions.
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
WIRE_AGREE = 0.95  # unit agreement of a wire route with the same route's int16 / bf16 wire (JAX's bar)


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
    module of the port that holds it, and on exit the kernel is restored
    in every module of the port holding the wrapper (a module first
    imported inside the block imports the wrapper)."""
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
        patched.append((KERNEL_FNS[name][1], wrapper, orig))
    try:
        yield store
    finally:
        # every module of the port holding a wrapper, one first imported inside the block too
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("zerospeech_tts_tpu_torch"):
                for attr, wrapper, orig in patched:
                    if getattr(mod, attr, None) is wrapper:
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
    if name in ("gru", "gru_bf16"):  # bf16: 2-byte xw, wh, bh and ys (the f32 state stays on chip)
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

    Kernel 2, and kernel 1's mel: max_abs_err <= 1e-4; kernel 3: dxw
    max_abs_err <= 1e-4, dwh and dbh rel-L2 <= 1e-4; kernel 2 in bf16:
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
        elif name == "gru_bwd":
            err = (out_k[0] - out_p[0]).abs().max().item()
            r_wh, r_bh = rel_l2(out_k[1], out_p[1]), rel_l2(out_k[2], out_p[2])
            check(err <= 1e-4 and r_wh <= 1e-4 and r_bh <= 1e-4,
                  f"{where}: gru_bwd at {shape} {kw}: dxw max_abs_err {err}, dwh {r_wh}, dbh {r_bh} (1e-4)")
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
    from zerospeech_tts_tpu_torch.data import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ops.SOURCES) + 1) as pool:  # one nvcc per source and g++, all at once
        wav_reader = pool.submit(native.build)
        list(pool.map(build.load, ops.SOURCES))
        wav_reader = wav_reader.result()
    print(f"build: {time.perf_counter() - t0:.2f} s wall for {len(ops.KERNELS)} kernels from "
          f"{len(ops.SOURCES)} sources and the wav reader ({wav_reader.name})", flush=True)
    for src in ops.SOURCES:
        print(f"  nvcc {src}.cu: {build.build_seconds[src]:.2f} s", flush=True)
        for line in build.build_log.get(src, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")
    for dt in (torch.float32, torch.bfloat16):
        for b in (1, 2, 6, 16, 32, 64, 128, 192, 256):  # kernel 2: the paths' rows, the test shape, training's
            kc, n_k, nb, n_b, cb, smem, rows, wreg, hs, _ = gru.scan_plan(dev, b, 512, dt)
            where = ("registers (mma fragments)" if wreg else "shared memory (mma fragments)") \
                if dt == torch.bfloat16 else f"{'registers and ' if wreg else ''}shared memory"
            print(f"  gru {str(dt)[6:]} recurrence B={b} H=512: {n_k} column groups x {n_b} batch groups = "
                  f"{n_k * n_b} blocks of {kc} columns x {nb} rows ({cb} staged at a time), {smem} B dynamic "
                  f"shared memory each, wh in {where} (Hs {hs}), {rows} rows a launch")
            check(hs == 512, f"gru {dt} B={b} H=512: the spread keeps {hs} of 512 rows of wh on chip")
    widest = {}
    for dt in (torch.float32, torch.bfloat16):  # the widest H whose columns stay whole (wider: wide mode)
        lo, hi = 512, 4096
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if gru.scan_plan(dev, 16, mid, dt)[8] == mid else (lo, mid - 1)
        widest[str(dt)[6:]] = lo
    print(f"  gru widest H with whole columns on chip (B=16): {widest}", flush=True)
    for b, h in ((32, 512), (64, 512), (128, 512)):  # kernel 3's recurrence, training shapes
        kc, nb, cb, n_k, n_b, smem, hs = gru.bwd_plan(dev, b, h)
        print(f"  gru_bwd recurrence B={b} H={h}: {n_k} column groups x {n_b} batch groups = "
              f"{n_k * n_b} blocks of {kc} columns x {nb} rows ({cb} staged at a time), "
              f"{smem} B dynamic shared memory each (Hs {hs})")
        check(hs == h, f"gru_bwd B={b} H={h}: the spread keeps {hs} of {h} rows of wh on chip")

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
    wide = wide_h(dev)

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
    host = host_data_path(OUT / "host")

    # ------------------------- the wires, the dispatch cost, --matmul-precision
    wires = wire_routes(OUT, wav_dir, result_dir, OUT / "corpus")
    arms = matmul_precision_arms(OUT, wav_dir, OUT / "host")
    multi = multi_device_path(OUT / "multi", OUT / "host", OUT)
    by_path = {"conversion": conv_launches, **bf16.pop("launches"), "serve": served.pop("launches"),
               **corpus.pop("launches"), "training": train.pop("launches"),
               "convert_after_training": train.pop("convert_launches"), **mel.pop("launches"),
               "host_data": host.pop("launches"), **wires.pop("launches"), **arms.pop("launches"),
               **multi.pop("launches")}
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
             bf16_routes=bf16, serve=served, mel=mel, wide_h=wide, host_data=host, wire_routes=wires,
             matmul_precision=arms, multi_device=multi,
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


def _counted(route: str, argv, names, calls: dict, launches: dict, walls: dict):
    """cli.main(argv) as one counted route: its kernel launches set to 0
    just before and read just after, each named kernel's inputs kept in
    calls[route] (capture); returns the verb's result."""
    import torch

    from zerospeech_tts_tpu_torch import cli, ops

    calls[route] = {}
    with capture(names, calls[route]):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli.main(argv)
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        launches[route] = ops.launch_counts()
    return res


def _hold_routes(routes, calls: dict, launches: dict) -> dict:
    """Every kernel input each route captured against the plain version
    (hold_path_calls' bars); a wrapper's captured calls are its launches."""
    held = {}
    for route in routes:
        for name, c in calls[route].items():
            n = sum(count for _, _, count in c.values())
            check(n == launches[route][name], f"{route}: {n} captured {name} calls, {launches[route][name]} launches")
            if c:
                held[f"{name} {route}"] = hold_path_calls(name, c, route)
    return held


def _want_launches(route: str, launches: dict, want) -> None:
    for name, n in launches[route].items():
        check(n > 0 if name in want else n == 0, f"{route}: kernel {name} launched {n} times")


def bf16_routes(out: Path, wav_dir: Path, exact_dir: Path, device: str = "cuda") -> dict:
    """``convert --bf16`` and ``convert --bf16 --enc-f32`` through the CLI on
    the conversion path's wavs and bundle (flagship width, GL-100), each
    route's launches counted apart (0 just before, read just after) and its
    kernel inputs kept: the all-bf16 route runs kernel 2 in bf16 for the
    encoder and the decoder, the enc-f32 route f32 for the encoder; neither
    takes the plain route. Unit agreement with the exact route's files:
    >= 0.999 for enc-f32, > 0.9 for all-bf16. Kernel 2 (both modes) and
    kernels 1 and 4 are held at every input the routes gave them; kernel 2's
    bf16 path times come from the all-bf16 route."""
    import scipy.io.wavfile

    from zerospeech_tts_tpu_torch.tools.workload import TARGETS

    routes = {"conversion_bf16": ["--bf16"], "conversion_bf16_enc_f32": ["--bf16", "--enc-f32"]}
    launches, calls, agree, walls = {}, {}, {}, {}
    for route, flags in routes.items():
        res = out / f"result_{route}"
        _counted(route, ["convert", "--from-export", str(out / "bundle"), "--from-wavs", str(wav_dir),
                         "-result_dir", str(res), "--target", *TARGETS, *flags, "--device", device],
                 ("frontend", "gru", "griffin_lim"), calls, launches, walls)
        _want_launches(route, launches,
                       {"frontend", "gru_bf16", "griffin_lim"} | ({"gru"} if "--enc-f32" in flags else set()))
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
    held = _hold_routes(routes, calls, launches)
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


def wire_routes(out: Path, wav_dir: Path, exact_dir: Path, corpus_work: Path, device: str = "cuda") -> dict:
    """The two wires and the dispatch cost through the CLI on ``device`` at
    flagship width (the conversion path's wavs, bundle and exact-route
    files; the corpus phase's split and its uniform route's files), each
    route's launches counted apart and every kernel input it gave a kernel
    held against the plain version:

    - ``convert --from-wavs --wire-mulaw`` at GL-100: kernels 1, 2 and 4;
      unit agreement with the exact route > WIRE_AGREE; int16 wavs of the
      exact route's shapes.
    - the corpus route with ``--wire-uint8``: kernels 2 and 4; unit
      agreement with the same route on the bf16 wire > WIRE_AGREE.
    - the corpus route with ``--adaptive-buckets 4 --bucket-cost-model
      executed --dispatch-cost-frames N`` at N = 0 and at the smallest
      power-of-two N (frame-rows) from 2^10 that changes the planner's
      edges for these lengths: each plan's dispatches and edges, the
      second with fewer dispatches and the plan the planner gave.
    - ``serve --wire-mulaw``: one /convert request answers a 16 kHz PCM16
      wav of the int16 wire's length (the exact route's file)."""
    import base64
    import io
    import threading
    import urllib.request

    import numpy as np
    import scipy.io.wavfile
    import torch

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.convert import Converter, load_corpus_split
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.params import from_flax
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS

    bundle, ds = out / "bundle", corpus_work / "ds"
    dev = ["--device", device]
    corpus = ["convert", "--from-export", str(bundle), "-dataset_path", str(ds), "--target", *TARGETS]
    names = ("frontend", "gru", "griffin_lim")
    launches, calls, walls, agree, outs = {}, {}, {}, {}, {}

    route = "wire_mulaw"
    res = out / f"result_{route}"
    outs[route] = _counted(route, ["convert", "--from-export", str(bundle), "--from-wavs", str(wav_dir),
                                   "-result_dir", str(res), "--target", *TARGETS, "--wire-mulaw", *dev],
                           names, calls, launches, walls)
    _want_launches(route, launches, names)
    agree[route] = unit_files_agreement(res, exact_dir)[0]
    for p in sorted((exact_dir / TARGETS[0]).glob("*.wav")):
        for tgt in TARGETS:
            sr, pcm = scipy.io.wavfile.read(res / tgt / p.name)
            want = scipy.io.wavfile.read(exact_dir / tgt / p.name)[1]
            check(sr == 16000 and pcm.dtype == np.int16 and pcm.shape == want.shape,
                  f"{route} {tgt}/{p.name}: {sr} Hz {pcm.dtype} {pcm.shape}, want {want.shape}")

    route = "corpus_wire_uint8"
    res = corpus_work / "uint8"
    outs[route] = _counted(route, [*corpus, "-result_dir", str(res), "--wire-uint8", *dev],
                           names, calls, launches, walls)
    _want_launches(route, launches, ("gru", "griffin_lim"))
    agree[route] = unit_files_agreement(res, corpus_work / "b")[0]

    # the dispatch cost: N = 0, then the smallest power of two from 2^10 whose plan differs
    bun = load_export(bundle)
    feats = load_corpus_split(ds, "test")[0]
    frames = [f.shape[0] for f in feats]
    planner = Converter(bun.hps, bun.acfg, *from_flax({"enc": bun.enc, "dec": bun.dec}), stats=bun.stats,
                        frame_budget=8192, device="cpu")
    plan0 = planner.fit_buckets(frames, 4, cost_model="executed")
    n_big = 1024.0
    while planner.fit_buckets(frames, 4, cost_model="executed", dispatch_cost_frames=n_big) == plan0:
        n_big *= 2
        check(n_big <= 2.0**30, f"no dispatch cost up to 2^30 frame-rows changes the plan {plan0}")
    plan_big = planner.bucket_edges
    plans = {}
    for n_cost, want in ((0.0, plan0), (n_big, plan_big)):
        route = f"corpus_dispatch_cost_{int(n_cost)}"
        outs[route] = _counted(route, [*corpus, "-result_dir", str(corpus_work / route), "--adaptive-buckets", "4",
                                       "--bucket-cost-model", "executed", "--frame-budget", "8192",
                                       "--dispatch-cost-frames", str(n_cost), *dev], names, calls, launches, walls)
        _want_launches(route, launches, ("gru", "griffin_lim"))
        plans[n_cost] = {k: outs[route][k] for k in ("bucket_edges", "n_dispatches", "padding_overhead",
                                                     "executed_overhead")}
        check(outs[route]["bucket_edges"] == want, f"{route}: edges {outs[route]['bucket_edges']}, the planner's {want}")
        agree[route] = unit_files_agreement(corpus_work / route, corpus_work / "b")[0]
    check(plans[n_big]["n_dispatches"] < plans[0.0]["n_dispatches"],
          f"--dispatch-cost-frames {n_big}: {plans[n_big]['n_dispatches']} dispatches, at 0 {plans[0.0]['n_dispatches']}")

    # serve --wire-mulaw: one request, its launches counted from just before it to just after
    route = "serve_wire_mulaw"
    args = cli.build_parser().parse_args(["serve", "--from-export", str(bundle), "--host", "127.0.0.1", "--port", "0",
                                          "--wire-mulaw", *dev])
    ready, bound_ev, served = [], threading.Event(), {}

    def on_serving(httpd, svc):
        ready.append(httpd)
        bound_ev.set()

    th = threading.Thread(target=lambda: served.update(cli.cmd_serve(args, on_serving)), daemon=True)
    th.start()
    check(bound_ev.wait(600), "serve --wire-mulaw did not start within 600 s")
    httpd = ready[0]
    wav = sorted(wav_dir.glob("*.wav"))[0]
    try:
        calls[route] = {}
        with capture(names, calls[route]):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/convert?targets={TARGETS[0]}",
                                         data=wav.read_bytes(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                body = json.loads(r.read())
            torch.cuda.synchronize()
            walls[route] = time.perf_counter() - t0
            launches[route] = ops.launch_counts()
    finally:
        httpd.shutdown()
        th.join(60)
    check(not th.is_alive(), "serve --wire-mulaw did not return after shutdown")
    _want_launches(route, launches, names)
    sr, pcm = scipy.io.wavfile.read(io.BytesIO(base64.b64decode(body["wavs"][TARGETS[0]])))
    want = scipy.io.wavfile.read(exact_dir / TARGETS[0] / wav.name)[1]
    check(sr == 16000 and pcm.dtype == np.int16 and pcm.shape == want.shape,
          f"{route}: {sr} Hz {pcm.dtype} {pcm.shape}, the int16 wire's {want.shape}")
    u = np.array([[int(v) for v in row.split()] for row in body["units"].splitlines()], np.int32)
    ref = np.loadtxt(exact_dir / "units" / f"{wav.stem}.txt", dtype=np.int32, ndmin=2)
    check(u.shape == ref.shape, f"{route}: units {u.shape}, the exact route's {ref.shape}")
    agree[route] = float((u == ref).mean())

    for route, a in agree.items():
        check(a > WIRE_AGREE, f"{route}: unit agreement {a} (> {WIRE_AGREE})")
    held = _hold_routes(list(calls), calls, launches)
    for route in calls:
        extra = ""
        if route in outs and "n_dispatches" in outs[route]:
            extra = f"; {outs[route]['n_dispatches']} dispatches, edges {outs[route]['bucket_edges']}"
        print(f"{route}: wall {walls[route]:.3f} s; launches {launches[route]}; unit agreement {agree[route]:.6f} "
              f"(> {WIRE_AGREE}){extra}", flush=True)
    print(f"--dispatch-cost-frames: 0 -> {plans[0.0]['n_dispatches']} dispatches, edges {plans[0.0]['bucket_edges']}; "
          f"{n_big:g} -> {plans[n_big]['n_dispatches']} dispatches, edges {plans[n_big]['bucket_edges']}", flush=True)
    print("kernels at the wire routes' inputs against their plain versions: "
          + "; ".join(f"{k} {v:.3e}" for k, v in held.items()), flush=True)
    return dict(launches=launches, agreement=agree, walls_s=walls, held=held, dispatch_cost={
        "n_large": n_big, "plans": {str(k): v for k, v in plans.items()}})


def matmul_precision_arms(out: Path, wav_dir: Path, host_work: Path, device: str = "cuda") -> dict:
    """--matmul-precision float32, tensorfloat32 and bfloat16 through the
    CLI: a flagship-width GL-100 conversion of the conversion path's wavs
    and one train1 step a phase (--fresh, --device-data, the host phase's
    corpus, the same seed) each, every route counted apart and its kernel
    inputs held. Gate (cli.MATMUL_PRECISION_BARS): each lower arm's unit
    agreement with the float32 arm's files and the largest relative
    distance of its losses from the float32 arm's. After every arm the
    package's pin is restored (TF32 off, precision 'highest') and checked,
    so no later phase runs under the arm's flags."""
    import numpy as np
    import torch

    from zerospeech_tts_tpu_torch import cli
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS

    dev = ["--device", device]
    train = ["train1", "-dataset_path", str(host_work / "ds"), "-index_path", str(host_work / "idx.json"),
             "--iters-override", "1", "--fresh", "--device-data", *dev]
    launches, calls, walls, losses, report = {}, {}, {}, {}, {}
    pinned = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,  # noqa: E731
                      torch.get_float32_matmul_precision())
    check(pinned() == (False, False, "highest"), f"the package's pin is not in force: {pinned()}")
    for arm in ("float32", "tensorfloat32", "bfloat16"):
        res = out / f"result_matmul_{arm}"
        try:
            _counted(f"matmul_{arm}_convert", ["convert", "--from-export", str(out / "bundle"), "--from-wavs",
                                               str(wav_dir), "-result_dir", str(res), "--target", *TARGETS,
                                               "--matmul-precision", arm, *dev],
                     ("frontend", "gru", "griffin_lim"), calls, launches, walls)
            r = _counted(f"matmul_{arm}_train1", [*train, "-ckpt_dir", str(host_work / f"ck_matmul_{arm}"),
                                                  "--matmul-precision", arm], ("gru", "gru_bwd"),
                         calls, launches, walls)
        finally:
            cli.apply_matmul_precision("float32")  # the package's pin
        check(pinned() == (False, False, "highest"), f"after --matmul-precision {arm}: {pinned()}")
        losses[arm] = {f"{ph} {k}": v for ph, d in r["phases"].items() for k, v in d["last"].items()
                       if k.startswith("loss_")}
        check(all(np.isfinite(v) for v in losses[arm].values()), f"{arm}: losses {losses[arm]}")
    for arm, bars in cli.MATMUL_PRECISION_BARS.items():
        units = unit_files_agreement(out / f"result_matmul_{arm}", out / "result_matmul_float32")[0]
        rel = {k: abs(v - losses["float32"][k]) / abs(losses["float32"][k]) for k, v in losses[arm].items()}
        worst = max(rel, key=rel.get)
        report[arm] = dict(units=units, loss_rel=rel[worst], worst_loss=worst, losses=losses[arm])
        print(f"--matmul-precision {arm}: units {units:.6f} of the float32 arm's (>= {bars['units']}); losses "
              f"within {rel[worst]:.3e} relative (<= {bars['loss_rel']:g}; largest: {worst}); convert wall "
              f"{walls[f'matmul_{arm}_convert']:.3f} s", flush=True)
        check(units >= bars["units"], f"--matmul-precision {arm}: units {units} of the float32 arm's")
        check(rel[worst] <= bars["loss_rel"], f"--matmul-precision {arm}: {worst} {rel[worst]} relative")
    exact = unit_files_agreement(out / "result_matmul_float32", out / "result")[0]
    print(f"--matmul-precision float32: units {exact:.6f} of the exact route's (>= 0.999)", flush=True)
    check(exact >= 0.999, f"--matmul-precision float32: units {exact} of the exact route's")
    held = _hold_routes(list(calls), calls, launches)
    print("kernels at the --matmul-precision arms' inputs against their plain versions: "
          + "; ".join(f"{k} {v:.3e}" for k, v in held.items()), flush=True)
    print(f"  float32 arm's losses: " + ", ".join(f"{k} {v:.6g}" for k, v in losses["float32"].items()), flush=True)
    return dict(launches=launches, arms=report, float32_losses=losses["float32"], held=held, walls_s=walls)


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
    idx = ["-index_path", str(work / "idx.json")]
    cli.main(["preprocess", "--corpus", str(corpus), "-dataset_path", ds, *idx, "--n-samples", "1000", *c])
    c_train = [*c, *idx, "--device-data"]  # the arena on the card (the loader: host_data_path)
    r1 = cli.main(["train1", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "2", "--feat", "mel",
                   *c_train])
    r1.pop("state")
    r2 = cli.main(["train2", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "1", "--feat", "mel",
                   "--data-bf16", "--targets", *TARGETS, *c_train])
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

    from zerospeech_tts_tpu_torch import cli
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
        "corpus_preprocess": ["preprocess", "--corpus", str(corpus), "-dataset_path", ds,  # no train
                              "-index_path", str(work / "idx.json")],  # split: no index is written
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
        outs[route] = _counted(route, [*argv, *dev], ("frontend", "gru", "griffin_lim"), calls, launches, walls)
        print(f"{route}: wall {walls[route]:.3f} s; launches {launches[route]}", flush=True)
    n_utt = outs["corpus_preprocess"]["counts"]["test"]
    for route, want in (("corpus_preprocess", ("frontend",)), ("corpus_units_only", ("gru",)),
                        ("corpus_uniform", ("gru", "griffin_lim")), ("corpus_adaptive", ("gru", "griffin_lim")),
                        ("wavs_units_only", ("frontend", "gru"))):
        _want_launches(route, launches, want)
        if route != "corpus_preprocess":
            check(outs[route]["n_utterances"] == n_utt, f"{route}: {outs[route]['n_utterances']} utterances")

    # every kernel at each route's own captured inputs against its plain
    # version (shapes no earlier phase reaches: kernel 4 at 24 x 640 frames,
    # past the L2, and at 2 x 2,176; kernel 2 masked at 24 rows x 640
    # steps); a wrapper's captured calls are its launches
    held = _hold_routes(routes, calls, launches)
    print("kernels at the corpus routes' inputs against their plain versions: "
          + "; ".join(f"{k} {v:.3e}" for k, v in held.items())
          + " (griffin_lim: consistency |diff|, bar 1e-3; gru and the frontend: max_abs_err, bar 1e-4, the "
          "frontend beside float64 near the dB floor)", flush=True)

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
        check(gru.scan_plan(xw.device, b, 512)[8] == 512, f"gru B={b}: wh no longer whole on chip")
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
        idx = ["-index_path", str(work / "idx.json")]
        pre = cli.main(["preprocess", "--corpus", str(corpus), "-dataset_path", ds, *idx, "--n-samples", "1000",
                        *common])
        arena = [*common, *idx, "--device-data"]  # the arena on the card (the loader: host_data_path)
        r1 = cli.main(["train1", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "4", *arena])
        state1 = r1.pop("state")
        r1b = cli.main(["train1", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "5", *arena])
        r1b.pop("state")
        r2 = cli.main(["train2", "-dataset_path", ds, "-ckpt_dir", ck, "--iters-override", "1",
                       "--targets", "V001", "V002", *arena])
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


def wide_h(dev) -> dict:
    """Kernels 2 and 3 past the H whose columns of wh fit a block's shared
    memory: kernel 2 in f32 at H = 2,048 and 4,096 and in bf16 at 2,304
    (B=16, T=64, forward and reverse masked), kernel 3 at H = 2,048 (B=16,
    T=32). Each keeps Hs < H rows on chip and reads the others each step
    from a copy in global memory (kernel 2: packed per call; kernel 3: wh
    itself); each call is one counted launch and holds against its plain
    version (hold_path_calls' bars; kernel 3: dxw 1e-4 max abs, dwh and dbh
    1e-4 rel-L2). Times (the unmasked scan) beside the plain version and the
    bound, and the bytes a step reads from that copy: each batch group's
    blocks read their share once per row block of a chunk."""
    import torch

    from zerospeech_tts_tpu_torch.ops import gru
    from zerospeech_tts_tpu_torch.tools.workload import cuda_ms

    def inputs(b, t, h, seed, dt):
        g = torch.Generator().manual_seed(seed)
        xw = torch.randn(b, t, 3 * h, generator=g).to(dev, dt)
        wh = (torch.randn(h, 3 * h, generator=g) / math.sqrt(h)).to(dev, dt)
        bh = (0.1 * torch.randn(3 * h, generator=g)).to(dev, dt)
        return xw, wh, bh, torch.randint(1, t + 1, (b,), generator=g, dtype=torch.int32).to(dev)

    rows = {}
    b, t = 16, 64
    for h, dt in ((2048, torch.float32), (4096, torch.float32), (2304, torch.bfloat16)):
        name, counter = ("gru", "launches") if dt == torch.float32 else ("gru_bf16", "bf16_launches")
        kc, n_k, nb, n_b, cb, smem, _, _, hs, pack = gru.scan_plan(dev, b, h, dt)
        check(0 < hs < h and pack > 0, f"{name} H={h}: plan Hs {hs}, packed {pack}: not the wide mode")
        xw, wh, bh, lens = inputs(b, t, h, h, dt)
        for ln, rev in ((None, False), (lens, True)):
            before = getattr(gru, counter)
            gru.gru_scan(xw, wh, bh, ln, reverse=rev)
            torch.cuda.synchronize()
            check(getattr(gru, counter) == before + 1, f"{name} H={h}: not one launch a scan")
        calls = {0: [[xw, wh, bh], {}, 1], 1: [[xw, wh, bh, lens], {"reverse": True}, 1]}
        err = hold_path_calls(name, calls, f"{name} wide H={h}")
        ms = cuda_ms(lambda: gru.gru_scan(xw, wh, bh), 5)
        plain_ms = cuda_ms(lambda: gru.gru_scan_plain(xw, wh, bh), 1)
        # the blocks of a batch group read their packed share once per row
        # block of a chunk (f32: 8 rows) or per m-tile of 16 rows (bf16)
        l2_step = pack * xw.element_size() * n_b * (-(-nb // cb) * -(-cb // 8) if dt == torch.float32
                                                     else -(-nb // 16))
        rows[f"{name} H={h}"] = dict(
            B=b, T=t, Hs=hs, spread=dict(kc=kc, NK=n_k, nb=nb, NB=n_b, cb=cb, smem=smem), max_abs_err=err,
            ms=ms, plain_ms=plain_ms, packed_bytes=pack * xw.element_size(), l2_bytes_a_step=l2_step,
            **bound(*work(name, (xw, wh, bh), {}), peak=PEAKS.get(name, PEAK_F32_FLOPS)))
        r = rows[f"{name} H={h}"]
        print(f"{name} wide H={h} B={b} T={t}: Hs {hs} of {h} rows on chip ({n_k} x {n_b} blocks of {kc} "
              f"columns), packed copy {r['packed_bytes'] / 1e6:.1f} MB, {l2_step / 1e6:.1f} MB read a step; "
              f"max_abs_err {err:.3e}; kernel {ms:.3f} ms ({1e3 * ms / t:.2f} us a step)  plain {plain_ms:.3f} ms  "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    h, t = 2048, 32
    kc, nb, cb, n_k, n_b, smem, hs = gru.bwd_plan(dev, b, h)
    check(0 < hs < h, f"gru_bwd H={h}: plan Hs {hs}: not the wide mode")
    xw, wh, bh, _ = inputs(b, t, h, 7, torch.float32)
    ys = gru.gru_scan(xw, wh, bh)
    dys = torch.randn(b, t, h, generator=torch.Generator().manual_seed(8)).to(dev)
    before = gru.bwd_launches
    out_k = gru.gru_bwd(xw, wh, bh, ys, dys)
    torch.cuda.synchronize()
    check(gru.bwd_launches == before + 1, "gru_bwd wide: not one launch")
    out_p = gru.gru_bwd_plain(xw, wh, bh, ys, dys)
    err = (out_k[0] - out_p[0]).abs().max().item()
    r_wh, r_bh = rel_l2(out_k[1], out_p[1]), rel_l2(out_k[2], out_p[2])
    check(err <= 1e-4 and r_wh <= 1e-4 and r_bh <= 1e-4, f"gru_bwd wide H={h}: dxw {err}, dwh {r_wh}, dbh {r_bh}")
    ms = cuda_ms(lambda: gru.gru_bwd(xw, wh, bh, ys, dys), 3)
    plain_ms = cuda_ms(lambda: gru.gru_bwd_plain(xw, wh, bh, ys, dys), 1)
    l2_step = n_b * -(-nb // cb) * -(-cb // 2) * (h - hs) * 3 * h * 4  # each chunk's row tiles re-read
    rows[f"gru_bwd H={h}"] = dict(
        B=b, T=t, Hs=hs, spread=dict(kc=kc, NK=n_k, nb=nb, NB=n_b, cb=cb, smem=smem), max_abs_err=err,
        dwh_rel_l2=r_wh, dbh_rel_l2=r_bh, ms=ms, plain_ms=plain_ms, l2_bytes_a_step=l2_step,
        **bound(*work("gru_bwd", (xw, wh, bh), {})))
    r = rows[f"gru_bwd H={h}"]
    print(f"gru_bwd wide H={h} B={b} T={t}: Hs {hs} of {h} rows on chip ({n_k} x {n_b} blocks of {kc} rows), "
          f"{l2_step / 1e6:.1f} MB of wh read a step; dxw max_abs_err {err:.3e}, dwh rel-L2 {r_wh:.3e}, dbh "
          f"{r_bh:.3e} (<= 1e-4); kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})", flush=True)
    return rows


def same_corpus(a: Path, b: Path) -> dict:
    """Check that corpus directory ``b`` (a merged sharded build) equals
    ``a`` (a single-process build): index equal, arenas within 1e-6 (each
    process runs kernel 1 on the same card), stats within 1e-10 (float64
    sums reassociated), b's speaker map a's in sorted-name order."""
    import numpy as np

    from zerospeech_tts_tpu_torch.data.corpus import FEATS

    sa = json.loads((a / "speakers.json").read_text())
    check(json.loads((b / "speakers.json").read_text()) == {s: i for i, s in enumerate(sorted(sa))},
          "merged speaker map is not the sorted one")
    arena_err = stats_err = 0.0
    for split in ("train", "test"):
        check((a / split / "index.json").read_text() == (b / split / "index.json").read_text(),
              f"merged {split} index differs")
        for feat in FEATS:
            arena_err = max(arena_err, float(np.abs(np.load(a / split / f"{feat}.npy")
                                                    - np.load(b / split / f"{feat}.npy")).max()))
    with np.load(a / "stats.npz") as za, np.load(b / "stats.npz") as zb:
        check(sorted(za.files) == sorted(zb.files), "merged stats have other keys")
        for k in za.files:
            stats_err = max(stats_err, float(np.abs(za[k].astype(np.float64) - zb[k]).max()))
    check(arena_err <= 1e-6 and stats_err <= 1e-10, f"merged corpus: arenas {arena_err}, stats {stats_err}")
    return dict(arena_max_abs_diff=arena_err, stats_max_abs_diff=stats_err)


def host_data_path(work: Path, device: str = "cuda", iters: int = 20) -> dict:
    """The JAX package's default training input at flagship width on the
    card: preprocess -index_path --workers 2, held against a single-process
    build; train1 from the SegmentLoader (4 iterations a phase) with
    --check-numerics --profile, whose trace must name kernels 2 and 3;
    train2 (one GAN cycle) from the loader, its launches counted from just
    before preprocess to just after train2 (the workers count their own
    kernel-1 launches); then steps/s of train1 from the loader and from the
    arena (--device-data) on the same ``iters``-iteration schedule."""
    import shutil

    import numpy as np
    import torch

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS, write_train_corpus

    shutil.rmtree(work, ignore_errors=True)
    corpus = write_train_corpus(work, seed=2)
    hps, _ = load_configs(DEFAULT_HPS_PATH)
    ds, idx, dev = str(work / "ds"), str(work / "idx.json"), ["--device", device]
    train = ["-dataset_path", ds, "-index_path", idx, *dev]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre = cli.main(["preprocess", "--corpus", str(corpus), "-dataset_path", ds, "-index_path", idx,
                    "--workers", "2", *dev])
    r1 = cli.main(["train1", *train, "-ckpt_dir", str(work / "ck"), "--iters-override", "4",
                   "--check-numerics", "--profile", str(work / "prof")])
    r1.pop("state")
    r2 = cli.main(["train2", *train, "-ckpt_dir", str(work / "ck"), "--iters-override", "1", "--targets", *TARGETS])
    r2.pop("state")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    launches["frontend"] += pre["worker_launches"]["frontend"]
    print(f"host data path wall {wall:.2f} s: preprocess --workers 2 {pre['seconds']:.2f} s "
          f"({pre['counts']} utterances, {pre['index_entries']} index entries); launches {launches} "
          f"(frontend: {pre['worker_launches']['frontend']} in the workers)", flush=True)
    check(pre["worker_launches"]["frontend"] > 0, "kernel frontend was not launched in the shard workers")
    for name in ("gru", "gru_bwd"):
        check(launches[name] > 0, f"kernel {name} was not launched training from the SegmentLoader")
    check(r1["step"] == 12 and r2["step"] == 12 + hps.n_critic + 1, f"loader training: steps {r1['step']}, "
          f"{r2['step']}")
    for k, v in {**r1["phases"], **r2["phases"]}.items():
        check(all(np.isfinite(x) for x in v["last"].values()), f"loader {k}: non-finite losses {v['last']}")
    trace = Path(r1["trace"])
    text = trace.read_text()
    named = {k: k in text for k in ("gru_scan_kernel", "gru_bwd_rec_kernel")}
    print(f"  train1 --profile trace {trace.name}: {trace.stat().st_size / 1e6:.1f} MB, names {named}", flush=True)
    check(all(named.values()), f"the profiler trace does not name kernels 2 and 3: {named}")

    one = cli.main(["preprocess", "--corpus", str(corpus), "-dataset_path", str(work / "one"),
                    "-index_path", str(work / "one.json"), *dev])
    held = same_corpus(work / "one", Path(ds))
    check((work / "one.json").read_text() == Path(idx).read_text(), "the merged corpus's segment index differs")
    print(f"  --workers 2 against one process ({one['seconds']:.2f} s): arenas {held['arena_max_abs_diff']:.3e} "
          f"(<= 1e-6), stats {held['stats_max_abs_diff']:.3e} (<= 1e-10), speaker map sorted, index equal",
          flush=True)

    rates = {}
    for route, extra in (("loader", []), ("device_data", ["--device-data"])):
        r = cli.main(["train1", *train, "-ckpt_dir", str(work / f"ck_{route}"), "--iters-override", str(iters),
                      *extra])
        rates[route] = {k: v["steps_per_s"] for k, v in r["phases"].items()}
        rates[route]["setup_s"] = r["setup_s"]
    print(f"  train1, {iters} iterations a phase, steps/s: " + "; ".join(
        f"{k} loader {rates['loader'][k]:.3f} / device-data {rates['device_data'][k]:.3f}"
        for k in ("pretrain_AE", "pretrain_C", "train")) + f"; set-up loader {rates['loader']['setup_s']:.2f} s / "
        f"device-data {rates['device_data']['setup_s']:.2f} s", flush=True)
    return dict(launches=launches, wall_s=wall, preprocess_workers_s=pre["seconds"], preprocess_one_s=one["seconds"],
                held=held, trace_bytes=trace.stat().st_size, phases={**r1["phases"], **r2["phases"]},
                steps_per_s=rates)


# one rank of a launched world: join the group on the device and over the
# backend named first (gloo for two ranks on one card), run the CLI on the
# other arguments with kernels 2 and 3's inputs kept (capture), then report
# this process's kernel launches on stderr; rank 0 also holds each kept
# input on the card against the plain version (hold_path_calls) and reports
# the largest differences
RANK_CLI = ("import json, os, sys\n"
            "import chip_smoke\n"
            "from zerospeech_tts_tpu_torch import cli, ops, parallel\n"
            "parallel.initialize(device=sys.argv[1], backend=sys.argv[2])\n"
            "calls = {}\n"
            "with chip_smoke.capture(('gru', 'gru_bwd'), calls):\n"
            "    cli.main(sys.argv[3:])\n"
            "print('LAUNCHES ' + json.dumps(ops.launch_counts()), file=sys.stderr)\n"
            "print('CAPTURED ' + json.dumps({k: sum(c for _, _, c in v.values()) for k, v in calls.items()}),\n"
            "      file=sys.stderr)\n"
            "if os.environ['RANK'] == '0' and sys.argv[1] == 'cuda':\n"
            "    held = {k: chip_smoke.hold_path_calls(k, v, 'rank 0') for k, v in calls.items() if v}\n"
            "    print('HELD ' + json.dumps(held), file=sys.stderr)\n")


def rank_report(outs, tag: str) -> dict:
    """What the ranks of a world reported on a RANK_CLI line (LAUNCHES,
    CAPTURED, HELD: rank 0's alone), summed over the ranks that did."""
    total: dict = {}
    for _, _, err in outs:
        for line in [x for x in err.splitlines() if x.startswith(tag + " ")][-1:]:
            for k, v in json.loads(line[len(tag) + 1:]).items():
                total[k] = total.get(k, 0) + v
    return total


def steps_per_s(text: str) -> dict:
    """{phase: steps/s} from the phase lines a training verb printed."""
    import re

    return {m.group(1): float(m.group(2)) for m in re.finditer(r"^ +(\w+): \d+ steps in [\d.]+s \(([\d.]+) steps/s\)",
                                                                 text, re.M)}


def dp_train(work: Path, host: Path, mesh: str, world: int, backend: str, local_ranks, iters: int, hps_path: Path,
             device: str = "cuda", routes=("loader", "device_data")) -> dict:
    """``train1 --mesh <mesh>`` (``world`` processes) over ``backend`` from
    the SegmentLoader and/or with --device-data (host_data_path's corpus and
    index), each from a fresh -ckpt_dir, through RANK_CLI: every rank exits
    0, rank 1 prints nothing, the directory holds rank 0's files alone
    (hps.json, the log, the final step), the log's losses are finite, the
    step loads into a fresh world-1 state, kernels 2 and 3 were launched as
    often as their wrappers were called, and rank 0 held every input they
    met against the plain versions. Returns each route's steps/s (rank 0's
    phase lines), the holds and the ranks' kernel launches, summed."""
    import numpy as np

    from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs
    from zerospeech_tts_tpu_torch.parallel import launch
    from zerospeech_tts_tpu_torch.train import CheckpointManager, init_state

    hps, _ = load_configs(DEFAULT_HPS_PATH)
    out = {}
    for route in routes:
        ck = work / f"ck_{backend}_{mesh.replace('=', '').replace(',', '_')}_{route}"
        t0 = time.perf_counter()
        outs = launch(["-c", RANK_CLI, device, backend, "train1", "-dataset_path", str(host / "ds"), "-index_path",
                       str(host / "idx.json"), "-ckpt_dir", str(ck), "--hps", str(hps_path), "--iters-override",
                       str(iters), "--mesh", mesh, "--device", device]
                      + (["--device-data"] if route == "device_data" else []), world,
                      local_ranks=local_ranks, timeout=600)
        wall = time.perf_counter() - t0
        for r, (rc, _, err) in enumerate(outs):
            check(rc == 0, f"train1 --mesh {mesh} ({backend}, {route}) rank {r} exited {rc}:\n{err[-3000:]}")
        check(all(o.strip() == "" for _, o, _ in outs[1:]), f"{route}: a rank above 0 printed")
        files = sorted(str(f.relative_to(ck)) for f in ck.rglob("*") if f.is_file()
                       and not f.name.startswith("events.out.tfevents"))
        check(files == ["hps.json", "logs/metrics.jsonl", f"step_{3 * iters}.pt"], f"{route}: files {files}")
        lines = [json.loads(x) for x in (ck / "logs" / "metrics.jsonl").read_text().splitlines()]
        check(len(lines) == 3 and len({(x["mode"], x["step"]) for x in lines}) == 3,
              f"{route}: {len(lines)} log lines (want one a phase, each once)")
        check(all(np.isfinite(v) for x in lines for k, v in x.items() if k not in ("mode", "step")),
              f"{route}: non-finite logged losses")
        st = CheckpointManager(ck, hps=hps, read_only=True).restore(init_state(hps, device=device))
        check(st.step == 3 * iters, f"{route}: rank 0's checkpoint restores step {st.step}")
        n, captured = rank_report(outs, "LAUNCHES"), rank_report(outs, "CAPTURED")
        held = rank_report(outs, "HELD") if device == "cuda" else {}
        check(device != "cuda" or (n["gru"] > 0 and n["gru_bwd"] > 0 and set(held) == {"gru", "gru_bwd"}
                                   and all(n[k] == captured[k] for k in held)),
              f"{route}: kernels 2 and 3 launched {n}, their wrappers called {captured}, held {held}")
        rates = steps_per_s(outs[0][1])
        check(set(rates) == {"pretrain_AE", "pretrain_C", "train"}, f"{route}: phase lines {rates}")
        out[route] = dict(steps_per_s=rates, wall_s=wall, launches=n, held=held, log_lines=len(lines))
        print(f"  train1 --mesh {mesh} over {backend} ({route}, {iters} iterations a phase, ranks on cards "
              f"{local_ranks or list(range(world))}): steps/s " + " ".join(f"{k} {v:.3f}" for k, v in rates.items())
              + f"; wall {wall:.1f} s; launches {n}; rank 0 held kernels 2 and 3 at every input they met: "
              + " ".join(f"{k} {v:.3e}" for k, v in held.items()), flush=True)
    return out


def print_parity(tag: str, report: dict) -> None:
    """One line a step of a dp_parity report beside its bars."""
    from zerospeech_tts_tpu_torch.tools import dp_parity

    for name, r in report.items():
        print(f"  dp_parity {tag} {name}: params rel-L2 "
              + " ".join(f"{n} {v:.2e}" for n, v in r["param_rel"].items()) + ", max |diff| "
              + " ".join(f"{n} {v:.2e}" for n, v in r["param_max_abs"].items()) + "; gradient rel-L2 "
              + " ".join(f"{n} {v:.2e}" for n, v in r["grad_rel_l2"].items()) + "; pre-clip norm rel "
              + " ".join(f"{n} {v:.2e}" for n, v in r["grad_norm_rel"].items())
              + f" (each <= {dp_parity.BAR}); metrics rel <= {max(r['metrics_rel'].values()):.2e} (1e-4); "
              f"ranks equal {r['ranks_equal']}", flush=True)


def tp_parity(case: dict, data: int, backend: str, local_ranks, device: str = "cuda") -> dict:
    """tools/dp_parity.py on a data x 2 mesh (tensor-parallel over model,
    the flagship's default min_size) against the single-process step, at
    dp_parity.failures' bars; on the card, each rank's resident state
    (torch.cuda.memory_allocated) once placed and after a step of each
    kind within 2% of the device0_bytes count of its blocks and below the
    world-1 count, as the allocator's blocks and as the bytes the tensors
    requested. The ranks' allocator splits blocks at 512 B
    (expandable_segments): the default one hands out a large block whole
    when less than 1 MB of it would be left, 3-6% above the requested
    bytes at these sizes."""
    import os

    from zerospeech_tts_tpu_torch.tools import dp_parity

    t0 = time.perf_counter()
    par = dp_parity.run(case, world=2 * data, model=2, device=device, backend=backend, local_ranks=local_ranks,
                        env=dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    wall = time.perf_counter() - t0
    tag = f"{backend} ({par['device']}, data={data},model=2)"
    print_parity(tag, par["report"])
    missed = dp_parity.failures(par["report"])
    check(not missed, f"dp_parity {tag}: " + "; ".join(missed))
    for r, m in enumerate(par["memory"] or []):
        print(f"  dp_parity {tag} rank {r} resident state, memory_allocated (requested bytes): placed "
              f"{m['placed']:,} ({m['placed_requested']:,}) B, after a step of each kind {m['placed_after_steps']:,} "
              f"({m['placed_after_steps_requested']:,}) B; device0_bytes count {m['count']:,} B (within 2%); world 1: "
              f"count {m['count_world1']:,} B, built {m['world1_built']:,} ({m['world1_built_requested']:,}) B, after "
              f"the steps {m['world1_after_steps']:,} ({m['world1_after_steps_requested']:,}) B (its gradients kept)",
              flush=True)
        for key in ("placed", "placed_after_steps", "placed_requested", "placed_after_steps_requested"):
            world1 = m["world1_built_requested" if key.endswith("requested") else "world1_built"]
            check(abs(m[key] - m["count"]) <= 0.02 * m["count"] and m[key] < world1 and m["count"] < m["count_world1"],
                  f"dp_parity {tag} rank {r}: {key} {m[key]} B against the count {m['count']} "
                  f"(world 1 {m['count_world1']})")
    return dict(par["report"], memory=par["memory"], wall_s=wall)


def multi_device_path(work: Path, host: Path, conv_out: Path, iters: int = 10, device: str = "cuda") -> dict:
    """Multi-device execution at flagship width on the card(s):
    (a) data-parallel training, two ranks on cuda:0 over gloo (and over
    NCCL on two cards where two are visible): tools/dp_parity.py (one step
    of each kind, from Adam moments that are not zero, against the
    single-process step on cuda:0, held to dp_parity.failures: every rank's
    updated parameters bit-equal; each updated module's parameters,
    gradient and pre-clip gradient norm within 1e-5 relative; the metrics
    within 1e-4); the same case with the planted fault (the gradient
    all_reduce without its division by the world size), where every step
    must miss a bar; then dp_train; steps/s beside the world-1 run of the
    same command (--mesh data=1, one process), a record and not a claim:
    two ranks share one card. (a') Tensor parallelism over model=2:
    tp_parity at data=1,model=2 (2 ranks) and data=2,model=2 (4 ranks) on
    cuda:0 over gloo (over NCCL on cards 0-1, and 0-3, where visible), the
    ranks of a model group holding the same whole leaves and blocks that
    gather to the single-process step's parameters, each rank's resident
    state against its count; the planted fault (gradient blocks swapped
    between the model ranks) must miss a bar in every step; dp_train with
    --mesh data=1,model=2 from the loader. (b) World 1 over NCCL: train1,
    one iteration a phase, through the data-parallel code path. (c) The
    conversion workload through Converter(devices=["cuda:0", "cuda:0"])
    against one device at GL-100: units bit for bit (or apart only within a
    1e-4 logit margin), PCM within 1 LSB, kernels 1, 2 and 4 held at the
    inputs this route gave them, launches counted, warm walls of both."""
    import shutil

    import numpy as np
    import torch

    from zerospeech_tts_tpu_torch import cli, ops
    from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs
    from zerospeech_tts_tpu_torch.convert import Converter
    from zerospeech_tts_tpu_torch.dsp.wavio import load_wav
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.params import from_flax
    from zerospeech_tts_tpu_torch.parallel import launch
    from zerospeech_tts_tpu_torch.tools import dp_parity
    from zerospeech_tts_tpu_torch.tools.workload import TARGETS

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    hps, _ = load_configs(DEFAULT_HPS_PATH)
    hps_path = work / "hps.json"  # the flagship's, logging once a phase
    hps_path.write_text(json.dumps(dict(json.loads(Path(DEFAULT_HPS_PATH).read_text()), log_interval=iters)))
    n_cards = torch.cuda.device_count() if device == "cuda" else 1
    worlds = [("gloo", [0, 0])] + ([("nccl", None)] if n_cards >= 2 else [])
    report: dict = {"dp_parity": {}, "train": {}, "tp_parity": {}}
    launches = {}
    case = dp_parity.make_case(hps, seed=0, device=device)
    for backend, local_ranks in worlds:
        t0 = time.perf_counter()
        par = dp_parity.run(case, world=2, device=device, backend=backend, local_ranks=local_ranks)
        wall = time.perf_counter() - t0
        print_parity(f"{backend} ({par['device']}, world 2)", par["report"])
        missed = dp_parity.failures(par["report"])
        check(not missed, f"dp_parity {backend}: " + "; ".join(missed))
        report["dp_parity"][backend] = dict(par["report"], wall_s=wall)
        if backend == "gloo":  # the planted fault must miss a bar in every step
            ctl = dp_parity.failures(dp_parity.run(case, world=2, device=device, backend=backend,
                                                   local_ranks=local_ranks, control=True)["report"])
            caught = {name for name in par["report"] if any(x.startswith(name + ": ") for x in ctl)}
            print(f"  dp_parity control (gradient all_reduce undivided by the world size): {len(ctl)} bars "
                  f"missed, steps caught {len(caught)} of {len(par['report'])}: " + "; ".join(ctl), flush=True)
            check(caught == set(par["report"]), f"dp_parity control: steps {set(par['report']) - caught} met "
                  "every bar with a gradient twice its size")
            report["dp_parity"]["control_missed"] = ctl
        report["train"][backend] = dp_train(work, host, "data=2", 2, backend, local_ranks, iters, hps_path, device)
        for route, v in report["train"][backend].items():
            launches[f"multi_device_dp_{backend}_{route}"] = v.pop("launches")
    one = {}
    for route, extra in (("loader", []), ("device_data", ["--device-data"])):
        r = cli.main(["train1", "-dataset_path", str(host / "ds"), "-index_path", str(host / "idx.json"),
                      "-ckpt_dir", str(work / f"ck_one_{route}"), "--hps", str(hps_path), "--iters-override",
                      str(iters), "--mesh", "data=1", "--device", device, *extra])
        r.pop("state")
        one[route] = {k: v["steps_per_s"] for k, v in r["phases"].items()}
    report["train"]["one_process"] = one
    print("  train1 steps/s, world 1 (one process) against world 2 on one card over gloo: " + "; ".join(
        f"{route} " + " ".join(f"{k} {one[route][k]:.3f} / {report['train']['gloo'][route]['steps_per_s'][k]:.3f}"
                               for k in one[route]) for route in one), flush=True)

    # (a') tensor parallelism over model=2: parity, resident state, the control, train1 through the CLI
    tp_worlds = [("gloo", 1, [0, 0]), ("gloo", 2, [0] * 4)] + [
        ("nccl", d, None) for d in (1, 2) if n_cards >= 2 * d]
    for backend, data, local_ranks in tp_worlds:
        report["tp_parity"][f"{backend}_data{data}"] = tp_parity(case, data, backend, local_ranks, device)
    ctl = dp_parity.failures(dp_parity.run(case, world=4, model=2, device=device, backend="gloo",
                                           local_ranks=[0] * 4, control=True)["report"])
    caught = {name for name, _, _ in dp_parity.STEPS if any(x.startswith(f"{name}: grad_rel_l2") for x in ctl)}
    print(f"  dp_parity control at data=2,model=2 (gradient blocks swapped between the model ranks): {len(ctl)} "
          f"bars missed, steps caught by the gradient bar {len(caught)} of {len(dp_parity.STEPS)}: "
          + "; ".join(ctl), flush=True)
    check(len(caught) == len(dp_parity.STEPS), f"dp_parity TP control: steps caught {caught}")
    report["tp_parity"]["control_missed"] = ctl
    report["train"]["tp_gloo"] = dp_train(work, host, "data=1,model=2", 2, "gloo", [0, 0], iters, hps_path, device,
                                          routes=("loader",))
    launches["multi_device_tp_gloo_loader"] = report["train"]["tp_gloo"]["loader"].pop("launches")
    print("  train1 steps/s, world 1 (one process) against data=1,model=2 on one card over gloo (loader): " + " ".join(
        f"{k} {one['loader'][k]:.3f} / {report['train']['tp_gloo']['loader']['steps_per_s'][k]:.3f}"
        for k in one["loader"]), flush=True)

    # (b) world 1 over NCCL through the data-parallel code path
    ck = work / "ck_nccl_1"
    outs = launch(["-c", RANK_CLI, device, "nccl" if device == "cuda" else "gloo", "train1", "-dataset_path",
                   str(host / "ds"), "-index_path", str(host / "idx.json"), "-ckpt_dir", str(ck), "--hps",
                   str(hps_path), "--iters-override", "1", "--device", device, "--device-data"],
                  1, timeout=600)
    rc, o, err = outs[0]
    check(rc == 0 and "stage-1 done at step 3" in o, f"train1 over NCCL at world 1 exited {rc}:\n{err[-3000:]}")
    launches["multi_device_nccl_1"] = rank_report(outs, "LAUNCHES")
    check(device != "cuda" or launches["multi_device_nccl_1"]["gru_bwd"] > 0, "NCCL world 1: kernel 3 not launched")
    print(f"  train1 over NCCL, world 1: step 3, launches {launches['multi_device_nccl_1']}", flush=True)

    # (c) conversion split over ["cuda:0", "cuda:0"]
    b = load_export(conv_out / "bundle")
    enc_sd, dec_sd = from_flax({"enc": b.enc, "dec": b.dec})
    wav_paths = sorted((conv_out / "wavs").glob("*.wav"))
    wavs = [load_wav(p, b.acfg.sr) for p in wav_paths]
    ids = [dict(b.speakers)[t] for t in TARGETS]
    splits = {"split": [f"{device}:0" if device == "cuda" else device] * 2}
    if device == "cuda" and torch.cuda.device_count() >= 2:  # and over every card where several are visible
        splits["cards"] = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    convs = {k: Converter(b.hps, b.acfg, enc_sd, dec_sd, stats=b.stats, feat=b.feat, device=device, devices=d)
             for k, d in (("one", None), *splits.items())}
    res, walls = {}, {k: [] for k in convs}
    for k in ("one", *[x for k in splits for x in (k, k)], "one"):  # warm, then timed in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[k] = convs[k].convert_wavs_multi(wavs, ids, tgt_names=list(TARGETS))
        torch.cuda.synchronize()
        walls[k].append(time.perf_counter() - t0)
    calls: dict = {}
    with capture(("frontend", "gru", "griffin_lim"), calls):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res["split"] = convs["split"].convert_wavs_multi(wavs, ids, tgt_names=list(TARGETS))
        torch.cuda.synchronize()
        walls["split"].append(time.perf_counter() - t0)
        launches["multi_device_convert"] = ops.launch_counts()
    for name in ("frontend", "gru", "griffin_lim"):
        n = sum(count for _, _, count in calls[name].values())
        check(n > 0 and n == launches["multi_device_convert"][name],
              f"split conversion: kernel {name} launched {launches['multi_device_convert'][name]}, {n} captured")
    held = {name: hold_path_calls(name, calls[name], "split conversion") for name in ("frontend", "gru", "griffin_lim")}
    (u1, w1), one = res["one"], convs["one"]
    for k, devs in splits.items():
        u2, w2 = res[k]
        flips = bits = 0
        worst_margin = 0.0
        for i, (a, c) in enumerate(zip(u1, u2)):
            check(a.shape == c.shape, f"{k} conversion utt {i}: units {c.shape} against {a.shape}")
            bits += a.size
            if (a != c).any():
                flips += int((a != c).sum())
                s_mean, s_std = one._src_stats(1, None)
                (_, _, arrays, to_dev), = one._pcm_chunks(one._trimmed([wavs[i]], True), s_mean, s_std)
                x, tl = to_dev(one.device, *arrays)
                with torch.inference_mode():
                    lg = one.encoder(x, lengths=tl)[0, : a.shape[0]].float().cpu().numpy()
                worst_margin = max(worst_margin, float(np.abs(lg[..., 0] - lg[..., 1])[a != c].max()))
        check(worst_margin < 1e-4, f"{k} conversion: units differ where the logit margin is {worst_margin}")
        lsb = max(int(np.abs(p.astype(np.int32) - q.astype(np.int32)).max())
                  for t1, t2 in zip(w1, w2) for p, q in zip(t1, t2))
        check(lsb <= 1, f"{k} conversion: PCM differs from one device's by {lsb} LSB")
        report[f"convert_{k}"] = dict(devices=devs, unit_flips=flips, unit_bits=bits, worst_flip_margin=worst_margin,
                                      pcm_max_lsb=lsb, walls_s=walls[k], walls_one_s=walls["one"],
                                      **({"held": held} if k == "split" else {}))
        print(f"  conversion over {devs} against one device ({len(wavs)} wavs x {len(TARGETS)} targets, "
              f"GL-{b.acfg.gl_iters}): {flips} of {bits} unit bits differ (margin < 1e-4), PCM within {lsb} LSB "
              f"(<= 1); warm walls one {walls['one'][1]:.4f} s, {k} " + ", ".join(f"{x:.4f}" for x in walls[k])
              + " s" + ("; held " + " ".join(f"{n} {v:.3e}" for n, v in held.items())
                        + f"; launches {launches['multi_device_convert']}" if k == "split" else ""), flush=True)
    report["launches"] = launches
    return report


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
