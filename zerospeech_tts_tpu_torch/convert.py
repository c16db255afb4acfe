"""Converter / discrete-unit dumper (port of ``zerospeech_tts_tpu/convert.py``;
ref convert.py --test / --test_single).

Per length bucket and batch chunk, straight from int16 PCM:
frontend (kernel) -> source z-norm -> encoder (GRU kernel) -> MBV bits ->
decoder for all targets folded into one batch (GRU kernel) -> target
denorm -> Griffin-Lim (kernel; from mel features after a pseudo-inverse
lift) -> de-emphasis -> PCM16. Units are written one latent frame per line
as space-separated 0/1 ints; wavs are 16 kHz PCM16 at
``<result>/<target_speaker>/<utt>.wav``.

Configurations, as the JAX Converter's: ``feat`` ``lin`` or ``mel`` (the
features the model was trained on); ``compute_dtype`` f32 (the
challenge-exact default) or bf16 for the decoder, and ``encoder_dtype``
(default: ``compute_dtype``) for the encoder, so ``--bf16 --enc-f32`` keeps
the exact encoder under a bf16 decoder. A bf16 module runs its
convolutions and dense layers in bf16 and its GRU through kernel 2's bf16
mode (f32 state); the frontend and Griffin-Lim stay f32 in every
configuration, and the decoder's output is f32 from the target denorm on.

Three sources: wavs (``convert_wavs_multi``, ``convert_wav_dir``), the
port's corpus directory of precomputed features (``convert_features_multi``,
``convert_corpus``; features cross to the device on the feature wire, bf16
unless ``wire="uint8"``, as the JAX package's), and units only, without
synthesis (``encode_units_from_wavs``, ``encode_units``, ``--units-only``;
always the f32 encoder, as the JAX package's units-only programs).
Buckets are uniform (``bucket_frames``) or fitted to the corpus lengths
(``fit_buckets``, ``plan_buckets``), and a ``frame_budget`` lets short
buckets take more rows a dispatch.

Several devices (``devices=[...]``, the JAX Converter's ``mesh`` over the
``data`` axis): the encoder and decoder are copied to each device, batch
rows are rounded up to a multiple of the device count, the bucket plan
stays the global one, and every dispatch's rows are split into one
contiguous slice a device, each launched on its device (frontend too)
before any is read back; results come back in row order, so every entry
point returns what the single-device Converter returns.

Two wires, as the JAX Converter's: ``pcm_wire="mulaw"`` (``--wire-mulaw``)
carries every PCM direction between host and device as 8-bit mu-law codes
(dsp/mulaw.py: wavs up, synthesised audio down; what the entry points
return and the files hold stays int16 PCM), and ``wire="uint8"``
(``--wire-uint8``) quantises each utterance's features to 256 levels over
its own [min, max] on the host and dequantises them on the device (the
features route; the wav routes have no feature wire).

Every dispatch slice, on every device, goes through one dispatcher
(``_Graphs``): the wire arrays cross through staging buffers (pinned on a
card) into the inputs it keeps for the dispatch shape, and the outputs go back into
host tensors of the dispatch's own. On CUDA devices a shape's device work
runs as the replay of a CUDA graph: the first dispatch of a shape runs
operator by operator, the second captures and replays, every later one
replays. ``check_numerics`` and the CPU run through the same dispatcher
without capture. ``graph_counts()`` counts the dispatches each way.
"""

from __future__ import annotations

import copy
import functools
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from zerospeech_tts_tpu_torch import ops
from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio
from zerospeech_tts_tpu_torch.dsp.mulaw import (
    mulaw_compress_device, mulaw_compress_host, mulaw_expand_device, mulaw_expand_host,
)
from zerospeech_tts_tpu_torch.dsp.wavio import load_wav, save_wav, trim_silence
from zerospeech_tts_tpu_torch.models import Decoder, Encoder, discretize, unit_bits
from zerospeech_tts_tpu_torch.tracing import span


def units_text(units: np.ndarray) -> str:
    """Challenge text format: one latent frame per line, bits
    space-separated (0/1 rows render as one vectorised byte interleave)."""
    u = np.asarray(units)
    if u.size == 0:
        return ""
    if u.ndim == 2 and u.dtype.kind in "iub" and ((u == 0) | (u == 1)).all():
        t, d = u.shape
        buf = np.empty((t, 2 * d), np.uint8)
        buf[:, 0::2] = u.astype(np.uint8) + ord("0")
        buf[:, 1::2] = ord(" ")
        buf[:, -1] = ord("\n")
        return buf.tobytes().decode("ascii")[:-1]
    return "\n".join(" ".join(str(int(v)) for v in row) for row in u)


def write_units(path: str | Path, units: np.ndarray) -> None:
    """Unit text file in the challenge format (see units_text)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(units_text(units) + "\n" if len(units) else "")


def read_units(path: str | Path) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int32, ndmin=2)


def _round_rows(k: int, cap: int) -> int:
    """Smallest allowed batch-row count >= k, capped: powers of two plus
    their 1.5x points (1,2,3,4,6,8,12,16,...). Dummy rows run the whole
    path (the vocoder does not mask), so the 3*2^i points bound the
    round-up waste at 1/3."""
    k = min(int(k), int(cap))
    bs = 1
    while bs < k:
        bs *= 2
    three = 3 * (bs // 4)
    if three >= k:
        bs = three
    return min(bs, int(cap))


def _chunk_rows(k: int, cap: int) -> tuple[int, int]:
    """(executed batch rows, dispatch count) for ``k`` utterances chunked
    under a bucket cap: full chunks of ``cap`` rows plus one _round_rows
    tail chunk (Converter._chunk_batch's shapes)."""
    full, rem = divmod(int(k), int(cap))
    rows = full * cap
    n_disp = full
    if rem:
        rows += _round_rows(rem, cap)
        n_disp += 1
    return rows, n_disp


def plan_buckets(
    frame_lengths,
    max_buckets: int,
    quantum: int,
    min_pad: int = 4,
    target_overhead: float | None = None,
    cap_fn=None,
    dispatch_cost: float = 0.0,
) -> list[int]:
    """Pick <= max_buckets bucket edges (multiples of ``quantum``) that
    minimize total padded frames for the given utterance length multiset
    (copy of the JAX package's planner).

    ``min_pad``: an utterance sits at its edge exactly or has >= min_pad
    pad frames (Converter._MIN_PAD), so the executed plan never falls back
    to an out-of-plan uniform bucket.

    ``target_overhead``: return the SMALLEST number of edges whose planned
    padding overhead (padded/true - 1) is <= target, or the best plan
    within ``max_buckets`` when no k meets it.

    ``cap_fn`` (bucket frames -> batch-row cap) switches the objective from
    padded frames to EXECUTED rows*frames: dummy rows run the whole path
    (the vocoder does not mask), so each candidate bucket is charged its
    chunked cost (full cap-row chunks + one rounded tail) plus
    ``dispatch_cost`` frame-rows a dispatch; more edges can then hurt and
    every k is searched.

    Exact DP (1-D clustering) over the distinct quantized lengths:
    dp[j][k] = least cost covering groups 1..j with k edges, edge k at
    group j's value. O(m^2 * max_buckets) for m distinct lengths.
    """
    if int(max_buckets) < 1:
        raise ValueError(f"adaptive bucket count must be >= 1, got {max_buckets}")
    ts = np.asarray(frame_lengths, np.int64)
    if ts.size == 0:
        return []
    q = int(quantum)
    quant = -(-ts // q) * q  # ceil to quantum
    while True:  # bump 1..min_pad-1 pads up a quantum (loops only if q < min_pad)
        short = (quant > ts) & (quant - ts < int(min_pad))
        if not short.any():
            break
        quant = np.where(short, quant + q, quant)
    vals, inv = np.unique(quant, return_inverse=True)
    m = len(vals)
    cnt = np.bincount(inv, minlength=m).astype(np.int64)
    tsum = np.bincount(inv, weights=ts.astype(np.float64), minlength=m)
    ccum = np.concatenate([[0], np.cumsum(cnt)])
    scum = np.concatenate([[0.0], np.cumsum(tsum)])
    k_max = min(int(max_buckets), m)
    INF = float("inf")
    dp = np.full((m + 1, k_max + 1), INF)
    prev = np.zeros((m + 1, k_max + 1), np.int64)
    dp[0, 0] = 0.0
    caps = None
    if cap_fn is not None:
        caps = [max(1, int(cap_fn(int(v)))) for v in vals]
    for k in range(1, k_max + 1):
        for j in range(1, m + 1):
            # groups i+1..j all pad to vals[j-1]
            best, arg = INF, 0
            for i in range(k - 1, j):
                if dp[i, k - 1] == INF:
                    continue
                count = ccum[j] - ccum[i]
                if caps is None:
                    seg = vals[j - 1] * count - (scum[j] - scum[i])
                else:
                    rows, n_disp = _chunk_rows(count, caps[j - 1])
                    seg = (rows * vals[j - 1] - (scum[j] - scum[i])
                           + dispatch_cost * n_disp)
                c = dp[i, k - 1] + seg
                if c < best:
                    best, arg = c, i
            dp[j, k] = best
            prev[j, k] = arg
    if target_overhead is not None:
        total_true = float(scum[m])
        k_best = 0
        for k in range(1, k_max + 1):
            if dp[m, k] <= target_overhead * total_true:
                k_best = k
                break
        if not k_best:  # target unreachable within max_buckets: best effort
            k_best = int(np.argmin(dp[m, 1:])) + 1
    else:
        # frames mode: fewer edges never help; executed mode: they can
        k_best = int(np.argmin(dp[m, 1:])) + 1
    edges, j = [], m
    for k in range(k_best, 0, -1):
        edges.append(int(vals[j - 1]))
        j = int(prev[j, k])
    return sorted(edges)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype) and d in _DTYPES.values():
        return d
    if d in _DTYPES:
        return _DTYPES[d]
    raise ValueError(f"compute dtype must be float32 or bfloat16, got {d!r}")


def uint8_wire(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A padded f32 feature batch [B, T, F] -> (uint8 codes, lo [B], scale
    [B]): each row over its own [min, max], zero padding included, scale =
    max(hi - lo, 1e-6) / 255, codes rint'd and clipped to 0..255 (the JAX
    Converter's ``_wire_batch``, in the same order of in-place passes).
    The device reads x = q * scale + lo."""
    lo = x.min(axis=(1, 2)).astype(np.float32)
    hi = x.max(axis=(1, 2)).astype(np.float32)
    scale = np.maximum(hi - lo, 1e-6) / 255.0
    q = x - lo[:, None, None]
    np.multiply(q, (1.0 / scale)[:, None, None], out=q)
    np.rint(q, out=q)
    np.clip(q, 0.0, 255.0, out=q)
    return q.astype(np.uint8), lo, scale


class _PcmWire(NamedTuple):
    """Everything the PCM wire decides, both directions: a silent host
    batch of its codes (``batch(rows, samples)``), int16 PCM to codes on
    the host, codes to float samples on the device, float samples to codes
    on the device, and codes to int16 PCM on the host."""

    batch: Callable
    host_encode: Callable
    device_decode: Callable
    device_encode: Callable
    host_decode: Callable


_PCM_WIRES = {
    "int16": _PcmWire(
        lambda rows, n: np.zeros((rows, n), np.int16),
        lambda pcm: pcm,
        lambda pcm: pcm.to(torch.float32) * (1.0 / 32768.0),  # load_wav convention
        lambda wav: torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16),
        lambda pcm: pcm,
    ),
    # 8-bit companded codes; silence is code 128 (code 0 would be full scale negative)
    "mulaw": _PcmWire(  # each codec looked up when called: tests count its calls
        lambda rows, n: np.full((rows, n), 128, np.uint8),
        lambda pcm: mulaw_compress_host(pcm),
        lambda pcm: mulaw_expand_device(pcm),
        lambda wav: mulaw_compress_device(torch.clamp(wav, -1.0, 1.0)),
        lambda pcm: mulaw_expand_host(pcm),
    ),
}


def _uint8_encode(x, tl):
    q, lo, scale = uint8_wire(x)
    return q, tl, lo, scale


def _uint8_decode(dtype, q, tl, lo, scale):
    lo, scale = (a.to(dtype)[:, None, None] for a in (lo, scale))
    return q.to(dtype) * scale + lo, tl


class _FeatureWire(NamedTuple):
    """Everything the feature wire decides, host to device: a padded f32
    batch [B, T, F] and its true frame counts to the arrays that cross, and
    those arrays on the device to (features, true frame counts), the uint8
    codes dequantised in the ``dtype`` it is given (bf16 features are read
    back in f32)."""

    host_encode: Callable
    device_decode: Callable


_FEATURE_WIRES = {
    "bf16": _FeatureWire(lambda x, tl: (torch.from_numpy(x).to(torch.bfloat16), tl),
                         lambda dtype, x, tl: (x.to(torch.float32), tl)),
    "uint8": _FeatureWire(_uint8_encode, _uint8_decode),
}


# dispatch slices by how they ran: operator by operator ("eager": every
# slice of a dispatcher that does not capture, and a shape's first on one
# that does), graphs captured, and graph replays
_graph_runs = {"eager": 0, "captured": 0, "replayed": 0}


def graph_counts() -> dict[str, int]:
    """How many dispatch slices ran eagerly, how many graphs were captured
    and how many replays ran."""
    return dict(_graph_runs)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, copied in stream order through pinned
    memory on a card (a copy from pageable memory waits for everything
    queued before it)."""
    t = torch.from_numpy(a)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)


def _recorded(device: torch.device):
    """An event recorded on ``device``'s current stream (None off the card)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class _Staging:
    """A ring of pinned host buffers the wire arrays of a dispatch cross
    from: a slot is written again only once the event recorded after its
    copies to the device shows they have finished."""

    _ALIGN = 64

    def __init__(self, slots: int = 8):
        self._slots = [[torch.empty(0, dtype=torch.uint8), None] for _ in range(slots)]  # bytes, event
        self._next = 0

    def put(self, device: torch.device, arrays: list[torch.Tensor]):
        """Host copies of ``arrays`` in the next slot, and the slot, whose
        event (``slot[1]``) the caller records after the copies it issues."""
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot[1] is not None:
            slot[1].synchronize()
            slot[1] = None
        sizes = [-(-a.numel() * a.element_size() // self._ALIGN) * self._ALIGN for a in arrays]
        if slot[0].numel() < sum(sizes):
            slot[0] = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=device.type == "cuda")
        views, off = [], 0
        for a, size in zip(arrays, sizes):
            v = slot[0][off : off + a.numel() * a.element_size()].view(a.dtype).view(a.shape)
            v.copy_(a)
            views.append(v)
            off += size
        return views, slot


class _Pending:
    """A dispatch slice's outputs on their way to host tensors of its own."""

    def __init__(self, hosts: list[torch.Tensor], event):
        self.hosts, self.event = hosts, event

    def numpy(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.hosts]


class _Graph:
    """One dispatch shape: its static inputs and outputs, its CUDA graph
    (or, off the card, the function run in place of a replay), and the
    kernel launches a replay runs."""

    def __init__(self, ins: list[torch.Tensor]):
        self.ins = ins
        self.outs: tuple = ()
        self.graph = None
        self.launches: dict[str, int] = {}


class _Graphs:
    """The Converter's one dispatcher: every dispatch slice, one entry a
    dispatch shape (``key``: the route, the wires, the device, every
    input's shape and dtype, the Griffin-Lim iterations and the matmul
    precision flags).

    :meth:`run` fills the shape's static inputs (the wire arrays by
    non-blocking copies from a :class:`_Staging` slot, the call's speaker
    ids and target statistics by device copies); runs ``fn`` on them
    eagerly the first time (the warm-up a capture needs: cuDNN's plans,
    the kernels' tables and builds, the GRU plans); where it may
    ``capture``, captures it into a CUDA graph and replays it the second
    time and replays it every later time, else runs it eagerly every time;
    then copies the outputs into host tensors of the dispatch's own on the
    same stream. The next replay of a shape overwrites its static outputs,
    and every dispatch of a call is launched before any is read back, so
    the outputs leave them at once. The graphs of a device share one memory
    pool: they replay one at a time on its current stream.

    A capture records the kernel launches it made (``ops.launch_counts``)
    and takes them back, since nothing ran; each replay adds them. Off the
    card (the CPU tests, with ``capture`` set) the same bookkeeping runs
    ``fn`` in place of a replay and writes its outputs into the static
    ones."""

    def __init__(self, capture: bool):
        self.capture = capture
        self.entries: dict[tuple, _Graph] = {}
        self.staging = _Staging()
        self._pools: dict[torch.device, tuple] = {}
        self._streams: dict[torch.device, torch.cuda.Stream] = {}

    def run(self, key: tuple, dev: torch.device, host: list[torch.Tensor], shared: list[torch.Tensor], fn):
        e = self.entries.get(key)
        first = e is None
        if first:
            e = _Graph([torch.empty(t.shape, dtype=t.dtype, device=dev) for t in [*host, *shared]])
        card = dev.type == "cuda"
        views, slot = self.staging.put(dev, host)
        for dst, src in zip(e.ins, views + list(shared)):
            dst.copy_(src, non_blocking=card)
        slot[1] = _recorded(dev)
        if first or not self.capture:
            outs = fn(*e.ins)
            self.entries[key] = e  # kept once its warm-up ran
            _graph_runs["eager"] += 1
        else:
            if e.graph is None:
                self._capture(e, dev, fn)
            self._replay(e, card)
            outs = e.outs
        hosts = [torch.empty(o.shape, dtype=o.dtype, pin_memory=card) for o in outs]
        for h, o in zip(hosts, outs):
            h.copy_(o, non_blocking=card)
        return _Pending(hosts, _recorded(dev))

    def _capture(self, e: _Graph, dev: torch.device, fn) -> None:
        with span("convert.capture"):
            if dev.type != "cuda":
                e.outs, e.graph = fn(*e.ins), fn
            else:
                before = ops.launch_counts()
                e.graph = torch.cuda.CUDAGraph()
                if dev not in self._pools:
                    self._pools[dev] = torch.cuda.graph_pool_handle()
                    self._streams[dev] = torch.cuda.Stream(dev)
                stream = self._streams[dev]
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    e.graph.capture_begin(pool=self._pools[dev], capture_error_mode="thread_local")
                    try:
                        e.outs = fn(*e.ins)
                    except BaseException:
                        try:
                            e.graph.capture_end()
                        except RuntimeError:
                            pass  # the capture is void; the function's own error is the one to raise
                        e.graph = None
                        raise
                    e.graph.capture_end()
                torch.cuda.current_stream(dev).wait_stream(stream)
                e.launches = {k: v - before[k] for k, v in ops.launch_counts().items() if v != before[k]}
                ops.add_launches(e.launches, -1)
        _graph_runs["captured"] += 1

    @staticmethod
    def _replay(e: _Graph, card: bool) -> None:
        if card:
            e.graph.replay()
            ops.add_launches(e.launches)
        else:
            for o, r in zip(e.outs, e.graph(*e.ins)):
                o.copy_(r)
        _graph_runs["replayed"] += 1


class Converter:
    """Encoder + decoder on ``device``, converting PCM or feature batches
    per padded length bucket. ``enc_state``/``dec_state`` are the port's
    state dicts (``params.from_flax``). On ``device="cuda"`` (the default)
    it runs the hand-written kernels and never falls back to the CPU;
    ``device="cpu"`` runs their plain versions. ``feat``, ``compute_dtype``
    and ``encoder_dtype`` as in the JAX Converter (module docstring).

    ``frame_budget`` (rows*frames a dispatch): short buckets take more
    utterances a dispatch (_bucket_cap: the largest allowed row count
    within the budget, never below batch_size, at most 128 rows). None
    keeps the flat batch_size cap.

    ``check_numerics``: raise FloatingPointError at the first non-finite
    encoder logit of a true frame (one wait for the device a dispatch).

    Every dispatch runs through the one dispatcher (``_Graphs``, module
    docstring). It captures CUDA graphs where every device is CUDA and
    ``check_numerics`` is off; otherwise it runs each dispatch eagerly.

    ``wire`` (features, host to device): ``"bf16"`` or ``"uint8"`` (per
    utterance min/max codes, dequantised on the device in the compute
    dtype, in f32 for units only). ``pcm_wire`` (PCM, both directions):
    ``"int16"`` or ``"mulaw"`` (8-bit codes; the entry points still return
    int16). Either names the JAX Converter's option of the same name.

    ``devices``: local devices to split each dispatch's rows over (module
    docstring); None means ``[device]``. A device may repeat (the split on
    one card, or on the CPU); the model is copied to each distinct device
    here, so later edits of ``encoder``/``decoder`` (``devices[0]``'s)
    reach that device only."""

    def __init__(
        self,
        hps: Hps,
        acfg: AudioConfig,
        enc_state: dict,
        dec_state: dict,
        gl_iters: int | None = None,
        batch_size: int = 8,
        bucket_frames: int = 64,
        frame_budget: int | None = None,
        stats=None,  # SpeakerStats when hps.speaker_norm (z-norm in/out)
        device: str | torch.device = "cuda",
        feat: str = "lin",  # which features the model was trained on (lin|mel)
        compute_dtype="float32",  # the decoder's dtype: float32 | bfloat16
        encoder_dtype=None,  # the encoder's: None -> compute_dtype
        check_numerics: bool = False,
        devices=None,  # split every dispatch's rows over these devices
        wire: str = "bf16",  # features, host to device: bf16 | uint8
        pcm_wire: str = "int16",  # PCM, both directions: int16 | mulaw
    ):
        if feat not in ("lin", "mel"):
            raise ValueError(f"feat must be lin or mel, got {feat!r}")
        if wire not in _FEATURE_WIRES:
            raise ValueError(f"wire must be bf16 or uint8, got {wire!r}")
        if pcm_wire not in _PCM_WIRES:
            raise ValueError(f"pcm_wire must be int16 or mulaw, got {pcm_wire!r}")
        assert bucket_frames % hps.downsample == 0
        self.feat, self.wire, self.pcm_wire = feat, wire, pcm_wire
        self._features, self._pcm = _FEATURE_WIRES[wire], _PCM_WIRES[pcm_wire]
        self.compute_dtype = _as_dtype(compute_dtype)
        self.encoder_dtype = _as_dtype(encoder_dtype) if encoder_dtype else self.compute_dtype
        self.devices = [torch.device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if any(d.type == "cuda" for d in self.devices) and not torch.cuda.is_available():
            raise RuntimeError(f"devices {self.devices}: no CUDA device is visible")
        self.hps, self.acfg, self.stats = hps, acfg, stats
        self.check_numerics = check_numerics
        # a capture cannot hold check_numerics' read of the logits on the host
        self._graphs = _Graphs(capture=not check_numerics and all(d.type == "cuda" for d in self.devices))
        self.gl_iters = gl_iters if gl_iters is not None else acfg.gl_iters
        n_dev = len(self.devices)
        self.batch_size = -(-batch_size // n_dev) * n_dev  # whole rows on every device
        self.bucket_frames = bucket_frames
        self.frame_budget = frame_budget
        self.bucket_edges: list[int] | None = None  # set by fit_buckets()
        self.encoder = Encoder(hps)
        self.decoder = Decoder(hps)
        self.encoder.load_state_dict(enc_state)
        self.decoder.load_state_dict(dec_state)
        self.encoder.to(self.device).eval().requires_grad_(False)  # f32: units-only
        self.decoder.to(self.device, self.compute_dtype).eval().requires_grad_(False)
        # the conversion's encoder: the f32 one, or a copy cast to encoder_dtype
        self.conv_encoder = (self.encoder if self.encoder_dtype == torch.float32
                             else copy.deepcopy(self.encoder).to(self.encoder_dtype))
        # device -> (encoder, conversion encoder, decoder) on it
        self._models = {self.device: (self.encoder, self.conv_encoder, self.decoder)}
        for d in self.devices[1:]:
            if d not in self._models:
                enc = copy.deepcopy(self.encoder).to(d)
                conv_enc = enc if self.conv_encoder is self.encoder else copy.deepcopy(self.conv_encoder).to(d)
                self._models[d] = (enc, conv_enc, copy.deepcopy(self.decoder).to(d))

    # ------------------------------------------------------------- buckets

    # Minimum nonzero bucket padding, in input frames. The encoder's widest
    # conv (bank kernel 8) reads 4 rows past the true boundary; with >= 4
    # pad rows those reads land in the mirror-filled region, which makes
    # padded encoding equal exact-length encoding (models/encoder.py).
    _MIN_PAD = 4

    def _bucket_of(self, t: int) -> int:
        """Padded frame count for a true frame count ``t``: the smallest
        fitted edge >= t when fit_buckets() ran, else ceil to
        bucket_frames; an edge leaving 1..3 pad frames is passed over (a
        uniform bucket is bumped one up), so padding is 0 or >= _MIN_PAD."""
        if self.bucket_edges:
            edges = self.bucket_edges
            j = int(np.searchsorted(np.asarray(edges), t))
            while j < len(edges):
                if edges[j] == t or edges[j] - t >= self._MIN_PAD:
                    return edges[j]
                j += 1
            # longer than anything fitted: fall back to uniform quantization
        tb = -(-t // self.bucket_frames) * self.bucket_frames
        if 0 < tb - t < self._MIN_PAD:
            tb += self.bucket_frames
        return tb

    def fit_buckets(
        self, frame_lengths, max_buckets: int, target_overhead: float | None = None,
        cost_model: str = "frames", dispatch_cost_frames: float = 0.0,
    ) -> list[int]:
        """Fit at most ``max_buckets`` edges (multiples of bucket_frames) to
        the utterances' true frame counts (plan_buckets). ``cost_model``:
        ``"frames"`` minimizes padded frames; ``"executed"`` the rows*frames
        the dispatches run under this Converter's chunking (tail rounding,
        frame-budget caps) plus ``dispatch_cost_frames`` frame-rows a
        dispatch."""
        if cost_model not in ("frames", "executed"):
            raise ValueError(f"cost_model must be frames|executed, got {cost_model!r}")
        self.bucket_edges = plan_buckets(
            frame_lengths, max_buckets, self.bucket_frames,
            min_pad=self._MIN_PAD, target_overhead=target_overhead,
            cap_fn=self._bucket_cap if cost_model == "executed" else None,
            dispatch_cost=dispatch_cost_frames,
        )
        return self.bucket_edges

    def _bucket_cap(self, tb: int) -> int:
        """Batch cap for a bucket of ``tb`` frames: batch_size, or with a
        frame_budget the largest allowed row count (_round_rows' set) whose
        rows*frames stays within it (never below batch_size, <= 128)."""
        if not self.frame_budget:
            return self.batch_size
        cap = 1
        for s in (2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128):
            if s * tb <= self.frame_budget:
                cap = s
        return max(cap, self.batch_size)

    def _chunk_batch(self, k: int, cap: int | None = None) -> int:
        """Batch rows for a chunk of ``k`` utterances: the smallest allowed
        row count >= k (_round_rows), capped at the bucket's cap, rounded up
        to a multiple of the device count."""
        n_dev = len(self.devices)
        return -(-_round_rows(k, cap or self.batch_size) // n_dev) * n_dev

    def _dispatches(self, frames: list[int], sizes: list[int]):
        """(bucket frames, utterance indices, batch rows) of each dispatch:
        utterances longest ``sizes`` first (stable), grouped by bucket and
        chunked by the bucket's cap."""
        buckets: dict[int, list[int]] = {}
        for i in np.argsort([-s for s in sizes], kind="stable"):
            buckets.setdefault(self._bucket_of(int(frames[i])), []).append(int(i))
        for tb, idxs in buckets.items():
            cap = self._bucket_cap(tb)
            for c0 in range(0, len(idxs), cap):
                chunk = idxs[c0 : c0 + cap]
                yield tb, chunk, self._chunk_batch(len(chunk), cap)

    # ---------------------------------------------------------------- core

    def _convert_core(self, dev, x, tlens, spk, tgt_mean, tgt_std):
        """Normalised features x [B, T, F] on ``dev`` (one of the devices)
        -> (units [B, T/ds, emb] int32, PCM [n_tgt, B, (T-1)*hop]: int16, or
        uint8 mu-law codes on the mu-law wire) there. ``tlens`` ([B] true
        frame counts) drives the length-masked encoder/decoder so bucket
        padding never changes the true frames' units or audio; ``spk``
        [n_tgt, B] are the targets' ids, ``tgt_mean``/``tgt_std`` [n_tgt,
        F] their denorm statistics."""
        hps, acfg = self.hps, self.acfg
        _, conv_encoder, decoder = self._models[dev]
        zlens = (tlens + hps.downsample - 1) // hps.downsample
        logits = conv_encoder(x, lengths=tlens).float()
        self._check_logits(logits, tlens)
        units = unit_bits(logits, hps.enc_mode)
        z = (
            discretize(logits, hps.enc_mode, hps.gumbel_temp, None)
            if hps.enc_mode == "continues"
            else units.to(torch.float32)
        )  # the decoder casts it to its dtype
        # Cross-target batched decode: fold the target axis into the batch
        # (batch-major, targets minor) so the decoder and its frame-rate GRU
        # run once at B * n_tgt rows, and the vocoder once over all of them.
        n_tgt, bsz = spk.shape
        z_all = z[:, None].expand(bsz, n_tgt, *z.shape[1:]).reshape(bsz * n_tgt, *z.shape[1:])
        spk_flat = spk.T.reshape(-1)
        xh = decoder(z_all, spk_flat, lengths=zlens[:, None].expand(bsz, n_tgt).reshape(-1)).float()
        mean_all = tgt_mean[None].expand(bsz, -1, -1).reshape(bsz * n_tgt, 1, -1)
        std_all = tgt_std[None].expand(bsz, -1, -1).reshape(bsz * n_tgt, 1, -1)
        xh = torch.clamp(xh * std_all + mean_all, 0.0, 1.0)
        vocoder = dsp_audio.spectrogram2wav if self.feat == "lin" else dsp_audio.melspectrogram2wav
        wav = vocoder(xh, acfg, n_iters=self.gl_iters)  # [B*n_tgt, n]
        pcm = self._pcm.device_encode(wav)
        return units, pcm.reshape(bsz, n_tgt, -1).transpose(0, 1)

    def _units_core(self, dev, x, tlens):
        """Normalised features [B, T, F] on ``dev`` -> (units [B, T/ds, emb]
        int32,), from the f32 encoder in every configuration (the JAX
        package's units-only programs run the uncast parameters)."""
        logits = self._models[dev][0](x, lengths=tlens)
        self._check_logits(logits, tlens)
        return (unit_bits(logits, self.hps.enc_mode),)

    def _check_logits(self, logits, tlens) -> None:
        """With check_numerics: raise at a non-finite logit of a true
        latent frame (frames past ceil(tlens / downsample) are bucket
        padding)."""
        if not self.check_numerics:
            return
        zlens = (tlens.to(logits.device) + self.hps.downsample - 1) // self.hps.downsample
        true = torch.arange(logits.shape[1], device=logits.device)[None, :] < zlens[:, None]
        bad = ~torch.isfinite(logits).reshape(*logits.shape[:2], -1).all(dim=-1) & true
        if bool(bad.any()):
            rows = sorted({int(r) for r in bad.nonzero()[:, 0].tolist()})
            raise FloatingPointError(f"--check-numerics: conversion: non-finite encoder logits in batch "
                                     f"rows {rows} of a [{logits.shape[0]}, {logits.shape[1]}] dispatch")

    def _wav_features(self, pcm, src_mean, src_std, slens):
        """Wire PCM [B, n_samp] (int16, or mu-law codes) -> frontend ->
        source z-norm: (features [B, T, F], true frame counts [B]).
        ``slens`` ([B] true sample counts) gives exact tail reflection in
        the frontend."""
        y = self._pcm.device_decode(pcm)
        mel, mag = dsp_audio.wav_to_features(y, self.acfg, length=slens)
        x = ((mag if self.feat == "lin" else mel) - src_mean[:, None, :]) / src_std[:, None, :]
        return x, 1 + slens // self.acfg.hop_length

    def _speaker_stats(self, n: int, names):
        """[n, F] mean/std of ``n`` speakers: the named speakers' statistics
        ('__global__' when not named), or identity without stats."""
        if self.stats is None:
            return (np.zeros((n, self.hps.n_feat), np.float32),
                    np.ones((n, self.hps.n_feat), np.float32))
        return self.stats.arrays_for(names or ["__global__"] * n)

    def _pcm_chunks(self, wavs, frames, s_mean, s_std):
        """Per dispatch of the trimmed float ``wavs`` (``frames`` true
        frames each): (utterance indices, batch rows, host arrays [rows,
        ...] as they cross the PCM wire, the function that takes rows of
        them on a device to features [rows, tb, F] and true frame counts
        there). Dummy rows are silent and act full-length."""
        acfg, hps = self.acfg, self.hps
        for tb, chunk, bs_c in self._dispatches(frames, [len(w) for w in wavs]):
            with span("convert.pack"):  # closed before the yield: the launch is not packing
                n_samp = tb * acfg.hop_length - 1  # longest signal with tb frames
                pcm = self._pcm.batch(bs_c, n_samp)
                sm = np.zeros((bs_c, hps.n_feat), np.float32)
                ss = np.ones((bs_c, hps.n_feat), np.float32)
                sl = np.full(bs_c, n_samp, np.int64)
                for j, i in enumerate(chunk):
                    w = np.clip(np.rint(wavs[i] * 32768.0), -32768, 32767).astype(np.int16)
                    pcm[j, : len(w)] = self._pcm.host_encode(w)
                    sm[j], ss[j] = s_mean[i], s_std[i]
                    sl[j] = len(w)
            yield chunk, bs_c, (pcm, sm, ss, sl), self._wav_features

    def _feature_chunks(self, feats_list, frames, dtype):
        """Per dispatch of normalised [T_i, F] features: as _pcm_chunks,
        the features crossing on the feature wire (uint8: dequantised in
        ``dtype``); dummy rows are zeros at full length."""
        to_features = functools.partial(self._features.device_decode, dtype)
        for tb, chunk, bs_c in self._dispatches(frames, frames):
            with span("convert.pack"):
                x = np.zeros((bs_c, tb, self.hps.n_feat), np.float32)
                tl = np.full(bs_c, tb, np.int64)
                for j, i in enumerate(chunk):
                    x[j, : frames[i]] = feats_list[i]
                    tl[j] = frames[i]
                arrays = self._features.host_encode(x, tl)
            yield chunk, bs_c, arrays, to_features

    def _wav_source(self, wavs, src_speakers, trim: bool):
        """The wav entries' prologue: (true frame counts, _pcm_chunks) of
        the wavs, trimmed unless ``trim`` is off, z-scored with their
        speakers' statistics."""
        with span("convert.trim"):
            wavs = [np.asarray(w, np.float32) for w in wavs]
            wavs = [trim_silence(w, self.acfg.top_db) for w in wavs] if trim else wavs
        s_mean, s_std = self._speaker_stats(len(wavs), src_speakers)
        frames = [dsp_audio.n_frames_for(len(w), self.acfg) for w in wavs]
        return frames, self._pcm_chunks(wavs, frames, s_mean, s_std)

    def _feature_source(self, feats_list, src_speakers, dtype):
        """The feature entries' prologue: (true frame counts,
        _feature_chunks) of the features z-scored with each source
        speaker's statistics, uint8 codes dequantised in ``dtype``."""
        if self.stats is None:
            feats_list = [np.asarray(f, np.float32) for f in feats_list]
        else:
            feats_list = [self.stats.normalize(f, s) for f, s in zip(feats_list, src_speakers)]
        frames = [f.shape[0] for f in feats_list]
        return frames, self._feature_chunks(feats_list, frames, dtype)

    def _launch(self, chunks, core, route: tuple, shared):
        """For each dispatch, ``core(dev, x, tlens, *shared(dev, rows))`` (a
        tuple of device tensors) on every device's slice of its rows through
        the dispatcher, all launched before any is read back: [(utterance
        indices, [each slice's _Pending])]. ``route`` names what ``core``
        and the chunks' function compute, for the dispatcher's keys."""
        inflight = []
        for chunk, bs_c, arrays, to_features in chunks:
            with span("convert.launch"):
                parts, b = [], bs_c // len(self.devices)  # each device's contiguous share of the rows
                for d, dev in enumerate(self.devices):
                    host = [torch.as_tensor(a[d * b : (d + 1) * b]) for a in arrays]
                    extra = list(shared(dev, b))

                    def fn(*ins, _dev=dev, _f=to_features, _n=len(host)):
                        return core(_dev, *_f(*ins[:_n]), *ins[_n:])

                    key = (route, self.pcm_wire, self.wire, self.gl_iters, dev,
                           tuple((tuple(t.shape), t.dtype) for t in host + extra), _precision())
                    parts.append(self._graphs.run(key, dev, host, extra, fn))
            inflight.append((chunk, parts))
        return inflight

    def _run(self, t_true, chunks, spk_ids=None, tgt_names=None):
        """Launch every chunk's dispatches first, then read back: the units
        of each utterance cut to its ``t_true`` frames, and, with targets
        (``spk_ids``), (units, PCM per target), each PCM cut to its frames
        and decoded from the PCM wire to int16 on the host."""
        if spk_ids is None:
            core, route, shared = self._units_core, ("units",), lambda dev, rows: ()
        else:
            arrays = (np.asarray(spk_ids, np.int64), *self._speaker_stats(len(spk_ids), tgt_names))
            targets = {d: tuple(_to_device(a, d) for a in arrays) for d in self._models}  # once a call

            def shared(dev, rows):  # the ids [n_tgt, rows] of a slice, its targets' statistics
                ids, mean, std = targets[dev]
                return ids[:, None].expand(-1, rows), mean, std

            core, route = self._convert_core, ("convert",)
        inflight = self._launch(chunks, core, route, shared)
        ds, hop = self.hps.downsample, self.acfg.hop_length
        units_out: list = [None] * len(t_true)
        wavs_out: list[list] = [[None] * len(t_true) for _ in spk_ids or ()]
        for chunk, parts in inflight:  # row j is row j % b of slice j // b: no concatenating copy
            with span("convert.readback"):
                outs = [p.numpy() for p in parts]  # a slice's units [b, ...], with targets its PCM [n_tgt, b, n]
                b = outs[0][0].shape[0]
                for j, i in enumerate(chunk):
                    q, r = divmod(j, b)
                    units_out[i] = outs[q][0][r][: -(-t_true[i] // ds)].astype(np.int32)
                    for k, wavs in enumerate(wavs_out):
                        wavs[i] = self._pcm.host_decode(outs[q][1][k, r][: max(t_true[i] - 1, 1) * hop])
        return units_out if spk_ids is None else (units_out, wavs_out)

    def _require_names(self, **names) -> None:
        """With speaker_norm on (the Converter has stats), refuse a call that
        misses any of ``names``: it would (de)normalise with the WRONG
        (global) statistics."""
        missing = [k for k, v in names.items() if v is None]
        if self.stats is not None and missing:
            raise ValueError(
                f"speaker_norm is on (Converter has stats) but {' and '.join(missing)} was not given — "
                "conversion would (de)normalize with the WRONG (global) statistics. Pass the source "
                "speaker per utterance and the name of each target, or build the Converter with "
                "stats=None to opt out."
            )

    # ------------------------------------------------------------- entries

    @torch.inference_mode()
    def convert_wavs_multi(
        self,
        wavs: list[np.ndarray],
        spk_ids: list[int],
        tgt_names: list[str] | None = None,
        src_speakers: list[str] | None = None,
        trim: bool = True,
    ):
        """Batch voice conversion straight from float wavs for several
        targets: trim on the host, then one pass of the whole path per
        bucket chunk. Returns (units_list, wavs_per_target): units_list[i]
        is utterance i's {0,1} int32 [ceil(t/ds), emb] array,
        wavs_per_target[k][i] its int16 PCM for target k. With speaker_norm
        on, ``tgt_names`` is required and sources default to the
        '__global__' statistics."""
        self._require_names(tgt_names=tgt_names)
        with span("convert.convert_wavs_multi"):
            return self._run(*self._wav_source(wavs, src_speakers, trim), spk_ids, tgt_names)

    @torch.inference_mode()
    def encode_units_from_wavs(
        self,
        wavs: list[np.ndarray],
        src_speakers: list[str] | None = None,
        trim: bool = True,
    ) -> list[np.ndarray]:
        """Units straight from wavs, no synthesis (ref enc_only x --test,
        the bitrate-only submission): frontend -> source z-norm ->
        encoder -> MBV bits, bucketed and chunked as convert_wavs_multi,
        so its units are those of the full conversion. Sources default to
        the '__global__' statistics."""
        with span("convert.encode_units_from_wavs"):
            return self._run(*self._wav_source(wavs, src_speakers, trim))

    @torch.inference_mode()
    def encode_units(self, feats_list: list[np.ndarray], src_speakers=None) -> list[np.ndarray]:
        """Units for [T_i, n_feat] features without synthesis (ref
        enc_only). Raises when stats are on and ``src_speakers`` is
        missing. Chunks follow _chunk_batch, as convert_features_multi's
        do; the JAX package pads every chunk here to batch_size, which
        changes no unit (a row's units do not depend on the other rows)."""
        self._require_names(src_speakers=src_speakers)
        with span("convert.encode_units"):
            return self._run(*self._feature_source(feats_list, src_speakers, torch.float32))

    @torch.inference_mode()
    def convert_features_multi(
        self,
        feats_list: list[np.ndarray],
        spk_ids: list[int],
        tgt_names: list[str] | None = None,
        src_speakers: list[str] | None = None,
    ):
        """Convert [T_i, n_feat] features (the Converter's ``feat``) for
        several targets in one pass (same returns as convert_wavs_multi).
        With stats on, both ``src_speakers`` and ``tgt_names`` are required."""
        self._require_names(src_speakers=src_speakers, tgt_names=tgt_names)
        with span("convert.convert_features_multi"):
            return self._run(*self._feature_source(feats_list, src_speakers, self.compute_dtype),
                             spk_ids, tgt_names)

    def convert_features(self, feats_list: list[np.ndarray], spk_id: int):
        """Single-target convenience wrapper: [(units_i, wav_i)]."""
        units, wavs = self.convert_features_multi(feats_list, [spk_id])
        return list(zip(units, wavs[0]))

    def convert_wav(self, wav: np.ndarray, spk_id: int, trim: bool = True, tgt_name=None):
        """Single-utterance conversion (ref --test_single); the source is
        z-scored with the global statistics when speaker_norm is on, which
        needs ``tgt_name`` to denormalise with the target's statistics."""
        self._require_names(tgt_name=tgt_name)
        units, wavs = self.convert_wavs_multi(
            [wav], [spk_id], tgt_names=[tgt_name] if self.stats is not None else None, trim=trim
        )
        return units[0], wavs[0][0]


def _precision() -> tuple:
    """The matmul precision flags a graph's captured kernels were chosen under."""
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _bucket_stats(converter: Converter, true_frames) -> dict:
    """The bucket plan in effect for these utterance lengths: its edges,
    padding overhead (padded/true - 1), executed overhead (rows*frames of
    the dispatches, tail rounding included, /true - 1) and dispatch count."""
    padded = [converter._bucket_of(t) for t in true_frames]
    by_bucket: dict[int, int] = {}
    for tb in padded:
        by_bucket[tb] = by_bucket.get(tb, 0) + 1
    rows_frames, n_disp = 0, 0
    for tb, count in by_bucket.items():
        rows, nd = _chunk_rows(count, converter._bucket_cap(tb))
        rows_frames += rows * tb
        n_disp += nd
    true_total = max(sum(true_frames), 1)
    return {
        "bucket_edges": sorted(by_bucket),
        "padding_overhead": round(sum(padded) / true_total - 1, 4),
        "executed_overhead": round(rows_frames / true_total - 1, 4),
        "n_dispatches": n_disp,
    }


def _convert_planned(
    converter: Converter,
    names: list[str],
    true_frames: list[int],
    result_dir: str | Path,
    target_speakers: dict[str, int],
    encode,
    convert,
    sr: int,
    units_only: bool,
    progress,
    adaptive_buckets: int | None,
    bucket_overhead_target: float | None,
    bucket_cost_model: str,
    dispatch_cost_frames: float,
) -> dict:
    """The shared body of convert_corpus and convert_wav_dir: fit
    ``adaptive_buckets`` edges to ``true_frames`` for this call only
    (``bucket_cost_model`` and ``dispatch_cost_frames`` as fit_buckets'), run
    ``encode()`` (units only) or ``convert(spk_ids, tgt_names)``, write
    ``<result>/units/<utt>.txt`` per utterance and, unless units only,
    ``<result>/<target>/<utt>.wav`` per target. Returns the counts and the
    plan's _bucket_stats."""
    result_dir = Path(result_dir)
    tgt_names = list(target_speakers)
    prev_edges = converter.bucket_edges  # fitted edges are scoped to this corpus
    try:
        if adaptive_buckets:
            converter.fit_buckets(true_frames, adaptive_buckets, target_overhead=bucket_overhead_target,
                                  cost_model=bucket_cost_model, dispatch_cost_frames=dispatch_cost_frames)
        bucket_stats = _bucket_stats(converter, true_frames)
        if units_only:
            units_list, wavs_per_tgt = encode(), ()
        else:
            units_list, wavs_per_tgt = convert([target_speakers[t] for t in tgt_names], tgt_names)
    finally:
        converter.bucket_edges = prev_edges
    for utt, units in zip(names, units_list):
        write_units(result_dir / "units" / f"{utt}.txt", units)
    n_wav = 0
    for tgt_name, wavs in zip(tgt_names, wavs_per_tgt):
        for utt, wav in zip(names, wavs):
            save_wav(result_dir / tgt_name / f"{utt}.wav", wav, sr)
            n_wav += 1
            if progress:
                progress(tgt_name, utt)
    return {"n_utterances": len(names), "n_wavs": n_wav, "result_dir": str(result_dir),
            **bucket_stats}


def load_corpus_split(dataset_path: str | Path, split: str = "test", limit: int | None = None,
                      feat: str = "lin"):
    """(``feat`` features, utterance names, speakers) of a corpus split in
    (speaker, utterance) name order, the order in which the JAX package
    walks its h5 groups, so ``limit`` picks the same utterances."""
    from zerospeech_tts_tpu_torch.data.corpus import load_split

    arena, index = load_split(dataset_path, split, feat)
    order = sorted(range(len(index["names"])), key=lambda i: (index["speakers"][i], index["names"][i]))
    if limit:
        order = order[:limit]
    feats = [np.asarray(arena[index["starts"][i] : index["starts"][i] + index["lengths"][i]])
             for i in order]
    return feats, [index["names"][i] for i in order], [index["speakers"][i] for i in order]


def convert_corpus(
    converter: Converter,
    dataset_path: str | Path,
    result_dir: str | Path,
    target_speakers: dict[str, int],
    split: str = "test",
    sr: int = 16000,
    limit: int | None = None,
    units_only: bool = False,
    progress=None,
    adaptive_buckets: int | None = None,
    bucket_overhead_target: float | None = None,
    bucket_cost_model: str = "frames",
    dispatch_cost_frames: float = 0.0,
) -> dict:
    """Corpus conversion and unit extraction from the features of a port
    corpus directory (the Converter's ``feat``; ref --test):
    ``<result>/units/<utt>.txt`` once per utterance and
    ``<result>/<target>/<utt>.wav`` per target (units only: no wavs). Sources are normalised with their own speaker's
    statistics. ``adaptive_buckets=K`` fits <= K edges to these lengths
    for this call only (``bucket_cost_model``, ``dispatch_cost_frames``:
    Converter.fit_buckets). The result holds the plan's _bucket_stats."""
    feats, names, srcs = load_corpus_split(dataset_path, split, limit, feat=converter.feat)
    return _convert_planned(
        converter, names, [f.shape[0] for f in feats], result_dir, target_speakers,
        lambda: converter.encode_units(feats, src_speakers=srcs),
        lambda spk_ids, tgt_names: converter.convert_features_multi(
            feats, spk_ids, tgt_names=tgt_names, src_speakers=srcs),
        sr, units_only, progress, adaptive_buckets, bucket_overhead_target, bucket_cost_model,
        dispatch_cost_frames,
    )


def convert_wav_dir(
    converter: Converter,
    wav_dir: str | Path,
    result_dir: str | Path,
    target_speakers: dict[str, int],
    sr: int = 16000,
    limit: int | None = None,
    units_only: bool = False,
    progress=None,
    adaptive_buckets: int | None = None,
    bucket_overhead_target: float | None = None,
    bucket_cost_model: str = "frames",
    dispatch_cost_frames: float = 0.0,
) -> dict:
    """Corpus conversion straight from a directory of wavs (ref --test
    iterates english/test/*.wav): ``<result>/units/<utt>.txt`` once per
    utterance and ``<result>/<target>/<utt>.wav`` per target (units only:
    no wavs). Source speakers are unknown for a flat directory, so
    speaker_norm uses the global statistics. ``adaptive_buckets=K`` fits
    <= K edges to the trimmed lengths for this call only, as
    convert_corpus. The result holds
    the plan's _bucket_stats."""
    wav_paths = sorted(Path(wav_dir).glob("*.wav"))
    if limit:
        wav_paths = wav_paths[:limit]
    if not wav_paths:
        raise ValueError(f"no .wav files in {wav_dir}")
    # the plan is made on the lengths the path will see: trim here once and
    # skip the (idempotent) trim inside the conversion call
    ys = [trim_silence(load_wav(p, sr), converter.acfg.top_db) for p in wav_paths]
    return _convert_planned(
        converter, [p.stem for p in wav_paths], [dsp_audio.n_frames_for(len(y), converter.acfg) for y in ys],
        result_dir, target_speakers,
        lambda: converter.encode_units_from_wavs(ys, trim=False),
        lambda spk_ids, tgt_names: converter.convert_wavs_multi(
            ys, spk_ids, tgt_names=tgt_names if converter.stats is not None else None, trim=False),
        sr, units_only, progress, adaptive_buckets, bucket_overhead_target, bucket_cost_model,
        dispatch_cost_frames,
    )


def convert_single(
    converter: Converter,
    wav_path: str | Path,
    target: str,
    target_id: int,
    result_dir: str | Path,
    sr: int | None = None,
) -> dict:
    """Single (source wav, target speaker) path (ref --test_single)."""
    sr = sr or converter.acfg.sr
    y = load_wav(wav_path, sr)
    units, wav = converter.convert_wav(y, target_id, tgt_name=target)
    result_dir = Path(result_dir)
    stem = Path(wav_path).stem
    write_units(result_dir / "units" / f"{stem}.txt", units)
    out = result_dir / target / f"{stem}.wav"
    save_wav(out, wav, sr)
    return {"units": str(result_dir / "units" / f"{stem}.txt"), "wav": str(out)}
