"""CLI of the PyTorch port: the ``zstts`` verbs from corpus to conversion.

    python -m zerospeech_tts_tpu_torch preprocess --corpus DIR -dataset_path DS \
        -index_path IDX [--n-samples N] [--no-trim] [--workers N | --shard I/N | \
        --merge-shards SHARD_DIR ...]
    python -m zerospeech_tts_tpu_torch train1 -dataset_path DS -index_path IDX -ckpt_dir CK \
        [--device-data [--data-bf16]] [--feat lin|mel] [--iters-override N] \
        [--train-batch-size B] [--no-pairs] [--fresh] [--load_model STEP|DIR] [--log_dir L] \
        [--mesh data=D[,model=M]]   # under torchrun --nproc-per-node D*M
    python -m zerospeech_tts_tpu_torch train2 -dataset_path DS -index_path IDX -ckpt_dir CK \
        [--device-data [--data-bf16]] [--feat lin|mel] [--targets V001 V002] [--iters-override N]
    python -m zerospeech_tts_tpu_torch export -dataset_path DS -ckpt_dir CK --out B \
        [--feat lin|mel]
    python -m zerospeech_tts_tpu_torch convert (--from-export B | -dataset_path DS \
        -ckpt_dir CK [--load_model STEP|DIR] [--feat lin|mel]) [--from-wavs W | \
        -dataset_path DS [--split test]] -result_dir O [--target V001 V002] \
        [--units-only] [--bf16 [--enc-f32]] [--gl-iters N] [--batch-size N] \
        [--limit N] [--frame-budget N] [--adaptive-buckets K \
        [--bucket-overhead-target F] [--bucket-cost-model frames|executed \
        [--dispatch-cost-frames N]]] [--wire-mulaw] [--wire-uint8]
    python -m zerospeech_tts_tpu_torch convert-single (--from-export B | \
        -dataset_path DS -ckpt_dir CK) --source X.wav --target V001 -result_dir O \
        [--bf16 [--enc-f32]] [--feat lin|mel]
    python -m zerospeech_tts_tpu_torch serve (--from-export B | -dataset_path DS \
        -ckpt_dir CK) [--host H] [--port P] [--batch-size N] [--batch-window-ms MS] \
        [--warmup-buckets 256,512] [--bf16 [--enc-f32]] [--feat lin|mel] [--wire-mulaw]
    python -m zerospeech_tts_tpu_torch eval [--units O/units [--abx ITEMS \
        [--abx-across] [--abx-max-triples N]]] [--recon] [--stability] \
        [-dataset_path DS -ckpt_dir CK --split train --n-segments 64 --feat lin|mel]
    python -m zerospeech_tts_tpu_torch submission --lang english=O:V001 \
        [-o submission.zip] [--author A ...] | --validate ZIP

Same flags and output layouts as the ``zstts`` verbs, with the port's own
files: the corpus is a numpy directory (data/corpus.py), checkpoints are
``torch.save`` files (train/checkpoint.py), the bundle holds ``model.npz``
(export.py). ``preprocess`` also writes the segment index (-index_path,
data/segments.py); training reads its batches through the host
``SegmentLoader`` over that index (data/loader.py), or with
``--device-data`` samples them from the corpus arena on the device.
Every verb that runs a model takes ``--device``: ``cuda`` (the default)
runs the hand-written kernels and exits with an error when no CUDA device
is visible; ``cpu`` runs their plain versions. Every verb but
``submission`` takes ``--profile DIR``, ``--check-numerics`` and
``--matmul-precision`` (see their help).

``--mesh data=D[,model=M]`` (train1, train2, convert, convert-single,
serve; the JAX ``--mesh``): training runs over D*M processes, one a card,
launched by ``torchrun --nproc-per-node D*M -m zerospeech_tts_tpu_torch
train1 ... --mesh data=D,model=M`` (each process binds
``cuda:LOCAL_RANK``; NCCL on ``cuda``, gloo on ``cpu``; rank 0 prints,
logs and saves): data-parallel over D (``--device-data`` shards the arena
over the data ranks, the loader gives each its rows of every batch) and,
with M above 1, tensor-parallel over M (each rank keeps its blocks of the
large parameters and of their Adam moments, parallel/mesh.py; the state
is placed so whether fresh or restored). Conversion replicates the model
and splits every dispatch's rows over the D data blocks of its one
process, block d on card d*M; a multi-process launch of a conversion verb
is refused. ``submission`` and ``eval --units/--abx`` read files only.

The wires of the JAX package's Converter: ``--wire-mulaw`` (convert,
serve) carries PCM between host and card as 8-bit mu-law codes, both
ways; ``--wire-uint8`` (convert) carries corpus features as per-utterance
uint8 codes. Files and HTTP answers stay PCM16.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import torch

from zerospeech_tts_tpu_torch import parallel
from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs


FEATS = ("lin", "mel")
MATMUL_PRECISIONS = ("bfloat16", "tensorfloat32", "float32", "highest")
# The gate of the two lower --matmul-precision arms against the float32 arm
# (the package's pin), held on the card by chip_smoke.py and
# tests/test_torch_cuda.py: "units", the share of unit bits equal to the
# float32 arm's over a flagship-width GL-100 conversion (the --bf16 route's
# bar, > 0.9, is the loosest allowed); "loss_rel", the largest relative
# distance of a loss of one train1 step a phase from the float32 arm's.
# Read on an H100 80GB HBM3 (700 W) by chip_smoke.py's arms: tensorfloat32
# 0.999776 of the units, losses within 7.2e-5; bfloat16 0.999824, 1.4e-4.
MATMUL_PRECISION_BARS = {
    "tensorfloat32": {"units": 0.995, "loss_rel": 2e-3},
    "bfloat16": {"units": 0.995, "loss_rel": 2e-3},
}


def global_flags(p) -> None:
    """--profile, --check-numerics and --matmul-precision (the flags JAX's
    ``_common`` gives every verb but submission)."""
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (CPU and CUDA activities, Chrome trace "
                        "format: DIR/<verb>.pt.trace.json) of training or conversion")
    p.add_argument("--check-numerics", action="store_true",
                   help="raise FloatingPointError at the first non-finite loss or module gradient "
                        "norm of a training step, or encoder logit of a conversion (waits for the "
                        "device once a step)")
    p.add_argument("--matmul-precision", default=None, choices=MATMUL_PRECISIONS,
                   help="PyTorch's float32 matmul and convolution precision: float32 and highest "
                        "keep the package's pin (TF32 off for matmuls and cuDNN); tensorfloat32 sets "
                        "torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32; "
                        "bfloat16 sets torch.set_float32_matmul_precision('medium'). The "
                        "hand-written kernels compute as they always do, whatever this flag. Gate on "
                        "the card against float32: " + "; ".join(
                            f"{k} units >= {v['units']} equal, train1 losses within {v['loss_rel']:g} "
                            "relative" for k, v in MATMUL_PRECISION_BARS.items()))


def apply_matmul_precision(choice: str | None) -> None:
    """Set PyTorch's float32 matmul/convolution flags for --matmul-precision
    (None leaves them as the package pinned them at import)."""
    if choice is None:
        return
    tf32 = choice == "tensorfloat32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if choice == "bfloat16":
        torch.set_float32_matmul_precision("medium")
    elif not tf32:
        torch.set_float32_matmul_precision("highest")


@contextmanager
def maybe_profile(args, what: str):
    """A torch.profiler trace of the body into --profile DIR (as JAX's
    ``_MaybeProfile``); yields the trace's path, or None without the flag
    (or on a data-parallel rank above 0: rank 0 alone writes files)."""
    if not getattr(args, "profile", None) or not parallel.is_primary():
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    path = Path(args.profile) / f"{what}.pt.trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(str(path))
    print(f"profiler trace -> {path}", flush=True)


def model_source(p) -> None:
    """The model of convert-single and serve: a bundle, or a checkpoint
    with its corpus (speaker map, statistics) and hps."""
    p.add_argument("--from-export", default=None, metavar="DIR",
                   help="export bundle (model.npz, its own hps), in place of -ckpt_dir")
    p.add_argument("-hps", "--hps", default=str(DEFAULT_HPS_PATH),
                   help="hps JSON of the -ckpt_dir model")
    p.add_argument("-dataset_path", "--dataset_path", default=None,
                   help="corpus directory (speaker map, statistics) of the -ckpt_dir model")
    p.add_argument("-ckpt_dir", "--ckpt_dir", default=None)
    p.add_argument("--load_model", nargs="?", const="latest", default=None, metavar="STEP|DIR",
                   help="checkpoint selection (see train1)")


def dtype_flags(p) -> None:
    p.add_argument("--bf16", action="store_true",
                   help="run the encoder and decoder in bfloat16 (the GRU keeps an f32 state; "
                        "the frontend and Griffin-Lim stay f32); may flip borderline units")
    p.add_argument("--enc-f32", action="store_true",
                   help="keep the encoder in float32 under --bf16: the exact config's units")


def mesh_flag(p) -> None:
    p.add_argument("--mesh", default=None, metavar="data=D[,model=M]",
                   help="training under torchrun --nproc-per-node D*M (one process a card): data-parallel "
                        "over D, tensor-parallel over M; conversion: the rows split over D data blocks, "
                        "block d on card d*M of this process")


def mulaw_flag(p) -> None:
    p.add_argument("--wire-mulaw", action="store_true",
                   help="8-bit mu-law companding on both PCM wire directions (halves the "
                        "host<->device audio bytes; files on disk stay PCM16)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m zerospeech_tts_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, dataset_required=True):
        p.add_argument("-hps", "--hps", default=str(DEFAULT_HPS_PATH), help="hps JSON path")
        p.add_argument("-dataset_path", "--dataset_path", required=dataset_required,
                       help="corpus directory written by preprocess")
        p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")
        global_flags(p)

    p = sub.add_parser("preprocess", help="build the corpus directory and the segment index "
                                          "(ref --preprocess)")
    common(p)
    p.add_argument("--corpus", required=True, help="ZeroSpeech-layout corpus dir (train/, test/)")
    p.add_argument("-index_path", "--index_path", required=True, help="segment index JSON to write")
    p.add_argument("--n-samples", type=int, default=500_000, help="segment index size")
    p.add_argument("--no-trim", action="store_true")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="build only utterance slice I of N into -dataset_path, with raw "
                        "per-speaker stat partials and no segment index; combine the shards "
                        "with --merge-shards")
    p.add_argument("--merge-shards", nargs="+", default=None, metavar="SHARD_DIR",
                   help="merge shard directories (from --shard runs) into -dataset_path, "
                        "finalise the per-speaker stats exactly and write the segment index; "
                        "--corpus is ignored")
    p.add_argument("--workers", type=_positive_int, default=1, metavar="N",
                   help="build with N shard subprocesses (each running the frontend on "
                        "--device), then merge them and remove the shard directories")

    for stage in ("train1", "train2"):
        p = sub.add_parser(stage, help="stage-1 phases" if stage == "train1" else "stage-2 patch-GAN")
        common(p)
        p.add_argument("-index_path", "--index_path", required=True,
                       help="segment index written by preprocess (the SegmentLoader's draws)")
        p.add_argument("-ckpt_dir", "--ckpt_dir", required=True)
        p.add_argument("--log_dir", default=None)
        p.add_argument("--load_model", nargs="?", const="latest", default=None, metavar="STEP|DIR",
                       help="resume: bare = latest in -ckpt_dir (also automatic; see --fresh); "
                            "a STEP number or a checkpoint DIR selects the model to start from")
        p.add_argument("--fresh", action="store_true",
                       help="ignore existing checkpoints and start from scratch")
        p.add_argument("--iters-override", type=int, default=None, help="shrink all phases (smoke)")
        p.add_argument("--targets", nargs="*", default=None, help="stage-2 target speakers")
        p.add_argument("--no-pairs", action="store_true",
                       help="drop the same-utterance pair from stage-1 batches "
                            "(disables the hps.lambda_pair objective)")
        p.add_argument("--train-batch-size", type=int, default=None, help="override hps.batch_size")
        p.add_argument("--feat", default="lin", choices=FEATS, help="features to train on")
        p.add_argument("--device-data", action="store_true",
                       help="sample batches from the corpus arena held on the device, in place "
                            "of the host SegmentLoader over -index_path")
        p.add_argument("--data-bf16", action="store_true",
                       help="with --device-data: hold the arena in bfloat16 (halves its bytes; "
                            "batches are f32)")
        mesh_flag(p)

    p = sub.add_parser("export", help="inference bundle (enc + dec, speakers, stats, hps)")
    common(p)
    p.add_argument("-ckpt_dir", "--ckpt_dir", required=True)
    p.add_argument("--out", required=True, metavar="DIR", help="bundle output directory")
    p.add_argument("--load_model", nargs="?", const="latest", default=None, metavar="STEP|DIR",
                   help="checkpoint selection (see train1)")
    p.add_argument("--feat", default="lin", choices=FEATS,
                   help="features the model was trained on (recorded in the bundle)")

    p = sub.add_parser("convert", help="corpus conversion + unit extraction (ref --test)")
    p.add_argument("--from-export", default=None, metavar="DIR",
                   help="export bundle (model.npz, its own hps), in place of -ckpt_dir")
    p.add_argument("-hps", "--hps", default=str(DEFAULT_HPS_PATH),
                   help="hps JSON of the -ckpt_dir model")
    p.add_argument("-dataset_path", "--dataset_path", default=None,
                   help="corpus directory: features (unless --from-wavs), and with -ckpt_dir "
                        "the speaker map and statistics")
    p.add_argument("-ckpt_dir", "--ckpt_dir", default=None)
    p.add_argument("--load_model", nargs="?", const="latest", default=None, metavar="STEP|DIR",
                   help="checkpoint selection (see train1)")
    p.add_argument("--from-wavs", default=None, metavar="DIR",
                   help="convert straight from a directory of wavs (frontend on the device)")
    p.add_argument("-result_dir", "--result_dir", required=True)
    p.add_argument("--target", nargs="*", default=None, help="target speakers (default: V*)")
    p.add_argument("--split", default="test", help="corpus split to convert")
    p.add_argument("--gl-iters", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--units-only", action="store_true",
                   help="dump discrete units without synthesis (ref enc_only)")
    p.add_argument("--feat", default=None, choices=FEATS,
                   help="features the model was trained on (default: the bundle's, else lin)")
    dtype_flags(p)
    mulaw_flag(p)
    p.add_argument("--wire-uint8", action="store_true",
                   help="quantize corpus features to uint8 on the host->device wire (per-utterance "
                        "min/max, dequantized on the device; halves the input bytes; the --from-wavs "
                        "route has no feature wire and ignores it)")
    p.add_argument("--adaptive-buckets", type=_positive_int, default=None, metavar="K",
                   help="fit <=K length-bucket edges (multiples of 64 frames) to the "
                        "utterances' lengths before converting")
    p.add_argument("--bucket-overhead-target", type=float, default=None, metavar="FRAC",
                   help="with --adaptive-buckets K: the smallest number of edges (<=K) "
                        "whose planned padding overhead is <= FRAC")
    p.add_argument("--frame-budget", type=_positive_int, default=None, metavar="N",
                   help="rows*frames a dispatch: short buckets batch more utterances "
                        "(the largest allowed row count within N, <=128 rows)")
    p.add_argument("--bucket-cost-model", default="frames", choices=["frames", "executed"],
                   help="with --adaptive-buckets K: the planner minimizes padded frames, "
                        "or the rows*frames the dispatches execute (tail rounding, "
                        "--frame-budget caps)")
    p.add_argument("--dispatch-cost-frames", type=float, default=0.0, metavar="N",
                   help="with --bucket-cost-model executed: charge each dispatch N frame-rows "
                        "of overhead in the plan (set high on wire/tunnel-bound hosts where every "
                        "dispatch costs ~fixed wall time; 0 for locally attached devices)")
    p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")
    mesh_flag(p)
    global_flags(p)

    p = sub.add_parser("convert-single", help="single-utterance VC (ref --test_single)")
    model_source(p)
    p.add_argument("-result_dir", "--result_dir", required=True)
    p.add_argument("--source", required=True, help="source wav path")
    p.add_argument("--target", required=True, help="target speaker name")
    p.add_argument("--gl-iters", type=int, default=None)
    p.add_argument("--feat", default=None, choices=FEATS,
                   help="features the model was trained on (default: the bundle's, else lin)")
    dtype_flags(p)
    p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")
    mesh_flag(p)
    global_flags(p)

    p = sub.add_parser("serve", help="HTTP conversion service: a warm model and request "
                                     "micro-batching (no reference counterpart)")
    model_source(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8571, help="0 picks a free port")
    p.add_argument("--batch-size", type=int, default=8,
                   help="the micro-batch ceiling: requests a dispatch")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="the longest a request waits for companions of its plan")
    p.add_argument("--request-timeout", type=float, default=900.0,
                   help="seconds a request waits for its result")
    p.add_argument("--max-body-mb", type=int, default=64,
                   help="refuse request bodies above this size with 400 (0 = unlimited)")
    p.add_argument("--max-frames", type=int, default=32768,
                   help="refuse utterances longer than this many frames (0 = unlimited)")
    p.add_argument("--warmup-buckets", default=None, metavar="FRAMES,FRAMES",
                   help="run these utterance-length buckets once before accepting clients "
                        "(e.g. 256,512: builds the kernels and warms the allocator)")
    p.add_argument("--warmup-targets", type=int, default=1, help="target-set size to warm")
    p.add_argument("--gl-iters", type=int, default=None)
    p.add_argument("--feat", default=None, choices=FEATS,
                   help="features the model was trained on (default: the bundle's, else lin)")
    dtype_flags(p)
    mulaw_flag(p)
    p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")
    mesh_flag(p)
    global_flags(p)

    p = sub.add_parser("eval", help="challenge metrics: unit bitrate, ABX, recon L1, stability")
    common(p, dataset_required=False)
    p.add_argument("--units", default=None, metavar="DIR", help="unit-file dir -> bitrate + stats")
    p.add_argument("-ckpt_dir", "--ckpt_dir", default=None)
    p.add_argument("--recon", action="store_true", help="reconstruction L1 (needs dataset+ckpt)")
    p.add_argument("--stability", action="store_true",
                   help="unit stability under window shifts (needs dataset+ckpt)")
    p.add_argument("--abx", default=None, metavar="ITEMFILE",
                   help="mini-ABX over dumped units (needs --units DIR; item lines: "
                        "utt start end cls spk, latent-frame indices)")
    p.add_argument("--abx-across", action="store_true",
                   help="across-speaker ABX instead of within-speaker")
    p.add_argument("--abx-max-triples", type=int, default=None, metavar="N",
                   help="cap triples per (class-pair, speaker-context) cell by seeded sampling")
    p.add_argument("--split", default="train")
    p.add_argument("--n-segments", type=int, default=64)
    p.add_argument("--feat", default="lin", choices=FEATS, help="features the model was trained on")

    p = sub.add_parser("submission", help="package convert results into a ZeroSpeech "
                                          "archive, or validate one")
    p.add_argument("-hps", "--hps", default=str(DEFAULT_HPS_PATH),
                   help="hps JSON (sets the latent frame duration for bitrate)")
    p.add_argument("--lang", action="append", default=None, metavar="NAME=RESULT_DIR:TARGET",
                   help="language -> convert result dir + submitted target voice, "
                        "e.g. english=out:V001 (repeatable)")
    p.add_argument("-o", "--out", default="submission.zip", help="archive path")
    p.add_argument("--validate", default=None, metavar="ZIP",
                   help="validate an existing archive instead of building")
    p.add_argument("--author", default=None)
    p.add_argument("--affiliation", default=None)
    p.add_argument("--system-description", default=None)
    p.add_argument("--auxiliary1", default=None, help="auxiliary embedding 1 description")
    p.add_argument("--auxiliary2", default=None, help="auxiliary embedding 2 description")
    p.add_argument("--parallel-data", action="store_true",
                   help="declare the system used parallel training data")
    p.add_argument("--external-data", action="store_true",
                   help="declare the system used external (non-challenge) data")
    return ap


def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be a positive integer, got {s}")
    return v


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {args.device}: no CUDA device is visible (--device cpu runs the "
                 "plain PyTorch path)")
    return dev


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _parse_shard(spec: str) -> tuple[int, int]:
    try:
        i, n = (int(x) for x in spec.split("/"))
    except ValueError:
        sys.exit(f"--shard wants I/N (e.g. 0/4), got {spec!r}")
    if not 0 <= i < n:
        sys.exit(f"--shard index {i} not in [0, {n})")
    return i, n


def _build_in_workers(args) -> dict:
    """--workers N: N subprocesses of ``preprocess --shard i/N`` (each runs
    the frontend on --device), then the merge; the shard directories are
    removed. Adds the workers' summed kernel launches ("worker_launches")."""
    import shutil
    import subprocess

    from zerospeech_tts_tpu_torch.data.corpus import merge_corpus_shards

    n = args.workers
    shard_dirs = [f"{args.dataset_path}.shard{i}of{n}" for i in range(n)]
    pkg_root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (pkg_root, os.environ.get("PYTHONPATH")) if p))
    procs = []
    for i, sd in enumerate(shard_dirs):
        cmd = [sys.executable, "-m", "zerospeech_tts_tpu_torch", "preprocess", "--corpus", args.corpus,
               "-dataset_path", sd, "-index_path", args.index_path,  # unused by a shard run
               "--hps", args.hps, "--shard", f"{i}/{n}", "--device", args.device]
        if args.no_trim:
            cmd.append("--no-trim")
        procs.append(subprocess.Popen(cmd, env=env))
    rcs = [p.wait() for p in procs]
    if any(rcs):
        sys.exit(f"shard worker(s) failed: rcs={rcs}")
    launches: dict[str, int] = {}
    for sd in shard_dirs:
        for k, v in json.loads((Path(sd) / "launches.json").read_text()).items():
            launches[k] = launches.get(k, 0) + v
    out = merge_corpus_shards(shard_dirs, args.dataset_path)
    for sd in shard_dirs:
        shutil.rmtree(sd)
    out["worker_launches"] = launches
    return out


def cmd_preprocess(args):
    from zerospeech_tts_tpu_torch import ops
    from zerospeech_tts_tpu_torch.data.corpus import build_corpus, merge_corpus_shards
    from zerospeech_tts_tpu_torch.data.segments import make_segment_index

    hps, acfg = load_configs(args.hps)
    t0 = time.time()
    if args.merge_shards:
        out = merge_corpus_shards(args.merge_shards, args.dataset_path)
        how = f"merged {len(args.merge_shards)} shards"
    elif args.shard is not None:
        i, n = _parse_shard(args.shard)
        dev = _device(args)
        out = build_corpus(args.corpus, args.dataset_path, acfg, trim=not args.no_trim, device=dev,
                           n_shards=n, shard_index=i)
        _sync(dev)
        (Path(args.dataset_path) / "launches.json").write_text(json.dumps(ops.launch_counts()) + "\n")
        out["seconds"] = time.time() - t0
        print(f"shard {i}/{n}: {out['counts']} utterances in {out['seconds']:.1f}s -> {out['path']} "
              "(raw stat partials; run --merge-shards when all shards exist)", flush=True)
        return out
    elif args.workers > 1:
        out = _build_in_workers(args)
        how = f"{args.workers}-worker build"
    else:
        dev = _device(args)
        out = build_corpus(args.corpus, args.dataset_path, acfg, trim=not args.no_trim, device=dev)
        _sync(dev)
        how = "corpus"
    if "train" in out["counts"]:
        entries = make_segment_index(args.dataset_path, args.index_path, hps.seg_len, args.n_samples,
                                     seed=hps.seed, pair_grid=hps.downsample)  # latent-aligned pair offsets
        index = f"index: {len(entries)} segments -> {args.index_path}"
    else:  # a conversion-only corpus (test split alone): nothing to train from
        entries, index = [], "no train split: no segment index written"
    out["index_entries"] = len(entries)
    out["seconds"] = time.time() - t0
    print(f"{how}: {out['counts']} utterances, {out['frames']} frames, {len(out['speakers'])} speakers; "
          f"{index}; {out['seconds']:.1f}s -> {out['path']}", flush=True)
    return out


def _restore_source(args, hps, ckpt):
    """(manager, step) to restore from: --load_model STEP (in -ckpt_dir),
    DIR (its latest, read-only), or the latest of -ckpt_dir."""
    from zerospeech_tts_tpu_torch.train import CheckpointManager

    v = getattr(args, "load_model", None)  # eval has no --load_model: the latest
    if v in (None, "latest"):
        return ckpt, None
    if str(v).lstrip("-").isdigit():
        return ckpt, int(v)
    return CheckpointManager(v, hps=hps, read_only=True), None


def _say(*a) -> None:
    """print, on rank 0 of a data-parallel run (and in any other run)."""
    if parallel.is_primary():
        print(*a, flush=True)


def _join_group(args) -> tuple[torch.device, parallel.Mesh, object]:
    """(this process's device, its place on the mesh, world group or None)
    of a training verb: joins the group torchrun's variables describe (NCCL
    on cuda, gloo on cpu), after checking that ``--mesh data=D,model=M``
    names the launched world, D*M."""
    dev = _device(args)
    (data, model), launched = parallel.parse_mesh(args.mesh), parallel.distributed.launched_world()
    if data * model != launched:
        cmd = " ".join(shlex.quote(a) for a in args.argv)
        if args.mesh is None:
            cmd += f" --mesh data={launched}"
        mesh = f"data={data}" + (f",model={model}" if model > 1 else "")
        sys.exit(f"--mesh {mesh} but WORLD_SIZE is {launched}: training runs one process a card, "
                 f"data x model of them; launch it as\n  torchrun --nproc-per-node {max(data * model, launched)} "
                 f"-m zerospeech_tts_tpu_torch {cmd}")
    if not parallel.initialize(device=dev):
        return dev, parallel.Mesh(), None
    return parallel.local_device(dev), parallel.Mesh(data, model, parallel.rank()), torch.distributed.group.WORLD


def _make_training(args):
    """(hps, solver, data, state, ckpt, logger, set-up seconds): data is
    the host SegmentLoader over -index_path (this data rank's rows of every
    batch), or with --device-data the arena on the device (with --mesh,
    this data rank's shard of it); the state is placed on the mesh
    (parallel.place_state: with model=M its blocks)."""
    from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset, ShardedDeviceDataset
    from zerospeech_tts_tpu_torch.data.loader import SegmentLoader
    from zerospeech_tts_tpu_torch.train import CheckpointManager, Logger, Solver, init_state

    dev, mesh, group = _join_group(args)
    data_group, model_group = parallel.mesh_groups(mesh) if group is not None else (None, None)
    t0 = time.time()
    hps, _ = load_configs(args.hps)
    if args.train_batch_size:
        hps = hps.replace(batch_size=args.train_batch_size)
    if args.device_data:
        kw = dict(target_speakers=args.targets, device=dev, feat=args.feat,
                  dtype=torch.bfloat16 if args.data_bf16 else torch.float32)
        data = (ShardedDeviceDataset.from_corpus(args.dataset_path, hps, mesh.d, mesh.data, **kw) if args.mesh
                else DeviceDataset.from_corpus(args.dataset_path, hps, **kw))
    else:  # stage 1 takes the same-utterance pair; stage 2 does not need it
        data = SegmentLoader(args.dataset_path, args.index_path, hps, feat=args.feat,
                             target_speakers=args.targets, device=dev, seed=hps.seed,
                             pairs=args.cmd == "train1" and not args.no_pairs, rank=mesh.d, world=mesh.data)
    state = parallel.place_state(init_state(hps, device=dev, rank=mesh.d), mesh, model_group)
    ckpt = CheckpointManager(args.ckpt_dir, hps=hps)
    logger = Logger(args.log_dir or Path(args.ckpt_dir) / "logs")
    _sync(dev)
    solver = Solver(hps, check_numerics=args.check_numerics, group=group, data_group=data_group)
    return hps, solver, data, state, ckpt, logger, time.time() - t0


@contextmanager
def _batches(data):
    """What Solver.train draws from: the DeviceDataset itself, or an
    iterator over the SegmentLoader (closed on exit)."""
    if hasattr(data, "sample_batch"):
        yield data
        return
    with data:
        yield iter(data)


def _run_phases(solver, state, data, phases, logger, ckpt, pairs=True) -> dict:
    """Run (mode, iters) phases; returns per phase its steps, seconds and
    last metrics."""
    dev, out = state.device, {}
    for mode, iters in phases:
        if iters == 0:
            continue
        _say(f"== phase {mode}: {iters} iters")
        step0 = state.step
        _sync(dev)
        t0 = time.time()
        last = solver.train(state, data, mode, iters, logger=logger, ckpt=ckpt, pairs=pairs)
        _sync(dev)
        dt = time.time() - t0
        out[mode] = {"steps": state.step - step0, "seconds": dt, "steps_per_s": (state.step - step0) / dt,
                     "last": {k: float(v) for k, v in last.items()}}
        _say(f"   {mode}: {state.step - step0} steps in {dt:.2f}s ({out[mode]['steps_per_s']:.3f} steps/s)")
    return out


def cmd_train1(args):
    try:
        return _train1(args)
    finally:
        parallel.destroy()


def _train1(args):
    hps, solver, data, state, ckpt, logger, setup_s = _make_training(args)
    ov = args.iters_override
    phases = [("pretrain_AE", ov or hps.enc_pretrain_iters),
              ("pretrain_C", ov or hps.dis_pretrain_iters),
              ("train", ov or hps.iters)]
    src, src_step = _restore_source(args, hps, ckpt)
    explicit = args.load_model is not None and (src is not ckpt or src_step is not None)
    if explicit and args.fresh:
        sys.exit("--fresh contradicts --load_model STEP|DIR: pick one")
    resumed = None
    if explicit or (not args.fresh and ckpt.latest_step() is not None):
        src.restore(state, src_step)
        resumed = state.step
        _say(f"resumed from step {state.step}")
        if hasattr(data, "reseed"):  # fresh batches, not a replay of the consumed ones
            data.reseed(state.step)
        done, trimmed = state.step, []  # skip the completed part of the schedule
        for mode, iters in phases:
            trimmed.append((mode, max(0, min(iters, iters - done))))
            done = max(0, done - iters)
        phases = trimmed
        if all(n == 0 for _, n in phases):
            _say("stage-1 schedule already complete; nothing to do")
    _say(f"set-up {setup_s:.2f}s (data, model init)")
    with _batches(data) as batches, maybe_profile(args, "train1") as trace:
        out = _run_phases(solver, state, batches, phases, logger, ckpt, pairs=not args.no_pairs)
    ckpt.save(state)
    logger.close()
    _say(f"stage-1 done at step {state.step}; ckpt -> {args.ckpt_dir}")
    return {"phases": out, "setup_s": setup_s, "resumed_from": resumed, "step": state.step,
            "state": state, "trace": trace}


def cmd_train2(args):
    try:
        return _train2(args)
    finally:
        parallel.destroy()


def _train2(args):
    hps, solver, data, state, ckpt, logger, setup_s = _make_training(args)
    src, src_step = _restore_source(args, hps, ckpt)
    if src.latest_step() is None:
        sys.exit("train2 requires a stage-1 checkpoint (stage 2 starts from stage-1 weights)")
    src.restore(state, src_step)
    if hasattr(data, "reseed"):
        data.reseed(state.step)
    _say(f"stage-2 from step {state.step}; set-up {setup_s:.2f}s (data, model init)")
    with _batches(data) as batches, maybe_profile(args, "train2") as trace:
        out = _run_phases(solver, state, batches, [("patchGAN", args.iters_override or hps.patch_iters)],
                          logger, ckpt)
    ckpt.save(state)
    logger.close()
    _say(f"stage-2 done at step {state.step}")
    return {"phases": out, "setup_s": setup_s, "step": state.step, "state": state, "trace": trace}


def cmd_export(args):
    from zerospeech_tts_tpu_torch.data.corpus import load_speaker_map
    from zerospeech_tts_tpu_torch.data.device_dataset import check_speaker_ids
    from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats
    from zerospeech_tts_tpu_torch.export import export_state
    from zerospeech_tts_tpu_torch.train import CheckpointManager, init_state

    dev = _device(args)
    hps, acfg = load_configs(args.hps)
    speakers = load_speaker_map(args.dataset_path)
    check_speaker_ids(speakers, hps)
    ckpt = CheckpointManager(args.ckpt_dir, hps=hps, read_only=True)  # export only loads
    src, step = _restore_source(args, hps, ckpt)
    state = src.restore(init_state(hps, device=dev), step)
    stats = SpeakerStats.load_corpus(args.dataset_path, args.feat) if hps.speaker_norm else None
    out = export_state(args.out, hps, acfg, state, speakers, stats=stats, feat=args.feat)
    print(json.dumps(out))
    return out


def _restore_state(args, hps, dev):
    """The train state of -ckpt_dir (or --load_model's choice) on ``dev``;
    the directory is only read."""
    from zerospeech_tts_tpu_torch.train import CheckpointManager, init_state

    ckpt = CheckpointManager(args.ckpt_dir, hps=hps, read_only=True)
    src, step = _restore_source(args, hps, ckpt)
    if src.latest_step() is None:
        sys.exit(f"no checkpoint in {args.ckpt_dir}")
    return src.restore(init_state(hps, device=dev), step)


def _need_model_source(args) -> None:
    if not (args.from_export or (args.dataset_path and args.ckpt_dir)):
        sys.exit("pass -dataset_path and -ckpt_dir, or --from-export DIR")


def _load_converter(args):
    """(Converter, speaker map): from --from-export B (its recorded feat;
    a --feat that contradicts it exits), or from -dataset_path + -ckpt_dir
    (hps from -hps, the --feat statistics from the corpus)."""
    from zerospeech_tts_tpu_torch.convert import Converter
    from zerospeech_tts_tpu_torch.params import from_flax

    dev = _device(args)
    launched = parallel.distributed.launched_world()
    if launched > 1:
        sys.exit(f"{args.cmd}: launched as {launched} processes (WORLD_SIZE): conversion runs in one "
                 "process over its local cards (--mesh data=D[,model=M]); the JAX package has no "
                 "multi-process (multi-host) conversion either")
    devices = None
    if args.mesh:
        try:
            devices = parallel.conversion_devices(dev, *parallel.parse_mesh(args.mesh))
        except ValueError as e:
            sys.exit(f"--mesh {args.mesh}: {e}")
    feat = getattr(args, "feat", None)
    if getattr(args, "from_export", None):
        from zerospeech_tts_tpu_torch.export import load_export

        b = load_export(args.from_export)
        if feat is not None and feat != b.feat:
            sys.exit(f"--feat {feat}: the bundle {args.from_export} was trained on {b.feat} "
                     "features (meta.json)")
        feat = b.feat
        hps, acfg, stats, speakers = b.hps, b.acfg, b.stats, dict(b.speakers)
        enc_sd, dec_sd = from_flax({"enc": b.enc, "dec": b.dec})
    else:
        feat = feat or "lin"
        from zerospeech_tts_tpu_torch.data.corpus import load_speaker_map
        from zerospeech_tts_tpu_torch.data.device_dataset import check_speaker_ids
        from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats

        hps, acfg = load_configs(args.hps)
        speakers = load_speaker_map(args.dataset_path)
        check_speaker_ids(speakers, hps)
        state = _restore_state(args, hps, dev)
        enc_sd, dec_sd = state.enc.state_dict(), state.dec.state_dict()
        stats = SpeakerStats.load_corpus(args.dataset_path, feat) if hps.speaker_norm else None
    conv = Converter(
        hps, acfg, enc_sd, dec_sd,
        gl_iters=args.gl_iters,
        batch_size=getattr(args, "batch_size", 8),
        frame_budget=getattr(args, "frame_budget", None),
        stats=stats,
        device=dev,
        feat=feat,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
        encoder_dtype=torch.float32 if args.enc_f32 else None,
        check_numerics=getattr(args, "check_numerics", False),
        devices=devices,
        wire="uint8" if getattr(args, "wire_uint8", False) else "bf16",
        pcm_wire="mulaw" if getattr(args, "wire_mulaw", False) else "int16",
    )
    return conv, speakers


def cmd_convert(args):
    from zerospeech_tts_tpu_torch.convert import convert_corpus, convert_wav_dir

    if args.from_export:
        if not (args.from_wavs or args.dataset_path):
            sys.exit("--from-export has no corpus features: pass --from-wavs DIR "
                     "(frontend on the device) or also give -dataset_path")
    elif not (args.dataset_path and args.ckpt_dir):
        sys.exit("pass -dataset_path and -ckpt_dir, or --from-export DIR")
    conv, speakers = _load_converter(args)
    targets = args.target or sorted(s for s in speakers if s.startswith("V"))
    if not targets:
        sys.exit("no target speakers given and none named V* in the speaker map")
    missing = [t for t in targets if t not in speakers]
    if missing:
        sys.exit(f"target speakers {missing} not in the speaker map")
    opts = dict(sr=conv.acfg.sr, limit=args.limit, units_only=args.units_only,
                adaptive_buckets=args.adaptive_buckets,
                bucket_overhead_target=args.bucket_overhead_target,
                bucket_cost_model=args.bucket_cost_model,
                dispatch_cost_frames=args.dispatch_cost_frames)
    tgts = {t: speakers[t] for t in targets}
    t0 = time.time()
    with maybe_profile(args, "convert") as trace:
        if args.from_wavs:
            out = convert_wav_dir(conv, args.from_wavs, args.result_dir, tgts, **opts)
        else:
            out = convert_corpus(conv, args.dataset_path, args.result_dir, tgts, split=args.split,
                                 **opts)
        _sync(conv.device)
        dt = time.time() - t0
    out["seconds"] = dt
    out["trace"] = trace
    print(
        f"converted {out['n_utterances']} utterances x {0 if args.units_only else len(targets)} "
        f"targets in {dt:.1f}s ({out['n_utterances'] / dt:.2f} utt/s, "
        f"{out['n_wavs'] / dt:.2f} wav/s) -> {out['result_dir']}"
    )
    return out


def cmd_convert_single(args):
    from zerospeech_tts_tpu_torch.convert import convert_single

    _need_model_source(args)
    conv, speakers = _load_converter(args)
    if args.target not in speakers:
        sys.exit(f"target {args.target!r} not in the speaker map {sorted(speakers)[:10]}...")
    out = convert_single(
        conv, args.source, args.target, speakers[args.target], args.result_dir, sr=conv.acfg.sr
    )
    print(json.dumps(out))
    return out


def cmd_serve(args, on_serving=None):
    """Bind the HTTP service and serve until interrupted. ``on_serving``
    (tests, chip_smoke.py) is called with (httpd, service) once the server
    is bound and warm; ``httpd.shutdown()`` from another thread then ends
    the call, which closes the server and the service."""
    from zerospeech_tts_tpu_torch.serve import ConversionService, serve_http

    _need_model_source(args)
    conv, speakers = _load_converter(args)
    service = ConversionService(
        conv, speakers, window_ms=args.batch_window_ms, max_batch=args.batch_size,
        request_timeout=args.request_timeout, max_body_bytes=args.max_body_mb << 20,
        max_frames=args.max_frames,
    )
    try:
        if args.warmup_buckets:
            buckets = [int(x) for x in args.warmup_buckets.split(",") if x.strip()]
            dt = service.warmup(buckets, n_targets=args.warmup_targets)
            print(f"warmed {len(buckets)} buckets in {dt:.1f}s", flush=True)
        httpd = serve_http(service, host=args.host, port=args.port)
    except BaseException:
        service.close()
        raise
    host, port = httpd.server_address[:2]
    print(f"serving on http://{host}:{port}  (batch {args.batch_size}, window {args.batch_window_ms}ms, "
          f"{len(speakers)} speakers, {conv.device}, feat {conv.feat}, {conv.compute_dtype}, "
          f"{conv.pcm_wire} PCM wire; "
          "POST /convert?targets=..., /units; GET /healthz, /speakers)", flush=True)
    try:
        if on_serving is not None:
            on_serving(httpd, service)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
    return {"dispatches": service.dispatches, "served": service.served}


def cmd_eval(args):
    from zerospeech_tts_tpu_torch import eval as ev

    hps, acfg = load_configs(args.hps)
    report = {}
    if args.units:
        frame_seconds = acfg.hop_length * hps.downsample / acfg.sr
        unit_arrays = ev.load_unit_files(args.units)
        report["bitrate"] = ev.unit_bitrate(args.units, frame_seconds, units=unit_arrays)
        report["units"] = ev.unit_stats(args.units, units=unit_arrays)
    if args.abx:
        if not args.units:
            sys.exit("--abx needs --units DIR (the dumped unit files)")
        items = ev.load_abx_items(args.abx, args.units)
        report["abx"] = ev.abx_discriminability(
            items, across_speaker=args.abx_across, max_triples_per_cell=args.abx_max_triples,
        )
    if args.recon or args.stability:
        if not (args.dataset_path and args.ckpt_dir):
            sys.exit("--recon/--stability need -dataset_path and -ckpt_dir")
        state = _restore_state(args, hps, _device(args))
        if args.stability:
            report["stability"] = ev.unit_stability(state, args.dataset_path, hps, feat=args.feat,
                                                    split=args.split)
        if args.recon:
            report["reconstruction"] = ev.reconstruction_l1(
                state, args.dataset_path, hps, feat=args.feat, split=args.split,
                n_segments=args.n_segments,
            )
    if not report:
        sys.exit("nothing to evaluate: pass --units DIR, --recon, and/or --stability")
    print(json.dumps(report, indent=2))
    return report


def cmd_submission(args):
    from zerospeech_tts_tpu_torch.submission import build_submission, validate_submission

    hps, acfg = load_configs(args.hps)
    frame_seconds = acfg.hop_length * hps.downsample / acfg.sr
    if args.validate:
        report = validate_submission(args.validate, frame_seconds=frame_seconds, sr=acfg.sr)
    else:
        if not args.lang:
            sys.exit("pass --lang NAME=RESULT_DIR:TARGET at least once (or --validate ZIP)")
        langs = {}
        for spec in args.lang:
            try:
                name, rest = spec.split("=", 1)
                result_dir, target = rest.rsplit(":", 1)
            except ValueError:
                sys.exit(f"bad --lang spec {spec!r}: want NAME=RESULT_DIR:TARGET")
            langs[name] = (result_dir, target)
        meta = {
            k: v
            for k, v in (
                ("author", args.author),
                ("affiliation", args.affiliation),
                ("system description", args.system_description),
                ("auxiliary1 description", args.auxiliary1),
                ("auxiliary2 description", args.auxiliary2),
            )
            if v is not None
        }
        if args.parallel_data:
            meta["system uses parallel data"] = True
        if args.external_data:
            meta["system uses external data"] = True
        report = build_submission(args.out, langs, metadata=meta, frame_seconds=frame_seconds,
                                  sr=acfg.sr)
        report["archive"] = args.out
    print(json.dumps(report, indent=2))
    if not report["ok"]:
        sys.exit(1)
    return report


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.argv = list(sys.argv[1:] if argv is None else argv)
    apply_matmul_precision(getattr(args, "matmul_precision", None))
    return {"preprocess": cmd_preprocess, "train1": cmd_train1, "train2": cmd_train2,
            "export": cmd_export, "convert": cmd_convert,
            "convert-single": cmd_convert_single, "serve": cmd_serve, "eval": cmd_eval,
            "submission": cmd_submission}[args.cmd](args)


if __name__ == "__main__":
    main()
