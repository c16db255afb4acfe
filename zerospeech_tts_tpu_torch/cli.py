"""CLI of the PyTorch port: the ``zstts`` verbs from corpus to conversion.

    python -m zerospeech_tts_tpu_torch preprocess --corpus DIR -dataset_path DS
    python -m zerospeech_tts_tpu_torch train1 -dataset_path DS -ckpt_dir CK \
        [--feat lin|mel] [--data-bf16] [--iters-override N] [--train-batch-size B] \
        [--no-pairs] [--fresh] [--load_model STEP|DIR] [--log_dir L]
    python -m zerospeech_tts_tpu_torch train2 -dataset_path DS -ckpt_dir CK \
        [--feat lin|mel] [--data-bf16] [--targets V001 V002] [--iters-override N]
    python -m zerospeech_tts_tpu_torch export -dataset_path DS -ckpt_dir CK --out B \
        [--feat lin|mel]
    python -m zerospeech_tts_tpu_torch convert (--from-export B | -dataset_path DS \
        -ckpt_dir CK [--load_model STEP|DIR] [--feat lin|mel]) [--from-wavs W | \
        -dataset_path DS [--split test]] -result_dir O [--target V001 V002] \
        [--units-only] [--bf16 [--enc-f32]] [--gl-iters N] [--batch-size N] \
        [--limit N] [--frame-budget N] [--adaptive-buckets K \
        [--bucket-overhead-target F] [--bucket-cost-model frames|executed]]
    python -m zerospeech_tts_tpu_torch convert-single (--from-export B | \
        -dataset_path DS -ckpt_dir CK) --source X.wav --target V001 -result_dir O \
        [--bf16 [--enc-f32]] [--feat lin|mel]
    python -m zerospeech_tts_tpu_torch serve (--from-export B | -dataset_path DS \
        -ckpt_dir CK) [--host H] [--port P] [--batch-size N] [--batch-window-ms MS] \
        [--warmup-buckets 256,512] [--bf16 [--enc-f32]] [--feat lin|mel]
    python -m zerospeech_tts_tpu_torch eval [--units O/units [--abx ITEMS \
        [--abx-across] [--abx-max-triples N]]] [--recon] [--stability] \
        [-dataset_path DS -ckpt_dir CK --split train --n-segments 64 --feat lin|mel]
    python -m zerospeech_tts_tpu_torch submission --lang english=O:V001 \
        [-o submission.zip] [--author A ...] | --validate ZIP

Same flags and output layouts as the ``zstts`` verbs, with the port's own
files: the corpus is a numpy directory (data/corpus.py), checkpoints are
``torch.save`` files (train/checkpoint.py), the bundle holds ``model.npz``
(export.py). Training always samples its batches from the corpus arena on
the device, so ``-index_path`` and ``--device-data`` have no counterpart.
Every verb that runs a model takes ``--device``: ``cuda`` (the default)
runs the hand-written kernels and exits with an error when no CUDA device
is visible; ``cpu`` runs their plain versions. ``submission`` and ``eval
--units/--abx`` read files only. ``--wire-uint8`` and ``--wire-mulaw`` are
refused: they are on ROADMAP.md's "do not port" list.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs


FEATS = ("lin", "mel")


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


def wire_flags(p) -> None:
    for flag in ("--wire-uint8", "--wire-mulaw"):
        p.add_argument(flag, action="store_true", help="not ported (ROADMAP.md: do not port)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m zerospeech_tts_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, dataset_required=True):
        p.add_argument("-hps", "--hps", default=str(DEFAULT_HPS_PATH), help="hps JSON path")
        p.add_argument("-dataset_path", "--dataset_path", required=dataset_required,
                       help="corpus directory written by preprocess")
        p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")

    p = sub.add_parser("preprocess", help="build the corpus directory (ref --preprocess)")
    common(p)
    p.add_argument("--corpus", required=True, help="ZeroSpeech-layout corpus dir (train/, test/)")
    p.add_argument("--no-trim", action="store_true")

    for stage in ("train1", "train2"):
        p = sub.add_parser(stage, help="stage-1 phases" if stage == "train1" else "stage-2 patch-GAN")
        common(p)
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
        p.add_argument("--data-bf16", action="store_true",
                       help="hold the training arena on the device in bfloat16 (halves its "
                            "bytes; batches are f32)")

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
    wire_flags(p)
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
    p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")

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
    wire_flags(p)
    p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")

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


def cmd_preprocess(args):
    from zerospeech_tts_tpu_torch.data.corpus import build_corpus

    dev = _device(args)
    _, acfg = load_configs(args.hps)
    t0 = time.time()
    out = build_corpus(args.corpus, args.dataset_path, acfg, trim=not args.no_trim, device=dev)
    _sync(dev)
    out["seconds"] = time.time() - t0
    print(f"corpus: {out['counts']} utterances, {out['frames']} frames, "
          f"{len(out['speakers'])} speakers in {out['seconds']:.1f}s -> {out['path']}")
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


def _make_training(args):
    from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset
    from zerospeech_tts_tpu_torch.train import CheckpointManager, Logger, Solver, init_state

    dev = _device(args)
    t0 = time.time()
    hps, _ = load_configs(args.hps)
    if args.train_batch_size:
        hps = hps.replace(batch_size=args.train_batch_size)
    dataset = DeviceDataset.from_corpus(args.dataset_path, hps, target_speakers=args.targets,
                                        device=dev, feat=args.feat,
                                        dtype=torch.bfloat16 if args.data_bf16 else torch.float32)
    state = init_state(hps, device=dev)
    ckpt = CheckpointManager(args.ckpt_dir, hps=hps)
    logger = Logger(args.log_dir or Path(args.ckpt_dir) / "logs")
    _sync(dev)
    return hps, Solver(hps), dataset, state, ckpt, logger, time.time() - t0


def _run_phases(solver, state, dataset, phases, logger, ckpt, pairs=True) -> dict:
    """Run (mode, iters) phases; returns per phase its steps, seconds and
    last metrics."""
    dev, out = state.device, {}
    for mode, iters in phases:
        if iters == 0:
            continue
        print(f"== phase {mode}: {iters} iters", flush=True)
        step0 = state.step
        _sync(dev)
        t0 = time.time()
        last = solver.train(state, dataset, mode, iters, logger=logger, ckpt=ckpt, pairs=pairs)
        _sync(dev)
        dt = time.time() - t0
        out[mode] = {"steps": state.step - step0, "seconds": dt, "steps_per_s": (state.step - step0) / dt,
                     "last": {k: float(v) for k, v in last.items()}}
        print(f"   {mode}: {state.step - step0} steps in {dt:.2f}s "
              f"({out[mode]['steps_per_s']:.3f} steps/s)", flush=True)
    return out


def cmd_train1(args):
    hps, solver, dataset, state, ckpt, logger, setup_s = _make_training(args)
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
        print(f"resumed from step {state.step}")
        done, trimmed = state.step, []  # skip the completed part of the schedule
        for mode, iters in phases:
            trimmed.append((mode, max(0, min(iters, iters - done))))
            done = max(0, done - iters)
        phases = trimmed
        if all(n == 0 for _, n in phases):
            print("stage-1 schedule already complete; nothing to do")
    print(f"set-up {setup_s:.2f}s (corpus to device, model init)")
    out = _run_phases(solver, state, dataset, phases, logger, ckpt, pairs=not args.no_pairs)
    ckpt.save(state)
    logger.close()
    print(f"stage-1 done at step {state.step}; ckpt -> {args.ckpt_dir}")
    return {"phases": out, "setup_s": setup_s, "resumed_from": resumed, "step": state.step,
            "state": state}


def cmd_train2(args):
    hps, solver, dataset, state, ckpt, logger, setup_s = _make_training(args)
    src, src_step = _restore_source(args, hps, ckpt)
    if src.latest_step() is None:
        sys.exit("train2 requires a stage-1 checkpoint (stage 2 starts from stage-1 weights)")
    src.restore(state, src_step)
    print(f"stage-2 from step {state.step}; set-up {setup_s:.2f}s (corpus to device, model init)")
    out = _run_phases(solver, state, dataset, [("patchGAN", args.iters_override or hps.patch_iters)],
                      logger, ckpt)
    ckpt.save(state)
    logger.close()
    print(f"stage-2 done at step {state.step}")
    return {"phases": out, "setup_s": setup_s, "step": state.step, "state": state}


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


def _refuse_wires(args) -> None:
    for flag in ("wire_uint8", "wire_mulaw"):
        if getattr(args, flag, False):
            sys.exit(f"--{flag.replace('_', '-')}: the port does not have it (ROADMAP.md lists the "
                     "uint8 feature wire and the mu-law PCM wire under 'do not port')")


def _need_model_source(args) -> None:
    if not (args.from_export or (args.dataset_path and args.ckpt_dir)):
        sys.exit("pass -dataset_path and -ckpt_dir, or --from-export DIR")


def _load_converter(args):
    """(Converter, speaker map): from --from-export B (its recorded feat;
    a --feat that contradicts it exits), or from -dataset_path + -ckpt_dir
    (hps from -hps, the --feat statistics from the corpus)."""
    from zerospeech_tts_tpu_torch.convert import Converter
    from zerospeech_tts_tpu_torch.params import from_flax

    _refuse_wires(args)
    dev = _device(args)
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
                bucket_cost_model=args.bucket_cost_model)
    tgts = {t: speakers[t] for t in targets}
    t0 = time.time()
    if args.from_wavs:
        out = convert_wav_dir(conv, args.from_wavs, args.result_dir, tgts, **opts)
    else:
        out = convert_corpus(conv, args.dataset_path, args.result_dir, tgts, split=args.split,
                             **opts)
    _sync(conv.device)
    dt = time.time() - t0
    out["seconds"] = dt
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
          f"{len(speakers)} speakers, {conv.device}, feat {conv.feat}, {conv.compute_dtype}; "
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
    return {"preprocess": cmd_preprocess, "train1": cmd_train1, "train2": cmd_train2,
            "export": cmd_export, "convert": cmd_convert,
            "convert-single": cmd_convert_single, "serve": cmd_serve, "eval": cmd_eval,
            "submission": cmd_submission}[args.cmd](args)


if __name__ == "__main__":
    main()
