"""CLI of the PyTorch port: the ``zstts`` verbs from corpus to conversion.

    python -m zerospeech_tts_tpu_torch preprocess --corpus DIR -dataset_path DS
    python -m zerospeech_tts_tpu_torch train1 -dataset_path DS -ckpt_dir CK \
        [--iters-override N] [--train-batch-size B] [--no-pairs] [--fresh] \
        [--load_model STEP|DIR] [--log_dir L]
    python -m zerospeech_tts_tpu_torch train2 -dataset_path DS -ckpt_dir CK \
        [--targets V001 V002] [--iters-override N]
    python -m zerospeech_tts_tpu_torch export -dataset_path DS -ckpt_dir CK --out B
    python -m zerospeech_tts_tpu_torch convert --from-export B --from-wavs W \
        -result_dir O [--target V001 V002] [--gl-iters N] [--batch-size N] \
        [--limit N]
    python -m zerospeech_tts_tpu_torch convert-single --from-export B \
        --source X.wav --target V001 -result_dir O

Same flags and output layouts as the ``zstts`` verbs, with the port's own
files: the corpus is a numpy directory (data/corpus.py), checkpoints are
``torch.save`` files (train/checkpoint.py), the bundle holds ``model.npz``
(export.py). Training always samples its batches from the corpus arena on
the device, so ``-index_path`` and ``--device-data`` have no counterpart.
Every verb takes ``--device``: ``cuda`` (the default) runs the hand-written
kernels and exits with an error when no CUDA device is visible; ``cpu``
runs their plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs


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

    p = sub.add_parser("export", help="inference bundle (enc + dec, speakers, stats, hps)")
    common(p)
    p.add_argument("-ckpt_dir", "--ckpt_dir", required=True)
    p.add_argument("--out", required=True, metavar="DIR", help="bundle output directory")
    p.add_argument("--load_model", nargs="?", const="latest", default=None, metavar="STEP|DIR",
                   help="checkpoint selection (see train1)")

    p = sub.add_parser("convert", help="corpus conversion + unit extraction from wavs (ref --test)")
    p.add_argument("--from-export", required=True, metavar="DIR", help="export bundle (model.npz)")
    p.add_argument("--from-wavs", required=True, metavar="DIR", help="directory of source wavs")
    p.add_argument("-result_dir", "--result_dir", required=True)
    p.add_argument("--target", nargs="*", default=None, help="target speakers (default: V*)")
    p.add_argument("--gl-iters", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")

    p = sub.add_parser("convert-single", help="single-utterance VC (ref --test_single)")
    p.add_argument("--from-export", required=True, metavar="DIR", help="export bundle (model.npz)")
    p.add_argument("-result_dir", "--result_dir", required=True)
    p.add_argument("--source", required=True, help="source wav path")
    p.add_argument("--target", required=True, help="target speaker name")
    p.add_argument("--gl-iters", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (kernels) or cpu (plain PyTorch)")
    return ap


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

    v = args.load_model
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
                                        device=dev)
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
    stats = SpeakerStats.load_corpus(args.dataset_path, "lin") if hps.speaker_norm else None
    out = export_state(args.out, hps, acfg, state, speakers, stats=stats)
    print(json.dumps(out))
    return out


def _load_converter(args):
    from zerospeech_tts_tpu_torch.convert import Converter
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.params import from_flax

    _device(args)
    b = load_export(args.from_export)
    enc_sd, dec_sd = from_flax({"enc": b.enc, "dec": b.dec})
    conv = Converter(
        b.hps, b.acfg, enc_sd, dec_sd,
        gl_iters=args.gl_iters,
        batch_size=getattr(args, "batch_size", 8),
        stats=b.stats,
        device=args.device,
    )
    return conv, dict(b.speakers)


def cmd_convert(args):
    from zerospeech_tts_tpu_torch.convert import convert_wav_dir

    conv, speakers = _load_converter(args)
    targets = args.target or sorted(s for s in speakers if s.startswith("V"))
    if not targets:
        sys.exit("no target speakers given and none named V* in the bundle")
    missing = [t for t in targets if t not in speakers]
    if missing:
        sys.exit(f"target speakers {missing} not in the bundle's speaker map")
    t0 = time.time()
    out = convert_wav_dir(
        conv, args.from_wavs, args.result_dir, {t: speakers[t] for t in targets},
        sr=conv.acfg.sr, limit=args.limit,
    )
    dt = time.time() - t0
    print(
        f"converted {out['n_utterances']} utterances x {len(targets)} targets "
        f"in {dt:.1f}s ({out['n_wavs'] / dt:.2f} wav/s) -> {out['result_dir']}"
    )
    return out


def cmd_convert_single(args):
    from zerospeech_tts_tpu_torch.convert import convert_single

    conv, speakers = _load_converter(args)
    if args.target not in speakers:
        sys.exit(f"target {args.target!r} not in the bundle's speaker map {sorted(speakers)[:10]}...")
    out = convert_single(
        conv, args.source, args.target, speakers[args.target], args.result_dir, sr=conv.acfg.sr
    )
    print(json.dumps(out))
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    return {"preprocess": cmd_preprocess, "train1": cmd_train1, "train2": cmd_train2,
            "export": cmd_export, "convert": cmd_convert,
            "convert-single": cmd_convert_single}[args.cmd](args)


if __name__ == "__main__":
    main()
