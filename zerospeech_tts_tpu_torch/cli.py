"""CLI of the PyTorch port: the conversion verbs of ``zstts``.

    python -m zerospeech_tts_tpu_torch convert --from-export B --from-wavs W \
        -result_dir O [--target V001 V002] [--gl-iters N] [--batch-size N] \
        [--limit N] [--device cuda]
    python -m zerospeech_tts_tpu_torch convert-single --from-export B \
        --source X.wav --target V001 -result_dir O [--device cuda]

Same flags and output layout as ``zstts convert/convert-single
--from-export`` (``<result>/units/<utt>.txt``, ``<result>/<target>/<utt>.wav``).
The bundle is the port's (``model.npz``, see export.py). ``--device cuda``
(the default) runs the hand-written kernels and exits with an error when
no CUDA device is visible; ``--device cpu`` runs their plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m zerospeech_tts_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

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


def _load_converter(args):
    from zerospeech_tts_tpu_torch.convert import Converter
    from zerospeech_tts_tpu_torch.export import load_export
    from zerospeech_tts_tpu_torch.params import from_flax

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"--device {args.device}: no CUDA device is visible (--device cpu runs the "
                 "plain PyTorch path)")
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
    return {"convert": cmd_convert, "convert-single": cmd_convert_single}[args.cmd](args)


if __name__ == "__main__":
    main()
