"""Convergence demo of the PyTorch port: train the full two-stage system on a
synthetic multi-speaker corpus and check that it LEARNS (the reconstruction
loss falls, the latent speaker classifier beats chance before the
adversarial phase holds it down, conversion lands on the target speaker's
spectral envelope, the units discriminate held-out content).

    python -m zerospeech_tts_tpu_torch.tools.convergence_demo [--cpu] [--iters 600] \
        [--out DIR] [--report FILE]

The port's own copy of ``examples/convergence_demo.py``: the same
synthetic formant speakers and content classes, the same schedule, report
keys and gates, run through the port's ``build_corpus``, ``DeviceDataset``,
``Solver``, ``Converter`` and eval ABX on ``cuda`` (``--cpu`` runs the
plain versions on the CPU). Prints the JSON report and ``CONVERGENCE:
PASS`` or ``CONVERGENCE: WEAK``, and exits 1 on WEAK.
"""

from __future__ import annotations

import argparse
import copy
import json
import tempfile
import time
from pathlib import Path

import numpy as np

# Speaker = a multi-formant vocal tract (resonator cascade) + gain. The
# formant sets overlap across speakers (~10-15% apart) so speaker identity
# is learnable but not saturating.
SPEAKERS = {
    "S01": ((620, 1660, 2500), 0.42),
    "S02": ((760, 1480, 2700), 0.52),
    "S03": ((560, 1840, 2380), 0.46),
    "S04": ((820, 1340, 2620), 0.38),
    "V001": ((600, 1760, 2350), 0.60),
    "V002": ((800, 1400, 2750), 0.45),
}

# Content classes: sequences of the same four "syllables" (f0 multiplier,
# attack, relative duration) in different orders, so they are confusable
# and telling them apart needs temporal structure.
_SYLLS = {
    "a": (1.00, 0.15, 1.0),
    "b": (1.35, 0.50, 0.8),
    "c": (0.80, 0.05, 1.2),
    "d": (1.18, 0.30, 0.9),
}
_CLASSES = [
    "abc", "acb", "bca", "bac", "cab", "cba",  # permutations of {a,b,c}
    "abd", "dba", "cda",                       # held-out test classes
]


def _synth_utt(seq: str, tract_sos, gain: float, rng, sr: int) -> np.ndarray:
    """One utterance: a glottal sawtooth pulse train driven through the
    speaker's resonator cascade, one syllable at a time, with
    per-utterance jitter (f0 x U(0.92, 1.08), per-syllable duration x
    U(0.85, 1.15), noise)."""
    import scipy.signal

    f0_base = 118.0 * rng.uniform(0.92, 1.08)
    segs = []
    for s in seq:
        f0m, attack, rel = _SYLLS[s]
        dur = 0.42 * rel * rng.uniform(0.85, 1.15)
        n = int(dur * sr)
        t = np.arange(n) / sr
        vib = 1 + 0.015 * np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 2 * np.pi))
        src = scipy.signal.sawtooth(2 * np.pi * f0_base * f0m * np.cumsum(vib) / sr)
        env = np.minimum(t / max(attack * dur, 1e-3), 1.0) * np.minimum(
            (dur - t) / (0.25 * dur), 1.0
        ).clip(0.0, 1.0)
        segs.append(src * env)
    y = np.concatenate(segs) + 0.015 * rng.standard_normal(sum(len(s) for s in segs))
    y = scipy.signal.sosfilt(tract_sos, y)
    return (gain * y / (np.abs(y).max() + 1e-9)).astype(np.float32)


def _tract_sos(formants, sr):
    """Vocal-tract filter: a cascade of 2nd-order resonators at the formant
    frequencies (~110 Hz bandwidths)."""
    import scipy.signal

    sos = []
    for f in formants:
        b, a = scipy.signal.iirpeak(f, Q=f / 110.0, fs=sr)
        sos.append(np.hstack([b, a]))
    return np.asarray(sos)


def make_corpus(root: Path, sr=16000, n_test_classes=3, n_real=2):
    """6 speakers x 9 content classes x ``n_real`` jittered realizations;
    the last ``n_test_classes`` classes are held out (S speakers only: the
    test split)."""
    from zerospeech_tts_tpu_torch.dsp.wavio import save_wav

    rng = np.random.default_rng(0)
    n_train_classes = len(_CLASSES) - n_test_classes
    for spk, (formants, gain) in SPEAKERS.items():
        sos = _tract_sos(formants, sr)
        for ci, seq in enumerate(_CLASSES):
            test = ci >= n_train_classes
            if test and spk.startswith("V"):
                continue
            for r in range(n_real):
                y = _synth_utt(seq, sos, gain, rng, sr)
                save_wav(root / ("test" if test else "train") / f"{spk}_{ci:04d}r{r}.wav", y, sr)
    return list(SPEAKERS)


def _utterances(ds: Path, split: str, feat: str = "lin"):
    """[(speaker, name, features)] of a corpus split in (speaker, name)
    order, the order the JAX package's h5 lists them."""
    from zerospeech_tts_tpu_torch.data.corpus import load_split

    arena, index = load_split(ds, split, feat)
    rows = sorted(zip(index["speakers"], index["names"], index["starts"], index["lengths"]))
    return [(spk, name, np.asarray(arena[s0 : s0 + n])) for spk, name, s0, n in rows]


def spectral_envelope(ds: Path, split: str, spk: str):
    envs = [f.mean(axis=0) for s, _, f in _utterances(ds, split) if s == spk]
    return np.mean(envs, axis=0) if envs else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions of the kernels)")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--out", default=None, help="work directory (default: a new temporary one)")
    ap.add_argument("--report", default=None, help="also write the JSON report here")
    ap.add_argument("--lambda-pair", type=float, default=None,
                    help="pair-objective weight (default: the Hps default; 0 = off)")
    ap.add_argument("--matmul-precision", default=None,
                    choices=["bfloat16", "tensorfloat32", "float32", "highest"],
                    help="PyTorch's float32 matmul precision (as the CLI's flag)")
    args = ap.parse_args(argv)

    import torch

    from zerospeech_tts_tpu_torch import eval as ev
    from zerospeech_tts_tpu_torch.cli import apply_matmul_precision
    from zerospeech_tts_tpu_torch.config import AudioConfig, Hps
    from zerospeech_tts_tpu_torch.convert import Converter, write_units
    from zerospeech_tts_tpu_torch.data.corpus import build_corpus
    from zerospeech_tts_tpu_torch.data.device_dataset import DeviceDataset
    from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats
    from zerospeech_tts_tpu_torch.dsp import audio as dsp_audio
    from zerospeech_tts_tpu_torch.models import discretize
    from zerospeech_tts_tpu_torch.models.layers import Noise
    from zerospeech_tts_tpu_torch.train import Solver, init_state

    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible (--cpu runs the demo on the CPU)")
    dev = torch.device("cpu" if args.cpu else "cuda")
    apply_matmul_precision(args.matmul_precision)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_start = time.time()
    work = Path(args.out or tempfile.mkdtemp(prefix="zs_demo_"))
    corpus, ds_dir = work / "corpus", work / "ds"
    print(f"== workdir {work}", flush=True)
    corpus_speakers = make_corpus(corpus)

    acfg = AudioConfig(gl_iters=60)
    hps = Hps(
        batch_size=32, seg_len=64, n_feat=513, emb_size=128, spk_emb_size=32, n_speakers=6,
        bank_size=8, bank_channels=64, conv_channels=256, lr=4e-4,
        lat_sched_iters=max(1, args.iters), alpha_enc=0.02, n_critic=2,
        beta_rec=0.2,  # the JAX demo's stage-2 recipe: a reconstruction anchor, a longer GAN phase
        **({"lambda_pair": args.lambda_pair} if args.lambda_pair is not None else {}),
    )
    manifest = build_corpus(corpus, ds_dir, acfg, device=dev)
    print(f"== corpus {manifest['counts']}", flush=True)

    stats = SpeakerStats.load_corpus(ds_dir, "lin") if hps.speaker_norm else None
    ds = DeviceDataset.from_corpus(ds_dir, hps, target_speakers=["V001", "V002"], device=dev)
    sol = Solver(hps)
    state = init_state(hps, seed=0, device=dev)
    enc_init = copy.deepcopy(state.enc.state_dict())  # the untrained encoder: the ABX baseline

    report = {"iters": args.iters, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    # the reconstruction loss of a pretrain_AE step at initialisation (its
    # loss before the update), on a batch and draws of its own
    probe = torch.Generator(device=dev).manual_seed(99)
    with torch.no_grad():
        b0 = ds.sample_batch(probe, pairs=False)
        z0 = sol._encode(state.enc, b0["x"], Noise(probe))
        report["loss_rec_initial"] = float((state.dec(z0, b0["spk"]) - b0["x"]).abs().mean())

    def clf_probe(st, n_batches=16):
        """Classifier accuracy on deterministic latents (no dropout, no
        Gumbel noise) over 16 fixed batches (512 samples)."""
        accs = []
        with torch.no_grad():
            for i in range(n_batches):
                b = ds.sample_batch(torch.Generator(device=dev).manual_seed(1234 + i), pairs=False)
                z = discretize(st.enc(b["x"], train=False), hps.enc_mode, hps.gumbel_temp, None)
                accs.append((st.clf(z, train=False).argmax(-1) == b["spk"]).float().mean())
        return float(torch.stack(accs).mean())

    for mode, iters in (("pretrain_AE", args.iters), ("pretrain_C", args.iters // 2), ("train", args.iters)):
        sync()
        t0 = time.time()
        m = sol.train(state, ds, mode, iters)
        m = {k: float(v) for k, v in m.items()}
        dt = time.time() - t0
        print(f"== {mode}: {iters} iters in {dt:.1f}s ({iters / dt:.1f} steps/s) -> {m}", flush=True)
        if mode == "pretrain_AE":
            report["loss_rec_after_ae"] = m["loss_rec"]
        if mode == "pretrain_C":
            report["clf_acc_after_pretrain"] = clf_probe(state)
            print(f"   clf probe (512 samples): {report['clf_acc_after_pretrain']:.4f}", flush=True)
        if mode == "train":
            report["loss_rec_final"] = m["loss_rec"]
            report["clf_acc_final"] = clf_probe(state)
            print(f"   clf probe (512 samples): {report['clf_acc_final']:.4f}", flush=True)
        report[f"{mode}_steps_per_sec"] = round(iters / dt, 1)

    # the held-out test set, in the JAX h5's (speaker, utterance) order
    test = _utterances(ds_dir, "test")
    src_spks, names, feats = [t[0] for t in test], [t[1] for t in test], [t[2] for t in test]
    tgt_ids = [manifest["speakers"]["V001"], manifest["speakers"]["V002"]]
    # every speaker's mean train envelope: target accuracy is a 6-way
    # speaker identification (chance 1/6)
    env = {s: spectral_envelope(ds_dir, "train", s) for s in corpus_speakers}

    conv = Converter(hps, acfg, state.enc.state_dict(), state.dec.state_dict(), gl_iters=40, batch_size=4,
                     stats=stats, device=dev)

    def convert_and_measure(st):
        """Convert the held-out content to both targets: how target-shaped
        and how sharp the outputs are."""
        conv.encoder.load_state_dict(st.enc.state_dict())
        conv.decoder.load_state_dict(st.dec.state_dict())
        u, w = conv.convert_features_multi(feats, tgt_ids, tgt_names=["V001", "V002"], src_speakers=src_spks)
        d_tgt_all, sharp_all, hits, total = [], [], 0, 0
        for k, tgt in enumerate(("V001", "V002")):
            for wav in w[k]:
                y = torch.from_numpy(wav.astype(np.float32) / 32767.0)[None].to(dev)
                lin = dsp_audio.wav_to_features(y, acfg)[1][0].cpu().numpy()
                e = lin.mean(axis=0)
                d = {s: float(np.linalg.norm(e - env[s])) for s in env}
                d_tgt_all.append(d[tgt])
                hits += int(min(d, key=d.get) == tgt)
                total += 1
                # spectral sharpness: mean |temporal derivative| of the lin spectrogram
                sharp_all.append(float(np.abs(np.diff(lin, axis=0)).mean()))
        return u, w, {
            "target_envelope_dist": round(float(np.mean(d_tgt_all)), 4),
            "target_envelope_accuracy": hits / total,
            "spectral_sharpness": round(float(np.mean(sharp_all)), 5),
        }

    # stage 2: convert before, train the patch GAN in 4 chunks (each
    # chunk's mean W-distance: the trend), convert after
    _, _, pre = convert_and_measure(state)
    report["stage2_pre"] = pre
    n_chunks = 4
    iters_per_chunk = max(1, (args.iters // 2) // n_chunks)
    gan_iters = n_chunks * iters_per_chunk
    trend = []
    sync()
    t0 = time.time()
    for _ in range(n_chunks):
        w = [sol.train(state, ds, "patchGAN", 1)["w_dist"] for _ in range(iters_per_chunk)]
        trend.append(round(float(torch.stack(w).mean()), 4))
    sync()
    dt = time.time() - t0
    gan_steps = gan_iters * (hps.n_critic + 1)
    print(f"== patchGAN: {gan_iters} iters in {dt:.1f}s ({gan_steps / dt:.1f} steps/s) w_dist trend {trend}",
          flush=True)
    report["patchGAN_steps_per_sec"] = round(gan_steps / dt, 1)
    report["stage2_w_dist_trend"] = trend
    units, _, post = convert_and_measure(state)
    report["stage2_post"] = post
    report["stage2_envelope_dist_delta"] = round(pre["target_envelope_dist"] - post["target_envelope_dist"], 4)
    report["stage2_sharpness_delta"] = round(post["spectral_sharpness"] - pre["spectral_sharpness"], 5)
    report["n_test_utts"] = len(names)
    report["units_active_fraction"] = float(np.mean([u.mean() for u in units]))

    def abx_of(units_list, subdir):
        """Across-speaker mini-ABX over the dumped units (class = content
        id), through the unit files and the item-file loader."""
        units_dir = work / subdir
        item_lines = []
        for utt, u in zip(names, units_list):
            write_units(units_dir / f"{utt}.txt", u)
            spk, rest = utt.rsplit("_", 1)
            item_lines.append(f"{utt} 0 {u.shape[0]} c{int(rest.split('r')[0])} {spk}")
        item_file = work / f"{subdir}_items.txt"
        item_file.write_text("# utt start end cls spk\n" + "\n".join(item_lines) + "\n")
        return ev.abx_discriminability(ev.load_abx_items(item_file, units_dir), across_speaker=True)

    report["unit_stability"] = ev.unit_stability(state, ds_dir, hps, split="test", n_utts=8)["unit_stability"]
    abx = abx_of(units, "units")
    report["abx"] = abx["abx"]
    report["abx_n_contexts"] = abx["n_contexts"]
    conv.encoder.load_state_dict(enc_init)  # the untrained encoder's units on the same items
    abx0 = abx_of(conv.encode_units(feats, src_speakers=src_spks), "units_init")
    report["abx_initial"] = abx0["abx"]
    report["abx_delta"] = round(abx["abx"] - abx0["abx"], 4)
    report["target_envelope_accuracy"] = post["target_envelope_accuracy"]
    report["wall_seconds"] = round(time.time() - t_start, 1)

    report["gates"] = gate_results(report, hps.n_speakers)
    ok = all(report["gates"].values())
    print(json.dumps(report, indent=2))
    if args.report:
        Path(args.report).write_text(json.dumps(report, indent=2) + "\n")
    print("CONVERGENCE:", "PASS" if ok else "WEAK")
    return 0 if ok else 1


def gate_results(report: dict, n_speakers: int) -> dict:
    """The JAX demo's gates (examples/convergence_demo.py), each by name."""
    return {
        "loss_rec_final < 0.75 x initial": report["loss_rec_final"] < 0.75 * report["loss_rec_initial"],
        "clf_acc_after_pretrain >= 1.05 / n_speakers": report["clf_acc_after_pretrain"] >= 1.05 / n_speakers,
        "clf_acc_final <= max(1.5 / n_speakers, after_pretrain + 0.04)": report["clf_acc_final"] <= max(
            1.5 / n_speakers, report["clf_acc_after_pretrain"] + 0.04),
        "target_envelope_accuracy >= 0.5": report["target_envelope_accuracy"] >= 0.5,
        "stage2_w_dist_trend finite": bool(all(np.isfinite(v) for v in report["stage2_w_dist_trend"])),
        "abx > 0.55": report["abx"] > 0.55,
        "abx_delta > 0": report["abx_delta"] > 0,
    }


if __name__ == "__main__":
    raise SystemExit(main())
