"""Deployment export bundle of the PyTorch port (counterpart of
``zerospeech_tts_tpu/export.py``).

Same layout as the JAX bundle, except that the orbax ``model/`` tree is
one ``model.npz`` (a host with the card has no JAX/orbax to read it):

    <dir>/hps.json        # full Hps dict + "audio" block (load_configs shape)
    <dir>/meta.json       # {"version", "feat" ("lin" or "mel"), "step"}
    <dir>/speakers.json   # name -> id
    <dir>/stats.npz       # per-speaker mean/std ("<spk>|mean" keys); only
                          #   when the model was trained with speaker_norm
    <dir>/model.npz       # flax paths joined by "/" ("enc/rnn/bwd/wh"),
                          #   arrays in the flax layout (params.py)
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from zerospeech_tts_tpu_torch.config import AudioConfig, Hps, load_configs
from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats
from zerospeech_tts_tpu_torch.params import _strip_params, flatten, to_flax, unflatten

EXPORT_VERSION = 1


@dataclasses.dataclass
class ExportBundle:
    hps: Hps
    acfg: AudioConfig
    enc: dict  # flax-layout numpy tree (no "params" level)
    dec: dict
    speakers: dict[str, int]
    stats: SpeakerStats | None  # when the model uses speaker_norm
    feat: str  # the features the model was trained on: "lin" or "mel"
    step: int | None


def save_export(
    out_dir: str | Path,
    hps: Hps,
    acfg: AudioConfig,
    enc: dict,
    dec: dict,
    speakers: dict[str, int],
    stats: SpeakerStats | None = None,
    step: int | None = None,
    feat: str = "lin",
) -> dict:
    """Write the bundle (``enc``/``dec``: flax-layout trees, with or
    without the ``params`` level); ``feat`` (``lin`` or ``mel``, the
    features the model was trained on) goes into meta.json. Overwrites an
    existing bundle."""
    _check_feat(feat, "save_export")
    _check_width(feat, hps, acfg, "save_export")
    if hps.speaker_norm and stats is None:
        raise ValueError(
            "hps.speaker_norm is on but no stats were given — a bundle "
            "without stats would (de)normalize wrongly at inference"
        )
    out = Path(out_dir).absolute()
    out.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.asdict(hps)
    cfg["audio"] = dataclasses.asdict(acfg)
    (out / "hps.json").write_text(json.dumps(cfg, indent=2) + "\n")
    (out / "meta.json").write_text(
        json.dumps({"version": EXPORT_VERSION, "feat": feat, "step": step}) + "\n"
    )
    (out / "speakers.json").write_text(json.dumps(speakers, indent=2) + "\n")
    if stats is not None:
        arrs = {}
        for spk in stats.mean:
            arrs[f"{spk}|mean"] = np.asarray(stats.mean[spk], np.float32)
            arrs[f"{spk}|std"] = np.asarray(stats.std[spk], np.float32)
        np.savez(out / "stats.npz", **arrs)
    flat = flatten({"enc": _strip_params(enc), "dec": _strip_params(dec)})
    np.savez(out / "model.npz", **flat)
    return {
        "path": str(out),
        "params_bytes": int(sum(a.nbytes for a in flat.values())),
        "n_speakers": len(speakers),
        "feat": feat,
        "step": step,
    }


def export_state(
    out_dir: str | Path,
    hps: Hps,
    acfg: AudioConfig,
    state,
    speakers: dict[str, int],
    stats: SpeakerStats | None = None,
    feat: str = "lin",
) -> dict:
    """The bundle of a training state (train/solver.py ``TrainState``):
    its encoder and decoder at its step."""
    tree = to_flax(state.enc.state_dict(), state.dec.state_dict())
    return save_export(out_dir, hps, acfg, tree["enc"], tree["dec"], speakers, stats=stats,
                       step=state.step, feat=feat)


def _check_feat(feat: str, where: str) -> None:
    if feat not in ("lin", "mel"):
        raise ValueError(f"{where}: feat={feat!r}, expected 'lin' or 'mel'")


def _check_width(feat: str, hps: Hps, acfg: AudioConfig, where: str) -> None:
    """A mel model reads (and writes) the mel width."""
    if feat == "mel" and hps.n_feat != acfg.n_mels:
        raise ValueError(f"{where}: feat='mel' but hps.n_feat={hps.n_feat} != audio.n_mels={acfg.n_mels}")


def load_export(bundle_dir: str | Path) -> ExportBundle:
    out = Path(bundle_dir).absolute()
    if not (out / "meta.json").exists():
        raise FileNotFoundError(f"{out} is not an export bundle (no meta.json)")
    meta = json.loads((out / "meta.json").read_text())
    if meta.get("version", 0) > EXPORT_VERSION:
        raise ValueError(f"bundle {out} has version {meta['version']} > supported {EXPORT_VERSION}")
    feat = meta.get("feat", "lin")
    _check_feat(feat, f"bundle {out}")
    if not (out / "model.npz").exists():
        raise FileNotFoundError(
            f"{out} has no model.npz"
            + (" (it holds an orbax model/ tree: write model.npz with "
               "zerospeech_tts_tpu_torch.export.save_export from the JAX params)"
               if (out / "model").is_dir() else "")
        )
    hps, acfg = load_configs(out / "hps.json")
    _check_width(feat, hps, acfg, f"bundle {out}")
    speakers = json.loads((out / "speakers.json").read_text())
    stats = None
    if (out / "stats.npz").exists():
        mean, std = {}, {}
        with np.load(out / "stats.npz") as z:
            for key in z.files:
                spk, kind = key.rsplit("|", 1)
                (mean if kind == "mean" else std)[spk] = z[key]
        stats = SpeakerStats(mean, std)
    if hps.speaker_norm and stats is None:
        raise ValueError(f"bundle {out}: hps.speaker_norm is on but stats.npz is missing")
    with np.load(out / "model.npz") as z:
        tree = unflatten({k: z[k] for k in z.files})
    return ExportBundle(
        hps=hps,
        acfg=acfg,
        enc=tree["enc"],
        dec=tree["dec"],
        speakers=speakers,
        stats=stats,
        feat=feat,
        step=meta.get("step"),
    )
