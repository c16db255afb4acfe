"""Challenge submission packager and validator (copy of
``zerospeech_tts_tpu/submission.py``, reading the port's own ``convert``
results and its ``eval.unit_bitrate``).

* :func:`build_submission` pairs every unit file of each language's
  ``convert`` result dir with its wav in the chosen target voice, writes
  ``metadata.yaml`` and one zip in the challenge layout::

      metadata.yaml
      english/test/<utt>.txt      # one 0/1 unit row per latent frame
      english/test/<utt>.wav      # 16 kHz PCM16 synthesis, target voice
      surprise/test/...           # optional second language

* :func:`validate_submission` re-opens a zip (ours or anyone's) and checks
  what the evaluator depends on: every txt has a wav and vice versa, unit
  rows are a binary matrix of one width, wavs are 16 kHz PCM16 and not
  silent; it reports each language's unit bitrate.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np

METADATA_FIELDS = (
    # (key, default) — flat YAML, one scalar per line
    ("author", "anonymous"),
    ("affiliation", "unaffiliated"),
    ("system description", "zerospeech_tts_tpu_torch: MBV autoencoder + patch-GAN (PyTorch + CUDA)"),
    ("open source", True),
    ("system uses parallel data", False),
    ("system uses external data", False),
    ("auxiliary1 description", ""),
    ("auxiliary2 description", ""),
)


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    # quote anything YAML could misparse; these are human-entered strings
    if s == "" or any(c in s for c in ":#{}[]&*!|>'\"%@`\n"):
        return json.dumps(s)
    return s


def render_metadata(overrides: dict | None = None) -> str:
    """Flat metadata.yaml text. Unknown override keys are kept (the
    official checker has accepted extra fields historically); known
    keys keep the canonical order above."""
    overrides = dict(overrides or {})
    lines = []
    for key, default in METADATA_FIELDS:
        lines.append(f"{key}: {_yaml_scalar(overrides.pop(key, default))}")
    for key, v in overrides.items():
        lines.append(f"{key}: {_yaml_scalar(v)}")
    return "\n".join(lines) + "\n"


def _result_pairs(result_dir: str | Path, target: str) -> list[tuple[str, Path, Path]]:
    """(utt, units_txt, wav) triples from a ``convert`` result dir."""
    result_dir = Path(result_dir)
    units_dir = result_dir / "units"
    wav_dir = result_dir / target
    if not units_dir.is_dir():
        raise FileNotFoundError(f"{units_dir} missing — run convert first")
    if not wav_dir.is_dir():
        raise FileNotFoundError(
            f"{wav_dir} missing — convert with --target {target} (or pass the "
            f"target whose voice should be submitted)"
        )
    pairs = []
    for txt in sorted(units_dir.glob("*.txt")):
        wav = wav_dir / f"{txt.stem}.wav"
        if not wav.exists():
            raise FileNotFoundError(f"unit file {txt.name} has no wav in {wav_dir}")
        pairs.append((txt.stem, txt, wav))
    if not pairs:
        raise ValueError(f"no unit files in {units_dir}")
    extra = {w.stem for w in wav_dir.glob("*.wav")} - {u for u, _, _ in pairs}
    if extra:
        raise ValueError(
            f"wavs without unit files in {wav_dir}: {sorted(extra)[:5]}..."
            if len(extra) > 5
            else f"wavs without unit files in {wav_dir}: {sorted(extra)}"
        )
    return pairs


def build_submission(
    out_zip: str | Path,
    langs: dict[str, tuple[str | Path, str]],
    metadata: dict | None = None,
    frame_seconds: float = 0.1,
    sr: int = 16000,
) -> dict:
    """Assemble ``{lang: (result_dir, target_voice)}`` into one archive,
    then :func:`validate_submission` it (a submission that fails its own
    validator is never written silently — the zip is produced first so
    the failure report points at real archive members)."""
    out_zip = Path(out_zip)
    if not langs:
        raise ValueError("need at least one language -> (result_dir, target)")
    manifest = {}
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("metadata.yaml", render_metadata(metadata))
        for lang, (result_dir, target) in langs.items():
            pairs = _result_pairs(result_dir, target)
            for utt, txt, wav in pairs:
                zf.write(txt, f"{lang}/test/{utt}.txt")
                zf.write(wav, f"{lang}/test/{utt}.wav")
            manifest[lang] = {"n_utterances": len(pairs), "target_voice": target}
    report = validate_submission(out_zip, frame_seconds=frame_seconds, sr=sr)
    report["built"] = manifest
    return report


def _check_units_text(name: str, raw: bytes, problems: list[str]) -> np.ndarray | None:
    try:
        u = np.loadtxt(io.StringIO(raw.decode("ascii")), dtype=np.int64, ndmin=2)
    except Exception as e:  # noqa: BLE001 — anything unparsable is a finding
        problems.append(f"{name}: unparsable unit matrix ({e})")
        return None
    if u.size == 0:
        problems.append(f"{name}: empty unit file")
        return None
    if not np.isin(u, (0, 1)).all():
        problems.append(f"{name}: non-binary unit symbols {np.unique(u)[:6].tolist()}")
        return None
    return u.astype(np.uint8)


def _check_wav(name: str, raw: bytes, sr: int, problems: list[str]) -> float | None:
    from scipy.io import wavfile

    try:
        got_sr, data = wavfile.read(io.BytesIO(raw))
    except Exception as e:  # noqa: BLE001
        problems.append(f"{name}: unreadable wav ({e})")
        return None
    if got_sr != sr:
        problems.append(f"{name}: sample rate {got_sr}, expected {sr}")
    if data.dtype != np.int16:
        problems.append(f"{name}: dtype {data.dtype}, expected PCM16")
        return None
    if data.ndim != 1:
        problems.append(f"{name}: {data.ndim}-channel audio, expected mono")
        return None
    rms = float(np.sqrt(np.mean(data.astype(np.float64) ** 2)))
    if rms < 1.0:  # < 1 LSB RMS: digital silence, synthesis failed
        problems.append(f"{name}: silent audio (rms {rms:.3f} LSB)")
    return len(data) / sr


def validate_submission(
    zip_path: str | Path, frame_seconds: float = 0.1, sr: int = 16000
) -> dict:
    """Structural + content validation, plus per-language bitrate.

    Returns ``{"ok": bool, "problems": [...], "languages": {...}}``.
    Never raises on content findings — the point is the full list.
    """
    from zerospeech_tts_tpu_torch.eval import unit_bitrate

    problems: list[str] = []
    langs: dict[str, dict] = {}
    per_lang_units: dict[str, dict[str, np.ndarray]] = {}
    per_lang_wavs: dict[str, dict[str, float]] = {}
    with zipfile.ZipFile(zip_path) as zf:
        names = set(zf.namelist())
        if "metadata.yaml" not in names:
            problems.append("metadata.yaml missing at archive root")
        for name in sorted(names - {"metadata.yaml"}):
            if name.endswith("/"):
                continue
            parts = name.split("/")
            if len(parts) != 3 or parts[1] != "test":
                problems.append(f"{name}: not under <lang>/test/")
                continue
            lang, _, fname = parts
            utt, dot, ext = fname.rpartition(".")
            raw = zf.read(name)
            if ext == "txt":
                u = _check_units_text(name, raw, problems)
                if u is not None:
                    per_lang_units.setdefault(lang, {})[utt] = u
            elif ext == "wav":
                dur = _check_wav(name, raw, sr, problems)
                if dur is not None:
                    per_lang_wavs.setdefault(lang, {})[utt] = dur
            else:
                problems.append(f"{name}: unexpected file type")

    for lang in sorted(set(per_lang_units) | set(per_lang_wavs)):
        units = per_lang_units.get(lang, {})
        wavs = per_lang_wavs.get(lang, {})
        for utt in sorted(set(units) - set(wavs)):
            problems.append(f"{lang}/test/{utt}.txt has no synthesized wav")
        for utt in sorted(set(wavs) - set(units)):
            problems.append(f"{lang}/test/{utt}.wav has no unit file")
        widths = {u.shape[1] for u in units.values()}
        if len(widths) > 1:
            problems.append(f"{lang}: inconsistent unit widths {sorted(widths)}")
        info: dict = {
            "n_utterances": len(set(units) | set(wavs)),
            "audio_seconds": round(sum(wavs.values()), 1),
        }
        if units and len(widths) == 1:
            info["unit_width"] = widths.pop()
            info["bitrate"] = unit_bitrate(
                "", frame_seconds, units=list(units.values())
            )
        langs[lang] = info

    if not langs:
        problems.append("no <lang>/test/ content in archive")
    return {"ok": not problems, "problems": problems, "languages": langs}
