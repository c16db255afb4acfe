"""L0 — hyperparameter system (PyTorch port; a copy of
``zerospeech_tts_tpu/config.py``, which is framework-free).

Reference: the ``Hps`` class in ``utils.py:~15-60`` loads ``hps/*.json`` into
a namedtuple threaded through the whole program (SURVEY.md §2 "Hyperparameter
system"). Here the same JSON files load into frozen dataclasses so configs
stay hashable and immutable. The hps JSONs are copied into this package's
``hps/`` so the port never imports the JAX package.

Field names follow the reference hps JSON so reference configs load verbatim
where known; values are reconstructed (the reference mount was empty at
survey time — SURVEY.md provenance note) and therefore all overridable via
JSON. Unknown JSON keys are rejected loudly rather than silently dropped.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Mapping


def _load_into(cls, data: Mapping[str, Any], path: str | Path | None = None):
    known = {f.name for f in dataclasses.fields(cls)}
    data = {k: v for k, v in data.items() if not k.startswith("_")}  # _comment etc.
    unknown = set(data) - known
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys {sorted(unknown)} in {path or 'mapping'}; "
            f"known keys: {sorted(known)}"
        )
    return cls(**data)


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """DSP constants (ref preprocess.py:~1-20 hyperparameter block).

    Tacotron-style frontend: 16 kHz, 1024-point FFT, 12.5 ms hop, 50 ms
    window, 80 mels, dB-normalized to [0, 1] (SURVEY.md §2 "Audio DSP").
    """

    sr: int = 16000
    n_fft: int = 1024
    hop_length: int = 200          # 12.5 ms at 16 kHz
    win_length: int = 800          # 50 ms at 16 kHz
    n_mels: int = 80
    preemphasis: float = 0.97
    max_db: float = 100.0
    ref_db: float = 20.0
    top_db: float = 15.0           # librosa.effects.trim threshold
    gl_iters: int = 100            # Griffin-Lim iterations
    gl_power: float = 1.2          # magnitude sharpening before Griffin-Lim
    gl_momentum: float = 0.99      # fast-GL extrapolation (0 = plain GL as in ref)
    fmin: float = 0.0
    fmax: float | None = None      # None -> sr / 2

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def effective_fmax(self) -> float:
        return self.sr / 2 if self.fmax is None else self.fmax

    @classmethod
    def from_dict(cls, data: Mapping[str, Any], path=None) -> "AudioConfig":
        return _load_into(cls, data, path)


@dataclasses.dataclass(frozen=True)
class Hps:
    """Training/model hyperparameters (ref ``Hps`` namedtuple, utils.py:~15-60).

    Stage-1 = adversarial autoencoder (Encoder + MBV + SpeakerClassifier +
    Decoder); stage-2 = patch-GAN fine-tune. Iteration schedule and loss
    weights follow the reference solver's phases (SURVEY.md §2 "Solver").
    """

    # optimization (ref: Adam(0.5, 0.9), grad clip ~5)
    lr: float = 5e-5
    beta1: float = 0.5
    beta2: float = 0.9
    max_grad_norm: float = 5.0
    batch_size: int = 32

    # model geometry
    seg_len: int = 128             # training segment length in frames
    n_feat: int = 513              # spectrogram bins fed to the AE ("lin")
    emb_size: int = 1024           # latent width (= MBV bit-vector width)
    spk_emb_size: int = 128        # decoder speaker-embedding width
    n_speakers: int = 102
    bank_size: int = 8             # conv-bank kernel sizes 1..bank_size
    bank_channels: int = 128
    conv_channels: int = 512
    downsample: int = 8            # total temporal downsample (2**3)
    ns: float = 0.01               # leaky-relu negative slope
    enc_dp: float = 0.1            # encoder dropout
    dis_dp: float = 0.5            # classifier/discriminator dropout

    # per-speaker feature z-normalization on top of dB norm (BASELINE.json
    # pins this in the reference preprocess; applied by the loader,
    # inverted with TARGET-speaker stats at conversion)
    speaker_norm: bool = True

    # discretization (ref model.py gumbel_softmax + enc-mode switch)
    enc_mode: str = "binary"       # binary (MBV) | one_hot | continues
    gumbel_temp: float = 1.0

    # loss weights (ref solver.py; lambda_ = WGAN-GP weight)
    alpha_enc: float = 0.01        # adversarial weight on encoder
    lambda_pair: float = 0.1       # same-utterance pair unit-consistency
                                   # weight (ref dataloader.py:~1-150 pair
                                   # contract; exact ref objective unknown —
                                   # see Solver._pair_consistency). 0 = off.
    alpha_dis: float = 1.0         # classifier CE weight
    beta_dis: float = 1.0          # stage-2 D loss weight
    beta_gen: float = 1.0          # stage-2 G adversarial weight
    beta_clf: float = 1.0          # stage-2 aux speaker-CE weight
    beta_rec: float = 0.0          # stage-2 generator recon anchor (ref "[+ rec anchor]", M)
    lambda_: float = 10.0          # gradient-penalty weight

    # iteration schedule (ref solver.train phases)
    enc_pretrain_iters: int = 8000
    dis_pretrain_iters: int = 20000
    iters: int = 60000
    patch_iters: int = 30000
    lat_sched_iters: int = 50000   # adversarial-weight annealing horizon
    n_critic: int = 5              # D steps per G step in stage 2

    # bookkeeping
    log_interval: int = 100
    save_interval: int = 5000
    seed: int = 0

    @property
    def n_bins(self) -> int:
        """Latent frames per segment after temporal downsampling."""
        assert self.seg_len % self.downsample == 0
        return self.seg_len // self.downsample

    @classmethod
    def from_dict(cls, data: Mapping[str, Any], path=None) -> "Hps":
        return _load_into(cls, data, path)

    @classmethod
    def load(cls, path: str | Path) -> "Hps":
        """Load an hps JSON (ref ``Hps.load``). Accepts a flat dict or a
        dict with an ``"audio"`` sub-object (stripped; see load_configs)."""
        data = dict(json.loads(Path(path).read_text()))
        data.pop("audio", None)
        return cls.from_dict(data, path)

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2) + "\n")

    def replace(self, **kw) -> "Hps":
        return dataclasses.replace(self, **kw)


def load_configs(path: str | Path) -> tuple[Hps, AudioConfig]:
    """Load ``(Hps, AudioConfig)`` from one JSON file.

    The file may carry audio constants in an ``"audio"`` sub-object;
    otherwise AudioConfig defaults apply (the reference hard-codes them in
    preprocess.py).
    """
    data = dict(json.loads(Path(path).read_text()))
    audio = AudioConfig.from_dict(data.pop("audio", {}), path)
    return Hps.from_dict(data, path), audio


DEFAULT_HPS_PATH = Path(__file__).parent / "hps" / "zerospeech.json"
