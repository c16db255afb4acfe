"""PyTorch port, the challenge archive: an archive built by the port
validates under the JAX package's validator with the same report and the
reverse; content problems are reported alike; the ``submission`` and
``eval`` verbs refuse what the JAX verbs refuse, and ``submission`` exits
with 1 when the archive is not ok."""

import io
import json
import zipfile

import numpy as np
import pytest
from scipy.io import wavfile

from zerospeech_tts_tpu import cli as jax_cli
from zerospeech_tts_tpu import submission as jax_sub
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch import submission as port_sub


def _mk_result_dir(root, utts=("u1", "u2"), target="V001", width=8, sr=16000, seed=0):
    """A convert result dir: units/<utt>.txt and <target>/<utt>.wav."""
    (root / "units").mkdir(parents=True)
    (root / target).mkdir()
    rng = np.random.default_rng(seed)
    for u in utts:
        np.savetxt(root / "units" / f"{u}.txt", rng.integers(0, 2, (int(rng.integers(5, 20)), width)),
                   fmt="%d")
        n = int(rng.integers(sr // 2, sr))
        tone = (8000 * np.sin(2 * np.pi * 440 * np.arange(n) / sr)).astype(np.int16)
        wavfile.write(root / target / f"{u}.wav", sr, tone)
    return root


@pytest.fixture
def langs(tmp_path):
    return {"english": (_mk_result_dir(tmp_path / "en", utts=("a", "b", "c")), "V001"),
            "surprise": (_mk_result_dir(tmp_path / "su", utts=("s1",), width=4, seed=1), "V001")}


def test_port_archive_validates_under_jax(tmp_path, langs):
    meta = {"author": "t", "system description": "x"}
    rep_p = port_sub.build_submission(tmp_path / "p.zip", langs, metadata=meta)
    rep_j = jax_sub.build_submission(tmp_path / "j.zip", langs, metadata=meta)
    assert rep_p["ok"] and rep_p == rep_j
    for zp in (tmp_path / "p.zip", tmp_path / "j.zip"):  # each validator on each archive
        assert port_sub.validate_submission(zp, frame_seconds=0.064) == \
            jax_sub.validate_submission(zp, frame_seconds=0.064)
    with zipfile.ZipFile(tmp_path / "p.zip") as zp, zipfile.ZipFile(tmp_path / "j.zip") as zj:
        assert sorted(zp.namelist()) == sorted(zj.namelist())
        assert zp.read("metadata.yaml") == zj.read("metadata.yaml")


def test_content_problems_reported_alike(tmp_path):
    zp = tmp_path / "bad.zip"
    buf = io.BytesIO()
    wavfile.write(buf, 8000, np.zeros(800, np.int16))  # wrong sr and silent
    with zipfile.ZipFile(zp, "w") as zf:
        zf.writestr("english/test/a.txt", "0 1 2\n")  # non-binary
        zf.writestr("english/test/a.wav", buf.getvalue())
        zf.writestr("english/test/b.txt", "0 1\n1 0\n")  # no wav
        zf.writestr("english/test/c.txt", "0 1 1\n")  # another width
        zf.writestr("english/test/c.wav", b"RIFF")  # unreadable
        zf.writestr("english/stray.bin", "x")
    rep = port_sub.validate_submission(zp)
    assert not rep["ok"] and rep == jax_sub.validate_submission(zp)


def test_metadata_equals_jax():
    for over in ({"author": "a: b", "extra": 3, "system description": "s"},
                 {"system description": "", "open source": False}):
        assert port_sub.render_metadata(over) == jax_sub.render_metadata(over)


def test_cli_submission_builds_validates_and_fails(tmp_path, langs, capsys):
    res = str(langs["english"][0])
    rep = cli.main(["submission", "--lang", f"english={res}:V001", "-o", str(tmp_path / "s.zip"),
                    "--author", "t", "--parallel-data"])
    assert rep["ok"] and rep["archive"] == str(tmp_path / "s.zip")
    with zipfile.ZipFile(tmp_path / "s.zip") as zf:
        meta = zf.read("metadata.yaml").decode()
    assert "author: t" in meta and "system uses parallel data: true" in meta
    capsys.readouterr()
    assert cli.main(["submission", "--validate", str(tmp_path / "s.zip")])["ok"]
    port_out = json.loads(capsys.readouterr().out)
    jax_cli.main(["submission", "--validate", str(tmp_path / "s.zip")])
    assert port_out == json.loads(capsys.readouterr().out)
    with zipfile.ZipFile(tmp_path / "bad.zip", "w") as zf:
        zf.writestr("english/test/a.txt", "0 1\n")
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as e:
            main(["submission", "--validate", str(tmp_path / "bad.zip")])
        assert e.value.code == 1


@pytest.mark.parametrize("argv, message", [
    (["submission"], "pass --lang NAME=RESULT_DIR:TARGET"),
    (["submission", "--lang", "english"], "bad --lang spec"),
    (["submission", "--lang", "english=dir"], "bad --lang spec"),
    (["eval"], "nothing to evaluate"),
    (["eval", "--abx", "items.txt"], "--abx needs --units DIR"),
    (["eval", "--recon"], "--recon/--stability need -dataset_path and -ckpt_dir"),
    (["eval", "--stability", "-dataset_path", "ds"], "need -dataset_path and -ckpt_dir"),
])
def test_cli_refusals_match_jax(argv, message):
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit, match=message):
            main(argv)
