"""PyTorch port, tensor parallelism over the mesh's ``model`` axis
(``parallel/mesh.py``) against the JAX package's rule and steps.

(a) The layout against JAX's ``param_shardings`` on ``make_mesh(data=4,
model=2)`` over conftest's 8 fake devices (tiny width, ``min_size=128``):
the same leaves sharded, each rank (d, m)'s block equal to JAX's shard on
device (d, m) bit for bit after the bridge, and ``device0_bytes`` equal to
JAX's; at flagship width with the default ``min_size``, (enc, dec) and the
whole state against JAX's counts over the same shapes.
(b) One tensor-parallel step of each kind at data=1,model=2 and at
data=2,model=2 on gloo processes against the single-process step, at
``tools/dp_parity.py``'s bars; with the planted fault (gradient blocks
swapped between the model ranks) every step misses a bar.
(c) The same steps against JAX's step on a TP-sharded state
(``shard_state(make_mesh(data=2, model=2), min_size=128)``), from the same
JAX state and draws (``slow``: a JAX mesh program for each step kind).
(d) ``train1 --mesh data=1,model=2`` under the launcher: rank 0 alone
writes, the run equals the world-1 run, and checkpoints resume across
meshes. (e) Conversion with ``model=2`` on the CPU equals one device's.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

from test_torch_distributed import _corpus, jax_case
from zerospeech_tts_tpu.config import DEFAULT_HPS_PATH as JAX_HPS_PATH
from zerospeech_tts_tpu.config import load_configs as jax_load_configs
from zerospeech_tts_tpu.parallel import batch_sharding, make_mesh
from zerospeech_tts_tpu.parallel import device0_bytes as jax_device0_bytes
from zerospeech_tts_tpu.parallel import param_shardings as jax_param_shardings
from zerospeech_tts_tpu.parallel import shard_state as jax_shard_state
from zerospeech_tts_tpu.parallel.mesh import _spec_for as jax_spec_for
from zerospeech_tts_tpu.train import Solver as JaxSolver
from zerospeech_tts_tpu_torch import cli
from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, AudioConfig, load_configs
from zerospeech_tts_tpu_torch.params import (
    MODULES, flatten, flax_from_state_dicts, init_params, make_module, state_dicts_from_flax,
)
from zerospeech_tts_tpu_torch.parallel import launch
from zerospeech_tts_tpu_torch.parallel.mesh import Mesh, device0_bytes, param_shardings, shard, spec_for
from zerospeech_tts_tpu_torch.tools import dp_parity
from zerospeech_tts_tpu_torch.train import CheckpointManager, init_state

torch.set_num_threads(1)

ONE_THREAD = dict(os.environ, OMP_NUM_THREADS="1")  # each rank's torch threads, as this process's
MIN = 128  # the JAX tests' min_size at tiny width


@pytest.fixture(scope="module")
def hps(tiny_hps):
    return tiny_hps.replace(enc_dp=0.0, dis_dp=0.0, lr=1e-3, lat_sched_iters=10, alpha_enc=0.5)


# ------------------------------------------------------ (a) the layout


def _leaves(tree, prefix: str = "") -> dict:
    """A flax tree's leaves (jax arrays kept) by "/"-joined path, without
    the ``params`` level."""
    if prefix == "" and set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if hasattr(v, "items") else {prefix + k: v})
    return out


def _flax_key(path: str) -> str:
    """A flax path of the bridge's trees ("a/b/kernel") -> its state-dict key."""
    *mods, leaf = path.split("/")
    return ".".join(mods + ["weight" if leaf == "kernel" else leaf])


def test_layout_equals_jax_shard_for_shard(tiny_hps):
    """data=4, model=2, min_size=128: per module, the leaves the port
    shards are JAX's, each rank (d, m)'s block is JAX's shard on device
    (d, m) bit for bit (bridged back to the flax layout), and the
    device0_bytes counts equal JAX's, module by module and for (enc, dec)."""
    st = jax.jit(JaxSolver(tiny_hps).init_state)(jax.random.PRNGKey(0))
    jmesh = make_mesh(data=4, model=2)
    placed = {n: jax.device_put(getattr(st, n), jax_param_shardings(getattr(st, n), jmesh, min_size=MIN))
              for n in MODULES}
    sds = state_dicts_from_flax(jax.tree.map(np.asarray, {n: getattr(st, n) for n in MODULES}))
    mods = {}
    for n in MODULES:
        mods[n] = make_module(n, tiny_hps)
        mods[n].load_state_dict(sds[n])
    axes = param_shardings(mods, 2, MIN)
    position = {dev: divmod(i, 2) for i, dev in enumerate(jmesh.devices.flat)}
    n_sharded = 0
    for n in MODULES:
        leaves = _leaves(placed[n])
        assert {_flax_key(p) for p in leaves} == set(axes[n])
        blocks = {}  # (d, m) -> this rank's blocks, bridged to the flax layout
        for d in range(4):
            for m in range(2):
                mesh = Mesh(4, 2, 2 * d + m)
                sd = {k: shard(t, axes[n][k], mesh).contiguous() for k, t in sds[n].items()}
                blocks[d, m] = flatten(flax_from_state_dicts({n: sd})[n])
        for path, arr in leaves.items():
            ax = axes[n][_flax_key(path)]
            assert (ax is None) == arr.sharding.is_fully_replicated, (n, path)
            n_sharded += ax is not None
            for sh in arr.addressable_shards:
                np.testing.assert_array_equal(blocks[position[sh.device]][path], np.asarray(sh.data),
                                              err_msg=f"{n}/{path} on {position[sh.device]}")
        assert device0_bytes(sds[n], Mesh(4, 2), MIN) == jax_device0_bytes(placed[n], jmesh), n
    assert n_sharded > 0
    assert device0_bytes({"enc": sds["enc"], "dec": sds["dec"]}, Mesh(4, 2), MIN) == \
        jax_device0_bytes((placed["enc"], placed["dec"]), jmesh)


def test_flagship_device0_bytes_equal_jax():
    """Flagship width, default min_size, model=2: (enc, dec) 58,352,644 of
    115,512,324 bytes on device 0, each module's count JAX's, and the whole
    state (parameters, Adam's two moments) JAX's TrainState less the 32
    bytes of scalars the port keeps on the host (four Adam counts, step,
    train_start, the 2 x uint32 key). JAX's counts come from its own rule
    over its state's shapes (no arrays are made)."""
    hps, _ = load_configs(DEFAULT_HPS_PATH)
    jhps, _ = jax_load_configs(JAX_HPS_PATH)
    shapes = jax.eval_shape(JaxSolver(jhps).init_state, jax.random.PRNGKey(0))

    def jax_count(tree):
        d0 = total = 0
        for leaf in jax.tree.leaves(tree):
            nbytes = leaf.size * leaf.dtype.itemsize
            total += nbytes
            d0 += nbytes if jax_spec_for("", leaf, 2) == jax.sharding.PartitionSpec() else nbytes // 2
        return d0, total

    with torch.device("meta"):
        mods = {n: make_module(n, hps) for n in MODULES}
    sds = {n: dict(m.named_parameters()) for n, m in mods.items()}
    mesh = Mesh(1, 2)
    assert device0_bytes({"enc": sds["enc"], "dec": sds["dec"]}, mesh) == (58_352_644, 115_512_324)
    assert device0_bytes({"enc": sds["enc"], "dec": sds["dec"]}, mesh) == jax_count((shapes.enc, shapes.dec))
    for n in MODULES:
        assert device0_bytes(sds[n], mesh) == jax_count(getattr(shapes, n)), n
    d0, total = device0_bytes({key: sds for key in ("params", "exp_avg", "exp_avg_sq")}, mesh)
    assert (d0 + 32, total + 32) == jax_count(shapes) == (198_794_696, 393_946_568)
    sharded = {n: sum(a is not None for a in axes.values()) for n, axes in param_shardings(mods, 2).items()}
    assert sharded == {"enc": 21, "dec": 9, "clf": 5, "dis": 4}
    assert spec_for("out.weight", (513, 512), 2) is None and spec_for("spk_embed.embedding", (102, 128), 2) is None


# ---------------------------------------------- (b) TP steps on gloo ranks


@pytest.mark.parametrize("data", [1, 2], ids=["data1_model2", "data2_model2"])
def test_tp_step_of_each_kind_equals_the_single_process_step(hps, data):
    """dp_parity's case (Adam moments warmed) on data x 2 gloo ranks: the
    ranks of a model group hold the same whole leaves and, gathered,
    blocks that make the single-process step's parameters; gradients,
    pre-clip norms and parameters within 1e-5 relative; metrics 1e-5."""
    case = dp_parity.make_case(hps, seed=1)
    out = dp_parity.run(case, world=2 * data, model=2, min_size=MIN, device="cpu", timeout=300, env=ONE_THREAD)
    assert (out["data"], out["model"], out["backend"]) == (data, 2, "gloo")
    assert set(out["report"]) == {name for name, _, _ in dp_parity.STEPS}
    assert not dp_parity.failures(out["report"], metrics_bar=1e-5)


def test_tp_parity_bars_catch_swapped_gradient_blocks(hps):
    """The planted fault (each rank steps its blocks with the next model
    rank's block of the gradient) misses the gradient bar in every step
    and the parameter bar too."""
    case = dp_parity.make_case(hps, seed=1)
    out = dp_parity.run(case, world=4, model=2, min_size=MIN, device="cpu", timeout=300, env=ONE_THREAD,
                        control=True)
    missed = dp_parity.failures(out["report"], metrics_bar=1e-5)
    for name in out["report"]:
        assert any(x.startswith(f"{name}: grad_rel_l2") for x in missed), (name, missed)
        assert any(x.startswith(f"{name}: param_rel") for x in missed), (name, missed)


# -------------------------------------------------- (c) against JAX's TP


@pytest.fixture(scope="module")
def tp(hps):
    """jax_case's steps on a data=2, model=2 gloo mesh, with results."""
    js, base, case, _ = jax_case(hps)
    out = dp_parity.run(case, world=4, model=2, min_size=MIN, device="cpu", results=True, timeout=300,
                        env=ONE_THREAD)
    return js, base, case, out


@pytest.mark.slow  # a JAX mesh program compiled for each step kind
@pytest.mark.parametrize("kind", [name for name, _, _ in dp_parity.STEPS])
def test_tp_step_of_each_kind_equals_jax_on_a_tp_mesh(hps, tp, kind):
    """The port's TP step against JAX's step on shard_state(make_mesh(data=2,
    model=2), min_size=128) from the same state and draws: metrics 1e-5
    relative, each module's gradient 1e-4 rel-L2, parameters within 2 lr."""
    h, (js, base, c, out) = hps, tp
    assert not dp_parity.failures(out["report"], metrics_bar=1e-5)
    spec = next(s for s in c["steps"] if s["name"] == kind)
    mesh = make_mesh(data=2, model=2)
    state = jax_shard_state(jax.tree.map(jnp.copy, base), mesh, min_size=MIN)
    assert any(not x.sharding.is_fully_replicated for x in jax.tree.leaves(state.enc))
    jb = jax.device_put({kk: jnp.asarray(v) for kk, v in spec["batch"].items()}, batch_sharding(mesh))
    jnew, jm = getattr(js, spec["fn"])(state, jb)
    jnew = jax.tree.map(np.asarray, jnew)
    res = out["results"][kind]["dp"]
    assert set(res["metrics"]) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(res["metrics"][k], float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    b1 = h.beta1
    for n in dp_parity.UPDATES[spec["fn"]]:
        a0, a1 = getattr(base, f"opt_{n}")[1][0], getattr(jnew, f"opt_{n}")[1][0]
        g_ref = jax.tree.map(lambda m1, m0: (np.asarray(m1) - b1 * np.asarray(m0)) / (1 - b1), a1.mu, a0.mu)
        g_ref = state_dicts_from_flax({n: g_ref})[n]
        p_ref = state_dicts_from_flax({n: getattr(jnew, n)})[n]
        num = den = 0.0
        for pname, g in res["grads"][n].items():
            num += float(((g - g_ref[pname]) ** 2).sum())
            den += float((g_ref[pname] ** 2).sum())
            assert (res["params"][n][pname] - p_ref[pname]).abs().max().item() <= 2 * h.lr + 1e-6, pname
        assert np.sqrt(num / den) <= 1e-4, (n, np.sqrt(num / den))


# ---------------------------------------------------- (d) through the CLI


def _step_file(path):
    return torch.load(path, weights_only=True)


def _assert_same_payload(a, b, exact: bool):
    """Two checkpoint payloads: the same counters, and every module and
    Adam tensor equal (bit for bit, or within 1e-6)."""
    assert (a["step"], a["train_start"]) == (b["step"], b["train_start"])
    for n in MODULES:
        assert a["modules"][n].keys() == b["modules"][n].keys()
        pairs = [(a["modules"][n][k], b["modules"][n][k]) for k in a["modules"][n]]
        for i, st in a["opts"][n]["state"].items():
            pairs += [(st[k], b["opts"][n]["state"][i][k]) for k in st]
        for x, y in pairs:
            assert x.shape == y.shape
            if exact:
                assert torch.equal(x, y), n
            else:
                torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)


def test_train1_mesh_model_2_writes_once_equals_world_1_and_resumes_across_meshes(tmp_path, tiny_hps):
    """train1 --mesh data=1,model=2 under the launcher: rank 0 alone prints
    and writes; its checkpoint loads at world 1 and equals (1e-6) a world-1
    run of the same schedule; the world-1 checkpoint resumed under TP with
    the schedule done is saved again bit for bit (each rank kept its
    blocks, the save gathered them); the TP checkpoint resumes under TP."""
    h = tiny_hps.replace(n_speakers=3, log_interval=1, save_interval=100, n_critic=1)
    _corpus(tmp_path, h)
    (tmp_path / "tiny.json").write_text(json.dumps(dataclasses.asdict(h)))
    base = ["train1", "-dataset_path", str(tmp_path / "ds"), "-index_path", str(tmp_path / "idx.json"),
            "--hps", str(tmp_path / "tiny.json"), "--device", "cpu"]
    ck_tp, ck_one = tmp_path / "ck_tp", tmp_path / "ck_one"

    def tp_run(ck, iters):
        outs = launch(["-m", "zerospeech_tts_tpu_torch", *base, "-ckpt_dir", str(ck), "--mesh", "data=1,model=2",
                       "--iters-override", iters], 2, env=ONE_THREAD, timeout=300)
        for r, (rc, _, err) in enumerate(outs):
            assert rc == 0, f"rank {r}:\n{err[-3000:]}"
        assert outs[1][1].strip() == "", outs[1][1]  # rank 1 prints nothing
        return outs[0][1]

    out0 = tp_run(ck_tp, "2")
    assert "stage-1 done at step 6" in out0
    files = sorted(str(p.relative_to(ck_tp)) for p in ck_tp.rglob("*") if p.is_file()
                   and not p.name.startswith("events.out.tfevents"))
    assert files == ["hps.json", "logs/metrics.jsonl", "step_6.pt"]
    cli.main(base + ["-ckpt_dir", str(ck_one), "--iters-override", "2"])
    _assert_same_payload(_step_file(ck_tp / "step_6.pt"), _step_file(ck_one / "step_6.pt"), exact=False)
    st = CheckpointManager(ck_tp, hps=h, read_only=True).restore(init_state(h, device="cpu"))
    assert st.step == 6 and st.shards is None

    before = _step_file(ck_one / "step_6.pt")
    out0 = tp_run(ck_one, "2")  # a world-1 checkpoint under TP: the schedule is done, the state saved again
    assert "resumed from step 6" in out0 and "schedule already complete" in out0
    _assert_same_payload(_step_file(ck_one / "step_6.pt"), before, exact=True)

    out0 = tp_run(ck_tp, "3")
    assert "resumed from step 6" in out0 and "stage-1 done at step 9" in out0
    assert sorted(p.name for p in ck_tp.glob("step_*.pt")) == ["step_6.pt", "step_9.pt"]


# ------------------------------------------------------ (e) conversion


def test_convert_mesh_model_2_equals_one_device(tiny_hps, tmp_path):
    """convert --mesh data=2,model=2 --device cpu (the model replicated
    over model, rows split over data) writes one device's units bit for
    bit and its PCM within 1 LSB."""
    from zerospeech_tts_tpu_torch.convert import read_units
    from zerospeech_tts_tpu_torch.dsp.wavio import save_wav
    from zerospeech_tts_tpu_torch.export import save_export

    h = tiny_hps.replace(n_feat=129)
    acfg = AudioConfig(n_fft=256, hop_length=64, win_length=256, n_mels=20, gl_iters=2)
    params = init_params(h, seed=0)
    save_export(tmp_path / "bundle", h, acfg, params["enc"], params["dec"], {"S01": 0, "V001": 1})
    rng = np.random.default_rng(7)
    for i, n in enumerate((3000, 5200, 4032)):
        save_wav(tmp_path / "wavs" / f"u{i}.wav", (0.5 * np.sin(2 * np.pi * (200 + 60 * i) * np.arange(n) / 16000)
                                                  + 0.01 * rng.standard_normal(n)).astype(np.float32), 16000)
    run = ["convert", "--from-export", str(tmp_path / "bundle"), "--from-wavs", str(tmp_path / "wavs"),
           "--target", "V001", "--device", "cpu"]
    cli.main(run + ["-result_dir", str(tmp_path / "one")])
    out = cli.main(run + ["-result_dir", str(tmp_path / "tp"), "--mesh", "data=2,model=2"])
    assert out["n_utterances"] == 3
    for i in range(3):
        np.testing.assert_array_equal(read_units(tmp_path / "tp" / "units" / f"u{i}.txt"),
                                      read_units(tmp_path / "one" / "units" / f"u{i}.txt"))
        a = scipy.io.wavfile.read(tmp_path / "one" / "V001" / f"u{i}.wav")[1].astype(np.int32)
        b = scipy.io.wavfile.read(tmp_path / "tp" / "V001" / f"u{i}.wav")[1].astype(np.int32)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
