"""One multi-process training step of each kind (data-parallel, and
tensor-parallel with ``--model M``) against the single-process step on the
same global batch.

    python -m zerospeech_tts_tpu_torch.tools.dp_parity [--world 2] [--model 1] [--device cuda|cpu] \
        [--backend gloo|nccl] [--local-ranks 0 0] [--seed S] [--out FILE]

The steps: ``pretrain_AE`` without and with the same-utterance pair (whose
offsets differ across the ranks' rows, so each rank has its own count of
valid frames), ``pretrain_C``, ``train``, ``patch_d`` and ``patch_g`` (the
stage-2 target draw over the global batch). Each starts from one state.
``world`` processes are launched with torchrun's variables
(``parallel.launch``) as a mesh of data = world / model x model; every
rank runs the single-process step on the global batch first (rank 0 keeps
it as the reference), recording its random draws, then the multi-process
step on its data rank's rows with its slice of those draws (``FedNoise``),
from the state placed on the mesh (``--model`` above 1: each rank keeps
its blocks of the large parameters and their moments). Rank 0 reports,
per step and updated module, the rel-L2 of its gradient (after the clip)
and of its updated parameters against the reference (both whole: blocks
gathered over the model group), the relative difference of the gradient's
norm before the clip (``Solver.grad_norms``), the parameters' largest
absolute difference, the metrics' relative differences, and whether the
ranks hold what they should bit for bit (every rank of a data group the
same parameters or blocks, every rank of a model group the same whole
leaves). ``failures`` holds a report to its bars (exit 1 when one is
missed). On a card each rank also reports its resident bytes
(``torch.cuda.memory_allocated``) of the placed state and of a world-1
state, after building and after a step of each kind, beside the
``device0_bytes`` counts (``MEMORY_KEYS``).

A case (``make_case``: seeded modules at the hps's width, with Adam
moments that are not zero, and a random batch; or one a test builds, with
JAX's draws) is handed to the ranks in a file. Device ``cuda`` with two
ranks on one card needs ``--backend gloo`` and ``--local-ranks 0 0`` (NCCL
refuses two ranks on one device). ``run(control=True)`` plants a fault:
at ``model`` 1 the gradient all_reduce without its division by the world
size (a gradient of the wrong scale); above 1, each rank stepping its
blocks with the next model rank's block of the gradient (blocks swapped).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import tempfile
from pathlib import Path

import numpy as np
import torch

from zerospeech_tts_tpu_torch.parallel.mesh import MIN_SIZE

# (name, Solver method, batch keys it takes)
STEPS = (
    ("pretrain_AE", "step_pretrain_ae", ("x", "spk")),
    ("pretrain_AE pairs", "step_pretrain_ae", ("x", "spk", "x2", "pair_dt")),
    ("pretrain_C", "step_pretrain_clf", ("x", "spk")),
    ("train", "step_train", ("x", "spk", "x2", "pair_dt")),
    ("patch_d", "step_patch_d", ("x", "spk", "x_real", "spk_real")),
    ("patch_g", "step_patch_g", ("x", "spk", "x_real", "spk_real")),
)
READINGS = ("world1_built", "world1_after_steps", "placed", "placed_after_steps")
MEMORY_KEYS = READINGS + tuple(f"{k}_requested" for k in READINGS) + ("count", "count_world1")
BAR = 1e-5  # relative, f32 summation order: updated parameters, gradients and their norms
UPDATES = {"step_pretrain_ae": ("enc", "dec"), "step_pretrain_clf": ("clf",),
           "step_train": ("clf", "enc", "dec"), "step_patch_d": ("dis",), "step_patch_g": ("dec",)}


class _Recorder:
    """A noise source that keeps a copy of every uniform it hands out."""

    def __init__(self, noise):
        self.noise, self.draws = noise, []

    def uniform(self, shape, device):
        u = self.noise.uniform(shape, device)
        self.draws.append(u.cpu().numpy())
        return u


def make_case(hps, seed: int = 0, device: str = "cpu") -> dict:
    """Seeded modules (params.init_modules) in the 'train' phase at alpha =
    alpha_enc / 2, and a random global batch of hps.batch_size rows with
    every field; no draws (each rank records them from a generator seeded
    with ``seed``). The Adam moments are not zero: one single-process
    step_train and one step_patch_d (every module's optimizer) on a
    warm-up batch, on ``device``, come first. From zero moments Adam's
    first update is ~lr sign(g), blind to the gradient's scale."""
    from zerospeech_tts_tpu_torch.train.solver import Solver, init_state

    st = init_state(hps, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    b, ds, seg = hps.batch_size, hps.downsample, hps.seg_len

    def batch():
        feats = lambda: rng.standard_normal((b, seg, hps.n_feat)).astype(np.float32)  # noqa: E731
        return {"x": feats(), "spk": rng.integers(0, hps.n_speakers, b), "x2": feats(),
                "pair_dt": ds * rng.integers(-(seg // ds) // 2, (seg // ds) // 2 + 1, b),
                "x_real": feats(), "spk_real": rng.integers(0, hps.n_speakers, b)}

    step, train_start = hps.lat_sched_iters // 2, 0
    warm = _tensors(batch(), slice(None), device)
    st.step, st.train_start = step, train_start
    for fn in ("step_train", "step_patch_d"):
        keys = next(k for _, f, k in STEPS if f == fn)
        getattr(Solver(hps), fn)(st, {k: warm[k] for k in keys})
    full = batch()
    return dict(hps=dataclasses.asdict(hps), seed=seed, state=dict(
        modules={n: m.state_dict() for n, m in st.modules.items()},
        opts={n: o.state_dict() for n, o in st.opts.items()},
        step=step, train_start=train_start),
        steps=[dict(name=name, fn=fn, batch={k: full[k] for k in keys}, draws=None) for name, fn, keys in STEPS])


def _state(case, hps, device):
    from zerospeech_tts_tpu_torch.params import MODULES, make_module
    from zerospeech_tts_tpu_torch.train.solver import TrainState

    mods = {}
    for n in MODULES:
        mods[n] = make_module(n, hps)
        mods[n].load_state_dict(case["state"]["modules"][n])
        mods[n].to(device)
    st = TrainState(hps, mods, torch.Generator(device=device))
    for n, o in st.opts.items():  # a copy: a loaded state shares the case's tensors, which Adam updates in place
        o.load_state_dict(copy.deepcopy(case["state"]["opts"][n]))
    st.step, st.train_start = case["state"]["step"], case["state"]["train_start"]
    return st


def _tensors(batch: dict, rows: slice, device) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(v)[rows]))
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def _slice_draw(d: np.ndarray, b_global: int, rows: slice) -> np.ndarray:
    """A rank's share of a draw whose leading axis is k blocks of the
    global batch (the pair's x and x2 encoded in one pass: k = 2)."""
    if d.shape[0] % b_global:
        raise ValueError(f"a draw of leading size {d.shape[0]} is not whole blocks of the batch {b_global}")
    return np.concatenate([d[j * b_global:][rows] for j in range(d.shape[0] // b_global)])


def _same_on_ranks(t: torch.Tensor, group) -> bool:
    """True when every rank of ``group`` holds ``t`` bit for bit."""
    hi, lo = t.clone(), t.clone()
    torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX, group=group)
    torch.distributed.all_reduce(lo, op=torch.distributed.ReduceOp.MIN, group=group)
    return bool(torch.equal(hi, lo))


def resident(dev: torch.device) -> tuple[int, int]:
    """The bytes of the tensors alive on ``dev``: ``memory_allocated`` and
    the allocator's ``requested_bytes``, read from an emptied cache. A
    block freed while another stream still used it (gloo and NCCL record
    their streams on a collective's tensors) leaves ``memory_allocated``
    at once but stays in ``requested_bytes`` until the allocator sees its
    stream's event done, at its next allocation or at ``empty_cache``;
    emptying the cache first releases every such block."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return (torch.cuda.memory_allocated(dev),
            torch.cuda.memory_stats(dev).get("requested_bytes.all.current", 0))


def _memory(case, hps, dev, mesh, group, data_group, model_group, min_size, rows) -> list[float]:
    """This rank's resident bytes (``MEMORY_KEYS``): a world-1 state built
    from the case, after it is built and after one step of each kind on
    the global batch; the same state placed on the mesh, after it is placed
    and after one step of each kind on its rows; each as
    ``torch.cuda.memory_allocated`` (the allocator's blocks) and as the
    bytes the tensors requested (``requested_bytes``, the blocks less
    their rounding), from an emptied cache (so no block cached by earlier
    work is handed out larger than asked); then the counts of
    ``device0_bytes`` over the whole state (params and Adam moments) on
    the mesh and at world 1."""
    import gc

    from zerospeech_tts_tpu_torch.models.layers import Noise
    from zerospeech_tts_tpu_torch.parallel.mesh import Mesh, device0_bytes, place_state, state_tree
    from zerospeech_tts_tpu_torch.train.solver import Solver

    def reading():
        gc.collect()
        return resident(dev)

    out = []
    for placed in (False, True):
        base = reading()
        st = _state(case, hps, dev)
        if placed:
            place_state(st, mesh, model_group, min_size)
            solver = Solver(hps, group=group, data_group=data_group)
        else:
            tree, solver = state_tree(st), Solver(hps)
            counts = [device0_bytes(tree, mesh, min_size)[0], device0_bytes(tree, Mesh())[0]]
            del tree
        out.append([x - b for x, b in zip(reading(), base)])
        noise = Noise(torch.Generator().manual_seed(case["seed"]))  # the same draws on the ranks of a data row
        for spec in case["steps"]:
            getattr(solver, spec["fn"])(st, _tensors(spec["batch"], rows if placed else slice(None), dev), noise=noise)
        del solver  # and its last gradient norms: the state alone is read
        out.append([x - b for x, b in zip(reading(), base)])
        del st
    return [r[0] for r in out] + [r[1] for r in out] + counts


def _worker(case_path: str, out_path: str, device: str, backend: str | None, results: bool,
            control: bool, model: int, min_size: int) -> None:
    from zerospeech_tts_tpu_torch.config import Hps
    from zerospeech_tts_tpu_torch.models.layers import FedNoise, Noise
    from zerospeech_tts_tpu_torch.parallel import distributed
    from zerospeech_tts_tpu_torch.parallel.distributed import all_gather_slices
    from zerospeech_tts_tpu_torch.parallel.mesh import (
        Mesh, ModelShards, batch_slice, replicate_state, shard, shard_state,
    )
    from zerospeech_tts_tpu_torch.train.solver import Solver

    distributed.initialize(device=device, backend=backend)
    kept = {}  # each module's gradient blocks of the tensor-parallel step, which the step frees
    set_grads = ModelShards.set_grads

    def keeping(self, n, gs, scale):
        if control:  # the planted fault: each rank steps its block with the next rank's block of the gradient
            m = self.mesh
            other = Mesh(m.data, m.model, m.d * m.model + (m.m + 1) % m.model)
            for master, g, ax in zip(self.masters[n], gs, self.axes[n]):
                master.grad = shard(g, ax, other) * scale
        else:
            set_grads(self, n, gs, scale)
        kept[n] = [mm.grad for mm in self.masters[n]]

    ModelShards.set_grads = keeping
    if control and model == 1:  # the planted fault: the gradient all_reduce without its division by the world size
        def summed(self, flat):
            torch.distributed.all_reduce(flat, group=self.group)
            return flat

        Solver._grad_mean = summed
    try:
        dev = distributed.local_device(device)
        rank, world = distributed.rank(), distributed.world()
        mesh = Mesh(world // model, model, rank)
        group = torch.distributed.group.WORLD
        data_group, model_group = distributed.mesh_groups(mesh)
        case = torch.load(case_path, weights_only=False, map_location="cpu")
        hps = Hps(**case["hps"])
        b = hps.batch_size
        rows = batch_slice(mesh.d, mesh.data, b)
        report, saved = {}, {}
        for spec in case["steps"]:
            fn, mods = spec["fn"], UPDATES[spec["fn"]]
            ref = _state(case, hps, dev)
            noise = (FedNoise(spec["draws"]) if spec["draws"] is not None
                     else _Recorder(Noise(torch.Generator().manual_seed(case["seed"]))))
            s_ref, s_dp = Solver(hps), Solver(hps, group=group, data_group=data_group)
            m_ref = getattr(s_ref, fn)(ref, _tensors(spec["batch"], slice(None), dev), noise=noise)
            draws = spec["draws"] if spec["draws"] is not None else noise.draws
            st = _state(case, hps, dev)
            if model > 1:
                shard_state(st, mesh, model_group, min_size)
            kept.clear()
            fed = FedNoise([_slice_draw(d, b, rows) for d in draws])
            m_dp = getattr(s_dp, fn)(st, _tensors(spec["batch"], rows, dev), noise=fed)
            if fed.arrays:
                raise RuntimeError(f"{spec['name']}: {len(fed.arrays)} draws not used")
            masters = {n: list(st.modules[n].parameters()) if st.shards is None else st.shards.masters[n]
                       for n in st.modules}
            # the ranks of a data group hold the same blocks; those of a model group the same whole leaves
            same = _same_on_ranks(torch.cat([p.detach().reshape(-1) for n in mods for p in masters[n]]), data_group)
            if st.shards is not None:
                same &= _same_on_ranks(torch.cat([p.detach().reshape(-1) for n in mods
                                                  for p, ax in zip(masters[n], st.shards.axes[n]) if ax is None]),
                                       model_group)
            same = torch.tensor(float(same), device=dev)  # NCCL reduces device tensors only
            torch.distributed.all_reduce(same, op=torch.distributed.ReduceOp.MIN, group=group)
            if st.shards is None:
                grads = {n: [p.grad for p in masters[n]] for n in mods}
            else:  # the blocks gathered over the model group; then the state made whole again
                grads = {n: [g if ax is None else all_gather_slices(g, ax, model_group)
                             for g, ax in zip(kept[n], st.shards.axes[n])] for n in mods}
                replicate_state(st)
            params = {n: list(st.modules[n].parameters()) for n in st.modules}
            if rank:
                continue
            r = dict(ranks_equal=bool(same), metrics_rel={}, grad_rel_l2={}, grad_norm_rel={},
                     param_max_abs={}, param_rel={}, untouched_equal=True)
            for k in m_ref:
                a, e = float(m_dp[k]), float(m_ref[k])
                r["metrics_rel"][k] = abs(a - e) / max(abs(e), 1e-6)
            for n in mods:
                refs = list(ref.modules[n].parameters())
                g_dp = torch.cat([g.reshape(-1) for g in grads[n]])
                g_ref = torch.cat([q.grad.reshape(-1) for q in refs])
                r["grad_rel_l2"][n] = (torch.linalg.norm(g_dp - g_ref) / torch.linalg.norm(g_ref)).item()
                r["grad_norm_rel"][n] = ((s_dp.grad_norms[n] - s_ref.grad_norms[n]).abs()
                                         / s_ref.grad_norms[n]).item()
                p_dp = torch.cat([p.detach().reshape(-1) for p in params[n]])
                p_ref = torch.cat([q.detach().reshape(-1) for q in refs])
                r["param_max_abs"][n] = (p_dp - p_ref).abs().max().item()
                r["param_rel"][n] = (torch.linalg.norm(p_dp - p_ref) / torch.linalg.norm(p_ref)).item()
            for n in set(st.modules) - set(mods):
                r["untouched_equal"] &= all(torch.equal(p, q) for p, q in zip(params[n], ref.modules[n].parameters()))
            report[spec["name"]] = r
            if not results:
                continue
            names = {n: [k for k, _ in st.modules[n].named_parameters()] for n in mods}
            saved[spec["name"]] = {
                "dp": dict(metrics={k: float(v) for k, v in m_dp.items()},
                           grads={n: {k: g.cpu() for k, g in zip(names[n], grads[n])} for n in mods},
                           params={n: {k: p.detach().cpu() for k, p in zip(names[n], params[n])} for n in mods}),
                "ref": dict(metrics={k: float(v) for k, v in m_ref.items()},
                            grads={n: {k: p.grad.cpu() for k, p in ref.modules[n].named_parameters()} for n in mods},
                            params={n: {k: p.detach().cpu() for k, p in ref.modules[n].named_parameters()}
                                    for n in mods})}
        ref = st = params = grads = masters = None
        kept.clear()
        ModelShards.set_grads = set_grads
        memory = None
        if dev.type == "cuda" and not control:
            mine = _memory(case, hps, dev, mesh, group, data_group, model_group, min_size, rows)
            every = distributed.all_gather_rows(torch.tensor([mine], dtype=torch.float64, device=dev), group)
            memory = [dict(zip(MEMORY_KEYS, map(int, row.tolist()))) for row in every]
        if rank == 0:
            torch.save(dict(report=report, results=saved, world=world, data=mesh.data, model=model,
                            device=str(dev), backend=torch.distributed.get_backend(group), memory=memory), out_path)
    finally:
        distributed.destroy()


def failures(report: dict, metrics_bar: float = 1e-4) -> list[str]:
    """Each bar a report misses, one line each (empty when every step met
    them all): every rank's updated parameters bit-equal, the modules
    outside the step unmoved, each updated module's parameters, gradient
    (after the clip) and gradient norm (before it) within BAR relative of
    the single-process step's, each metric within ``metrics_bar``."""
    out = []
    for name, r in report.items():
        if not r["ranks_equal"]:
            out.append(f"{name}: the ranks' updated parameters differ")
        if not r["untouched_equal"]:
            out.append(f"{name}: a module outside the step moved")
        for key, bar in (("param_rel", BAR), ("grad_rel_l2", BAR), ("grad_norm_rel", BAR),
                         ("metrics_rel", metrics_bar)):
            bad = {k: v for k, v in r[key].items() if not v <= bar}
            if bad:
                out.append(f"{name}: {key} " + " ".join(f"{k}={v:.2e}" for k, v in bad.items()) + f" (bar {bar})")
    return out


def run(case: dict, world: int = 2, device: str = "cuda", backend: str | None = None, local_ranks=None,
        timeout: float = 600.0, results: bool = False, env: dict | None = None, control: bool = False,
        model: int = 1, min_size: int = MIN_SIZE) -> dict:
    """Launch ``world`` ranks on ``case`` (``env``: their environment,
    default this process's) as a mesh of data = world / model x ``model``
    (the rule's ``min_size``); rank 0's report ({step: ...}, the world,
    mesh, device and backend, and on a card each rank's ``memory``), and
    with ``results`` each step's metrics, gradients and updated parameters
    (whole), multi-process ("dp") and reference ("ref"), on the CPU.
    ``control`` plants the fault of the module's docstring in the
    multi-process steps. Raises when a rank fails."""
    from zerospeech_tts_tpu_torch.parallel.distributed import launch

    with tempfile.TemporaryDirectory(prefix="dp_parity") as tmp:
        case_path, out_path = str(Path(tmp) / "case.pt"), str(Path(tmp) / "out.pt")
        torch.save(case, case_path)
        outs = launch(["-m", "zerospeech_tts_tpu_torch.tools.dp_parity", "--worker", case_path, out_path,
                       "--device", device, "--model", str(model), "--min-size", str(min_size)]
                      + (["--backend", backend] if backend else [])
                      + (["--results"] if results else []) + (["--control"] if control else []),
                      world, env=env, local_ranks=local_ranks, timeout=timeout)
        for r, (rc, _, err) in enumerate(outs):
            if rc:
                raise RuntimeError(f"dp_parity rank {r} exited {rc}:\n{err[-3000:]}")
        out = torch.load(out_path, weights_only=False)
    if not results:
        del out["results"]  # empty: the ranks kept none
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--model", type=int, default=1, help="the mesh's model axis (world = data x model)")
    ap.add_argument("--min-size", type=int, default=MIN_SIZE, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, help="default: NCCL on cuda, gloo on cpu")
    ap.add_argument("--local-ranks", type=int, nargs="+", default=None,
                    help="each rank's LOCAL_RANK (its card); 0 0 puts two ranks on card 0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/dp_parity/parity.json")
    ap.add_argument("--worker", nargs=2, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--results", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(*args.worker, args.device, args.backend, args.results, args.control, args.model, args.min_size)
        return {}
    from zerospeech_tts_tpu_torch.config import DEFAULT_HPS_PATH, load_configs

    hps, _ = load_configs(DEFAULT_HPS_PATH)
    out = run(make_case(hps, args.seed, args.device), args.world, args.device, args.backend, args.local_ranks,
              model=args.model)
    for name, r in out["report"].items():
        print(f"{name}: grad rel-L2 " + " ".join(f"{n}={v:.2e}" for n, v in r["grad_rel_l2"].items())
              + "; norm rel " + " ".join(f"{n}={v:.2e}" for n, v in r["grad_norm_rel"].items())
              + "; params max |diff| " + " ".join(f"{n}={v:.2e}" for n, v in r["param_max_abs"].items())
              + " rel " + " ".join(f"{n}={v:.2e}" for n, v in r["param_rel"].items())
              + f"; metrics rel <= {max(r['metrics_rel'].values()):.2e}; ranks equal {r['ranks_equal']}",
              flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1) + "\n")
    missed = failures(out["report"])
    for line in missed:
        print("MISSED " + line, flush=True)
    if missed:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
