"""Evaluation of the challenge metrics the port's outputs feed (port of
``zerospeech_tts_tpu/eval.py``; the numpy half is a copy).

* **Unit bitrate** — the official ZR19 bitrate of a set of dumped unit
  files: B = n_frames * H(symbol) / total_duration_seconds, where symbols
  are whole unit vectors and H is the empirical entropy over the corpus.
* **Unit statistics** — active-bit fraction and per-dimension usage
  (collapse diagnostics).
* **ABX** — DTW/Hamming ABX discriminability over unit snippets, with the
  official aggregation hierarchy (triple scores -> speaker-context cells
  -> ordered class pairs -> symmetrized pairs -> headline).
* **Unit stability** — agreement of units under a one-stride window
  shift, and **reconstruction L1** of decode(encode(x), speaker) on
  sampled segments: the model half, run on the device of the train state
  (the hand-written kernels on a CUDA device, their plain versions on the
  CPU). Both read the port's corpus directory in (speaker, utterance)
  name order, the JAX package's h5 order, so one seed draws the same
  utterances and segments.
"""

from __future__ import annotations

import math
from collections import Counter
from pathlib import Path

import numpy as np
import torch


def load_unit_files(units_dir: str | Path) -> list[np.ndarray]:
    from zerospeech_tts_tpu_torch.convert import read_units

    files = sorted(Path(units_dir).glob("*.txt"))
    if not files:
        raise ValueError(f"no unit files in {units_dir}")
    return [read_units(fp) for fp in files]


def unit_bitrate(units_dir: str | Path, frame_seconds: float, units=None) -> dict:
    """Official-style bitrate over all unit files in a directory.

    frame_seconds: duration of one latent frame (hop * downsample / sr;
    0.1 s for the default 200-hop x8-downsample 16 kHz config).
    """
    units = units if units is not None else load_unit_files(units_dir)
    counts: Counter = Counter()
    n_frames = 0
    for u in units:
        n_frames += u.shape[0]
        for row in u:
            counts[row.tobytes()] += 1
    total = sum(counts.values())
    entropy = -sum((c / total) * math.log2(c / total) for c in counts.values())
    duration = n_frames * frame_seconds
    return {
        "n_utterances": len(units),
        "n_frames": n_frames,
        "n_symbols": len(counts),
        "symbol_entropy_bits": round(entropy, 4),
        "duration_seconds": round(duration, 2),
        "bitrate_bits_per_second": round(n_frames * entropy / duration, 2) if duration else 0.0,
    }


def unit_stats(units_dir: str | Path, units=None) -> dict:
    """Collapse diagnostics over dumped units."""
    rows = units if units is not None else load_unit_files(units_dir)
    u = np.concatenate(rows, axis=0)
    per_dim = u.mean(axis=0)
    return {
        "active_fraction": round(float(u.mean()), 4),
        "dead_dims": int(np.sum((per_dim < 1e-3) | (per_dim > 1 - 1e-3))),
        "n_dims": int(u.shape[1]),
    }


def dtw_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Path-normalized DTW distance between two unit sequences [Ta, D],
    [Tb, D] with mean-Hamming frame distance (the natural metric for MBV
    bit vectors; matches the challenge evaluator's frame-DTW structure).

    The DP is swept along ANTI-DIAGONALS: every cell on a diagonal depends
    only on the previous two diagonals (up/left on k-1, diagonal on k-2),
    so each wavefront is one vectorized numpy step — O(Ta+Tb) python
    iterations instead of the O(Ta*Tb) scalar loop, which at real
    item-file scale (thousands of triples) is the difference between
    seconds and hours. Tie-break priority matches the scalar reference:
    diagonal, then up, then left (np.argmin returns the first minimum)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ta, tb = a.shape[0], b.shape[0]
    dim = a.shape[1]
    # frame-distance matrix: mean |bit difference|. For 0/1 unit vectors
    # (the MBV case) |a-b| summed over bits is the Hamming distance,
    # which factors into ONE matmul: H(i,j) = |a_i| + |b_j| - 2 a_i.b_j —
    # this matrix, not the DP, dominated the profile (T*T*D broadcast).
    if ((a == 0) | (a == 1)).all() and ((b == 0) | (b == 1)).all():
        d = (
            a.sum(axis=1)[:, None] + b.sum(axis=1)[None, :] - 2.0 * (a @ b.T)
        ).astype(np.float64) / dim
        np.maximum(d, 0.0, out=d)  # float dot rounding must not go negative
    else:
        d = np.abs(a[:, None, :] - b[None, :, :]).mean(axis=2).astype(np.float64)

    if (ta + 1) * (tb + 1) <= 1024:
        # tiny grids (typical phone-snippet ABX items): the scalar DP beats
        # the per-diagonal numpy call overhead
        return _dtw_dp_scalar(d, ta, tb)

    inf = np.inf

    def lo(k: int) -> int:
        return max(0, k - tb)

    # diagonal k holds acc-grid cells (i, k-i), i in [lo(k), min(ta, k)];
    # boundary cells (i==0 or j==0) are inf except acc[0,0]=0
    acc_p2 = np.array([0.0])                      # k = 0: just (0, 0)
    st_p2 = np.array([0], np.int64)
    n1 = min(ta, 1) - lo(1) + 1
    acc_p1 = np.full(n1, inf)                     # k = 1: all boundary
    st_p1 = np.zeros(n1, np.int64)
    for k in range(2, ta + tb + 1):
        i_arr = np.arange(lo(k), min(ta, k) + 1)
        j_arr = k - i_arr
        acc_k = np.full(len(i_arr), inf)
        st_k = np.zeros(len(i_arr), np.int64)
        interior = (i_arr >= 1) & (j_arr >= 1)
        if interior.any():
            ii, jj = i_arr[interior], j_arr[interior]
            l1, l2 = lo(k - 1), lo(k - 2)
            cand = np.stack(
                [acc_p2[ii - 1 - l2], acc_p1[ii - 1 - l1], acc_p1[ii - l1]]
            )  # [diag, up, left]
            scand = (
                np.stack([st_p2[ii - 1 - l2], st_p1[ii - 1 - l1], st_p1[ii - l1]]) + 1
            )
            choice = np.argmin(cand, axis=0)
            r = np.arange(cand.shape[1])
            acc_k[interior] = d[ii - 1, jj - 1] + cand[choice, r]
            st_k[interior] = scand[choice, r]
        acc_p2, st_p2, acc_p1, st_p1 = acc_p1, st_p1, acc_k, st_k
    # the last diagonal (k = ta+tb) is the single cell (ta, tb)
    return float(acc_p1[-1] / max(int(st_p1[-1]), 1))


def _dtw_dp_scalar(d: np.ndarray, ta: int, tb: int) -> float:
    """Scalar DP over a precomputed distance matrix (same recurrence and
    tie-break as the wavefront sweep; used for tiny grids)."""
    acc = np.full((ta + 1, tb + 1), np.inf)
    acc[0, 0] = 0.0
    steps = np.zeros((ta + 1, tb + 1), np.int32)
    for i in range(1, ta + 1):
        for j in range(1, tb + 1):
            best = min(acc[i - 1][j], acc[i][j - 1], acc[i - 1][j - 1])
            if best == acc[i - 1][j - 1]:
                steps[i, j] = steps[i - 1, j - 1] + 1
            elif best == acc[i - 1][j]:
                steps[i, j] = steps[i - 1, j] + 1
            else:
                steps[i, j] = steps[i, j - 1] + 1
            acc[i][j] = d[i - 1, j - 1] + best
    return float(acc[ta, tb] / max(int(steps[ta, tb]), 1))


def _dtw_many(pairs: list[tuple[np.ndarray, np.ndarray]]) -> np.ndarray:
    """Path-normalized DTW for a LIST of (u, v) sequence pairs.

    Pairs with a small DP grid (the ABX phone-snippet regime: 4-12 latent
    frames) are grouped by (ta, tb, dim) shape; each group computes its
    frame-distance matrices with ONE batched matmul (the binary Hamming
    factorization from :func:`dtw_distance`) and sweeps the DP vectorized
    over the whole group — ta*tb numpy steps per GROUP instead of a
    Python DP per pair, which at item-file scale (~1e6 sampled pairs,
    tools/abx_bench.py) is the difference between tens of seconds and
    ~7 minutes. Large or non-binary pairs fall back to
    :func:`dtw_distance` one by one. Recurrence and tie-break priority
    (diagonal, up, left) match ``_dtw_dp_scalar`` bit for bit: the
    distance values are exact integers/dim either way, so equality
    comparisons agree between the batched and scalar paths."""
    out = np.empty(len(pairs))
    groups: dict[tuple, list[int]] = {}
    for n, (u, v) in enumerate(pairs):
        ta, tb = u.shape[0], v.shape[0]
        # binary-ness is decided PER PAIR, before grouping: one non-binary
        # pair sharing a shape group with binary pairs would otherwise
        # push the whole group onto the float abs-mean path, whose values
        # differ from the Hamming-matmul path in the last ulps — and ABX
        # awards tie credit via exact equality, so the two paths must
        # never mix within what dtw_distance would compute
        u_arr, v_arr = np.asarray(u), np.asarray(v)
        binary = ((u_arr == 0) | (u_arr == 1)).all() and ((v_arr == 0) | (v_arr == 1)).all()
        if binary and (ta + 1) * (tb + 1) <= 1024:
            groups.setdefault((ta, tb, u_arr.shape[1]), []).append(n)
        else:
            # large grids AND non-binary pairs fall back to the per-pair
            # path, exactly as dtw_distance would route them
            out[n] = dtw_distance(u, v)
    for (ta, tb, dim), idxs in groups.items():
        a = np.stack([np.asarray(pairs[n][0], np.float32) for n in idxs])
        b = np.stack([np.asarray(pairs[n][1], np.float32) for n in idxs])
        d = (
            a.sum(axis=2)[:, :, None]
            + b.sum(axis=2)[:, None, :]
            - 2.0 * np.einsum("ntd,nsd->nts", a, b)
        ).astype(np.float64) / dim
        np.maximum(d, 0.0, out=d)
        n_g = len(idxs)
        acc = np.full((n_g, ta + 1, tb + 1), np.inf)
        acc[:, 0, 0] = 0.0
        steps = np.zeros((n_g, ta + 1, tb + 1), np.int32)
        for i in range(1, ta + 1):
            for j in range(1, tb + 1):
                c_diag = acc[:, i - 1, j - 1]
                c_up = acc[:, i - 1, j]
                c_left = acc[:, i, j - 1]
                best = np.minimum(np.minimum(c_diag, c_up), c_left)
                steps[:, i, j] = 1 + np.where(
                    best == c_diag,
                    steps[:, i - 1, j - 1],
                    np.where(best == c_up, steps[:, i - 1, j], steps[:, i, j - 1]),
                )
                acc[:, i, j] = d[:, i - 1, j - 1] + best
        out[np.asarray(idxs)] = acc[:, ta, tb] / np.maximum(steps[:, ta, tb], 1)
    return out


def _cell_score_loop(a_pool, b_pool, x_pool, x_is_a_pool, dist) -> float | None:
    """Scalar-loop triple scoring — the oracle the vectorized path is
    tested against (tests/test_torch_eval.py); O(#a·#b·#x) Python iterations."""
    scores = []
    for xi, x in enumerate(x_pool):
        for ai, a in enumerate(a_pool):
            if x_is_a_pool and ai == xi:
                continue  # a != x when both draw from the same pool
            for b in b_pool:
                da, db = dist(x, a), dist(x, b)
                scores.append(1.0 if da < db else (0.5 if da == db else 0.0))
    return float(np.mean(scores)) if scores else None


def abx_discriminability(
    items: list[dict],
    across_speaker: bool = False,
    max_triples_per_cell: int | None = None,
    seed: int = 0,
) -> dict:
    """ABX discriminability over discrete-unit snippets (the ZR19
    challenge's primary unit-quality metric; the reference delegates it to
    the external eval kit — SURVEY.md §4 — this is a self-contained
    reimplementation with the official aggregation HIERARCHY).

    items: [{"cls": phone/category label, "spk": speaker, "units": [T, D]}]

    Triple scoring: for a triple (a of class cA, b of class cB, x of class
    cA, a != x): 1 if DTW(x, a) < DTW(x, b), 0.5 on ties, else 0.
    Within-speaker: a, b, x all share one speaker. Across-speaker: a and b
    share a speaker, x comes from one OTHER speaker (each (s_ab, s_x) pair
    is its own context cell, as in the official evaluator — not a pooled
    draw over all other speakers, which would weight contexts by pool
    size).

    Aggregation matches the ZR19 evaluator's hierarchy: triple scores
    average within each (ordered class pair, speaker context) cell; cells
    average (uniform weight) to an ordered-pair score; the two orders of a
    class pair symmetrize; unordered pairs average to the headline number.
    (The official kit has one extra level — triphone context — which
    collapses here because an item carries a single class label.)
    1.0 = perfectly discriminable units, 0.5 = chance; ``abx_error`` is
    the 1-abx error rate the challenge leaderboard reports.

    max_triples_per_cell: optional cap for real item-file scale (ZR19
    English is tens of thousands of items -> millions of triples per
    run). Cells whose full triple count exceeds the cap score a uniform
    random sample of ``max_triples_per_cell`` triples instead (seeded);
    DTW distances are computed only for sampled pairs, so the cap bounds
    both the scoring AND the distance work. Cells under the cap are exact.
    Scoring itself is vectorized: the per-cell DTW distance matrices (or
    sampled distance vectors) feed one broadcast compare instead of a
    Python triple loop (oracle equality with the scalar loop is tested in
    tests/test_torch_eval.py; runtime at ~1e4-item scale recorded by
    tools/abx_bench.py, on the host)."""
    from collections import defaultdict
    from itertools import product

    by = defaultdict(list)
    for it in items:
        by[(it["cls"], it["spk"])].append(np.asarray(it["units"]))
    classes = sorted({c for c, _ in by})
    speakers = sorted({s for _, s in by})
    rng = np.random.default_rng(seed)

    # Scoring runs in three phases so that EVERY DTW distance in the run
    # goes through one shape-grouped vectorized sweep (_dtw_many). The
    # earlier per-cell batching was still Python-bound at item-file scale:
    # a capped cell needs <=2*cap distances spread over ~80 (ta, tb)
    # length combinations, so each vectorized DP ran on ~5 pairs and the
    # sweep overhead dominated (profiled: 150 of 175 s in _dtw_many at
    # 3e3 items). Pooling the ~1e6 pairs of a 1e4-item run first makes
    # every shape group thousands of pairs wide.

    # phase 0: cells in the official iteration order — also the RNG
    # consumption order for sampled cells, kept stable for reproducibility
    cell_list = []  # (ordered-pair key, a_pool, b_pool, x_pool, x_is_a_pool)
    for ca, cb in product(classes, classes):
        if ca == cb:
            continue
        for s in speakers:
            a_pool, b_pool = by.get((ca, s), []), by.get((cb, s), [])
            if not a_pool or not b_pool:
                continue
            if across_speaker:
                for s2 in speakers:
                    if s2 == s:
                        continue
                    cell_list.append(((ca, cb), a_pool, b_pool, by.get((ca, s2), []), False))
            else:
                if len(a_pool) < 2:
                    continue
                cell_list.append(((ca, cb), a_pool, b_pool, a_pool, True))

    # phase 1: per-cell triple plans (sampling happens here) + the global
    # deduplicated pair set
    need: dict[tuple, tuple] = {}

    def reserve(xs, ys):
        for u, v in zip(xs, ys):
            k = (id(u), id(v))
            if k not in need and (id(v), id(u)) not in need:
                need[k] = (u, v)

    plans = []  # ("sampled", xi, ai, bi) index triples | ("exact",) | None
    for _key, a_pool, b_pool, x_pool, x_is_a_pool in cell_list:
        na, nb, nx = len(a_pool), len(b_pool), len(x_pool)
        # when x and a draw from one pool, a != x removes one a per x
        na_eff = na - 1 if x_is_a_pool else na
        n_triples = nx * na_eff * nb
        if n_triples <= 0:
            plans.append(None)
            continue
        if max_triples_per_cell is not None and n_triples > max_triples_per_cell:
            # sampled cell: decode flat triple indices (x, a_eff, b) and
            # reserve only the sampled pairs' distances
            flat = rng.choice(n_triples, size=max_triples_per_cell, replace=False)
            xi, rem = flat // (na_eff * nb), flat % (na_eff * nb)
            ae, bi = rem // nb, rem % nb
            # a_eff skips the x slot when the pools coincide
            ai = ae + (ae >= xi) if x_is_a_pool else ae
            reserve((x_pool[x] for x in xi), (a_pool[a] for a in ai))
            reserve((x_pool[x] for x in xi), (b_pool[b] for b in bi))
            plans.append(("sampled", xi, ai, bi))
        else:
            # exact cell: the full [nx, na] / [nx, nb] distance grids
            # (a == x pairs masked out at scoring time)
            for x in x_pool:
                reserve((x for _ in a_pool), a_pool)
                reserve((x for _ in b_pool), b_pool)
            plans.append(("exact",))

    # phase 2: ONE vectorized DTW sweep over every distinct pair
    dcache: dict = {}
    if need:
        vals = _dtw_many(list(need.values()))
        for ((ku, kv), _pair), val in zip(need.items(), vals):
            dcache[(ku, kv)] = dcache[(kv, ku)] = float(val)

    # phase 3: score cells from the cache
    pair_cells: dict = defaultdict(list)  # ordered (cA, cB) -> cell scores
    for (key, a_pool, b_pool, x_pool, x_is_a_pool), plan in zip(cell_list, plans):
        if plan is None:
            continue
        if plan[0] == "sampled":  # parallel index triples
            _, xi, ai, bi = plan
            da = np.array([dcache[(id(x_pool[x]), id(a_pool[a]))] for x, a in zip(xi, ai)])
            db = np.array([dcache[(id(x_pool[x]), id(b_pool[b]))] for x, b in zip(xi, bi)])
            sc = float(np.mean((da < db) + 0.5 * (da == db)))
        else:  # exact cell: full grids, one broadcast compare per triple
            dxa = np.array(
                [[dcache[(id(x), id(a))] for a in a_pool] for x in x_pool]
            )
            dxb = np.array(
                [[dcache[(id(x), id(b))] for b in b_pool] for x in x_pool]
            )
            s3 = (dxa[:, :, None] < dxb[:, None, :]) + 0.5 * (
                dxa[:, :, None] == dxb[:, None, :]
            )
            if x_is_a_pool:
                valid = ~np.eye(len(x_pool), dtype=bool)  # [nx, na] drop a == x
                sc = float(s3[valid].mean())
            else:
                sc = float(s3.mean())
        pair_cells[key].append(sc)

    ordered = {p: float(np.mean(cells)) for p, cells in pair_cells.items()}
    sym: dict = defaultdict(list)  # unordered pair -> its 1-2 ordered scores
    for (ca, cb), v in ordered.items():
        sym[tuple(sorted((ca, cb)))].append(v)
    pair_scores = [float(np.mean(v)) for v in sym.values()]
    abx = float(np.mean(pair_scores)) if pair_scores else float("nan")
    return {
        "abx": round(abx, 4),
        "abx_error": round(1.0 - abx, 4) if pair_scores else float("nan"),
        "n_class_pairs": len(pair_scores),
        "n_contexts": sum(len(c) for c in pair_cells.values()),
        "n_classes": len(classes),
        "mode": "across-speaker" if across_speaker else "within-speaker",
    }


def load_abx_items(item_file: str | Path, units_dir: str | Path) -> list[dict]:
    """Item file: whitespace-separated ``utt start end cls spk`` per line
    (frame indices in LATENT frames; '#' comments allowed), referencing
    unit files ``<units_dir>/<utt>.txt``."""
    from zerospeech_tts_tpu_torch.convert import read_units

    units_dir = Path(units_dir)
    cache: dict = {}
    items = []
    for ln in Path(item_file).read_text().splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        utt, t0, t1, cls, spk = ln.split()[:5]
        if utt not in cache:
            cache[utt] = read_units(units_dir / f"{utt}.txt")
        seg = cache[utt][int(t0) : int(t1)]
        if seg.shape[0] >= 1:
            items.append({"cls": cls, "spk": spk, "units": seg})
    if not items:
        raise ValueError(f"no usable items in {item_file}")
    return items


def _pool(dataset_path, split: str, feat: str):
    """(arena, [(speaker, utterance, start, length)]) of a corpus split in
    (speaker, utterance) name order."""
    from zerospeech_tts_tpu_torch.data.corpus import load_split

    arena, index = load_split(dataset_path, split, feat)
    rows = sorted(zip(index["speakers"], index["names"], index["starts"], index["lengths"]))
    return arena, rows


def _stats(dataset_path, hps, feat: str):
    if not hps.speaker_norm:
        return None
    from zerospeech_tts_tpu_torch.data.speaker_norm import SpeakerStats

    return SpeakerStats.load_corpus(dataset_path, feat)


@torch.inference_mode()
def unit_stability(
    state, dataset_path: str | Path, hps, feat: str = "lin",
    split: str = "train", n_utts: int = 16, seed: int = 0,
) -> dict:
    """Window-placement stability of the discrete units: each utterance
    encoded as-is and shifted by one downsample stride (the first
    hps.downsample frames dropped); a placement-invariant encoder gives
    shifted units[j] == original units[j+1]. Mean bit agreement on the
    overlap, with the converter's length-masked encoding (256-frame
    buckets)."""
    from zerospeech_tts_tpu_torch.models import unit_bits

    stats = _stats(dataset_path, hps, feat)
    ds = hps.downsample
    rng = np.random.default_rng(seed)
    arena, rows = _pool(dataset_path, split, feat)
    pool = [r for r in rows if r[3] >= 4 * ds]
    if not pool:
        raise ValueError("no utterances long enough for stability eval")
    feats = []
    for i in rng.choice(len(pool), size=min(n_utts, len(pool)), replace=False):
        spk, _, start, length = pool[i]
        arr = np.asarray(arena[start : start + length])
        if stats is not None:
            arr = stats.normalize(arr, spk)
        feats.append(arr)
    enc, dev = state.enc, state.device

    def encode(arr):  # pad to a 256-frame bucket, as the JAX package does
        t = arr.shape[0]
        tb = -(-t // 256) * 256
        if 0 < tb - t < 4:  # the masked encoder's min-pad precondition
            tb += 256
        x = torch.from_numpy(np.pad(arr, ((0, tb - t), (0, 0))).astype(np.float32)).to(dev)
        lengths = torch.tensor([t], dtype=torch.int32, device=dev)
        return unit_bits(enc(x[None], lengths=lengths), hps.enc_mode)[0].cpu().numpy()[: t // ds]

    agree, n_bits = 0.0, 0
    for arr in feats:
        t = (arr.shape[0] // ds) * ds  # whole latent frames only
        ua = encode(arr[:t])
        ub = encode(arr[ds:t])
        k = min(ua.shape[0] - 1, ub.shape[0])
        if k <= 0:
            continue
        agree += float((ua[1 : k + 1] == ub[:k]).sum())
        n_bits += k * ua.shape[1]
    return {
        "unit_stability": round(agree / max(n_bits, 1), 4),
        "n_utterances": len(feats),
        "shift_frames": ds,
        "feat": feat,
        "split": split,
    }


@torch.inference_mode()
def reconstruction_l1(
    state, dataset_path: str | Path, hps, feat: str = "lin",
    split: str = "train", n_segments: int = 64, seed: int = 0,
) -> dict:
    """decode(encode(x), true speaker) L1 on seg_len segments drawn from
    the split, with deterministic units (``discretize`` without noise) —
    the reconstruction gate."""
    from zerospeech_tts_tpu_torch.data.corpus import load_speaker_map
    from zerospeech_tts_tpu_torch.models import discretize

    stats = _stats(dataset_path, hps, feat)
    speakers = load_speaker_map(dataset_path)
    rng = np.random.default_rng(seed)
    arena, rows = _pool(dataset_path, split, feat)
    pool = [r for r in rows if r[3] >= hps.seg_len]
    if not pool:
        raise ValueError("no segments long enough for reconstruction eval")
    segs, spks = [], []
    for i in rng.integers(0, len(pool), n_segments):
        spk, _, start, t = pool[i]
        t0 = int(rng.integers(0, t - hps.seg_len + 1))
        seg = np.asarray(arena[start + t0 : start + t0 + hps.seg_len])
        if stats is not None:
            seg = stats.normalize(seg, spk)  # the model's training space
        segs.append(seg)
        spks.append(speakers[spk])
    dev = state.device
    x = torch.from_numpy(np.stack(segs).astype(np.float32)).to(dev)
    spk = torch.tensor(spks, dtype=torch.int64, device=dev)
    z = discretize(state.enc(x), hps.enc_mode, hps.gumbel_temp, None)
    l1 = float((state.dec(z, spk) - x).abs().mean())
    return {"recon_l1": round(l1, 6), "n_segments": n_segments, "feat": feat, "split": split}
