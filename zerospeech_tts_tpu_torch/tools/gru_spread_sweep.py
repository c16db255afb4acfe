"""Kernel 2's step time on one CUDA card with its column-group count forced.

    python -m zerospeech_tts_tpu_torch.tools.gru_spread_sweep [NK ...] [--out FILE]

Builds one copy of ``csrc/gru.cu`` per forced column-group count NK (its
spread search, ``make_plan``, keeps that NK only; the batch groups follow
as usual) into ``build/gru_spread_sweep/``, and times each copy and the
unmodified kernel (``default``) at H=512 on batches of 1 to 128 rows,
after holding every result against ``gru_scan_plain`` (1e-4). Prints
microseconds a step per B and NK; these are the measurements the weights
of ``make_plan``'s cost were fitted to. Writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

SHAPES = ((1, 256), (2, 256), (6, 256), (16, 128), (32, 128), (64, 32), (128, 32))
FORCE_AT = "    if (p.NK != nk || 3 * p.kc > THREADS) continue;"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("nk", type=int, nargs="*", default=[16, 31, 32, 43, 52, 64, 103, 128])
    ap.add_argument("--out", default="build/gru_spread_sweep/sweep.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gru_spread_sweep needs a CUDA card")

    from zerospeech_tts_tpu_torch.ops import build, gru
    from zerospeech_tts_tpu_torch.tools.workload import card, cuda_ms

    work = Path(args.out).parent
    work.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "gru.cu").read_text()
    if FORCE_AT not in src:
        raise SystemExit("csrc/gru.cu: make_plan's loop no longer has the line this sweep patches")

    def make(nk: int) -> ctypes.CDLL:
        cu = work / f"gru_nk{nk}.cu"
        cu.write_text(src.replace(FORCE_AT, FORCE_AT + f"\n    if (nk != {nk}) continue;"))
        so = work / f"gru_nk{nk}.so"
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(proc.stderr)
        lib = ctypes.CDLL(str(so))
        lib.zs_error_string.restype = ctypes.c_char_p
        return lib

    with ThreadPoolExecutor(len(args.nk) or 1) as pool:
        libs = dict(zip(args.nk, pool.map(make, args.nk)))
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def forced(lib):
        fn = build.bind(lib, "zs_gru_scan", 7, 4)

        def run(xw, wh, bh):
            b, t, h3 = xw.shape
            ys = torch.empty(b, t, h3 // 3, device=dev)
            bar = torch.empty(32 * n_sm, dtype=torch.int32, device=dev)
            n = ctypes.c_int(0)
            err = fn(xw.data_ptr(), wh.data_ptr(), bh.data_ptr(), None, ys.data_ptr(), bar.data_ptr(),
                     ctypes.addressof(n), b, t, h3 // 3, 0, build.stream_of(xw))
            return ys if err == 0 else None
        return run

    fns = {"default": gru.gru_scan, **{f"nk{nk}": forced(lib) for nk, lib in libs.items()}}
    res = {"card": card(), "us_per_step": {}}
    for b, t in SHAPES:
        g = torch.Generator().manual_seed(0)
        xw = torch.randn(b, t, 1536, generator=g).to(dev)
        wh = (torch.randn(512, 1536, generator=g) / 512 ** 0.5).to(dev)
        bh = (0.1 * torch.randn(1536, generator=g)).to(dev)
        ref = gru.gru_scan_plain(xw, wh, bh)
        row = {}
        for name, fn in fns.items():
            out = fn(xw, wh, bh)
            if out is None:
                row[name] = None  # no spread with this NK
                continue
            err = (out - ref).abs().max().item()
            if err > 1e-4:
                raise RuntimeError(f"{name} B={b} T={t}: max |err| {err} against gru_scan_plain")
            row[name] = 1e3 * cuda_ms(lambda: fn(xw, wh, bh), 5) / t
        res["us_per_step"][f"B={b} T={t}"] = row
        print(f"B={b} T={t} us/step: " + " | ".join(
            f"{k} {'-' if v is None else f'{v:.2f}'}" for k, v in row.items()), flush=True)
    Path(args.out).write_text(json.dumps(res, indent=1) + "\n")
    return res


if __name__ == "__main__":
    main()
