"""Environment check of the port (the JAX package's `cli/verify_setup.py`,
reference pore-detection/verify_setup.py), for the card: devices, imports,
the native host library, the CUDA kernels, the dataset, and a tiny Sinkhorn
on the device. One PASS / FAIL line per check; exits 1 on any FAIL.

    python -m fpmatch_tpu_torch.cli.verify_setup [--data-root DIR]
    python -m fpmatch_tpu_torch.cli.verify_setup --device cpu   # off the card

`kernels` builds every source under `kernels/csrc/` with nvcc and launches
K5 (`kernels.inoculate`: x + 1) once in each library, checked bit for bit;
on `--device cpu` it runs K5's plain version only.
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Check the port's environment")
    ap.add_argument("--data-root", default="dataset/Synthetic")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; without a GPU the devices check "
                         "fails) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    dev = torch.device(args.device)
    checks = []

    def check(name, fn):
        try:
            checks.append((name, True, fn()))
        except Exception as e:  # noqa: BLE001 — report every check, then exit 1
            checks.append((name, False, f"{type(e).__name__}: {e}"))

    def _devices():
        from .. import resolve_device

        resolve_device(dev)
        if dev.type != "cuda":
            return (f"{dev} (torch.cuda.is_available() = "
                    f"{torch.cuda.is_available()})")
        return (f"{torch.cuda.get_device_name(0)} x "
                f"{torch.cuda.device_count()}, CUDA {torch.version.cuda}")

    def _imports():
        import cv2, numpy, scipy  # noqa: F401,E401
        names = f"torch {torch.__version__}/numpy/scipy/cv2"
        try:
            import triton
        except ImportError:
            return names + " (triton absent)"
        return names + f"/triton {triton.__version__}"

    def _native():
        from .. import native
        native.get_lib()
        return f"C++ LAPJV/NMS built and loaded: {native.library_path().name}"

    def _kernels():
        from ..kernels.inoculate import inoculate
        secs = inoculate(dev)
        return (f"x + 1 in {len(secs)} librar"
                f"{'y' if len(secs) == 1 else 'ies'}: {', '.join(secs)}")

    def _dataset():
        n = sum(len(files) for _, _, files in os.walk(args.data_root))
        if n == 0:
            raise FileNotFoundError(f"no files under {args.data_root}")
        return f"{n} files"

    def _sinkhorn():
        from ..ops.sinkhorn import sinkhorn
        out = sinkhorn(torch.zeros((4, 4), device=dev), 3, 3, tau=0.5,
                       max_iter=4)
        if not bool(torch.isfinite(out).all()):
            raise ValueError("non-finite Sinkhorn output")
        return f"sinkhorn on {dev} ok"

    check("devices", _devices)
    check("imports", _imports)
    check("native", _native)
    check("kernels", _kernels)
    check("dataset", _dataset)
    check("sinkhorn", _sinkhorn)
    width = max(len(n) for n, _, _ in checks)
    for name, ok, detail in checks:
        print(f"{'PASS' if ok else 'FAIL'}  {name:{width}s}  {detail}")
    return 0 if all(ok for _, ok, _ in checks) else 1


if __name__ == "__main__":
    raise SystemExit(main())
