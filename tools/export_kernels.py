"""Export the kernel subpackage into another project.

Parity with the reference's deployment story (`export_to_liger.py:9-34`
copies `src/**.py` into a Liger-Kernel checkout rewriting imports): this
copies `fa2_jax/ops` + `fa2_jax/utils` into a target package,
rewriting `fa2_jax.` imports to the target package name, so the
attention kernels can be vendored into a larger JAX codebase.

Usage:
    python tools/export_kernels.py /path/to/target_pkg [--name target_pkg]
"""
from __future__ import annotations

import argparse
import os
import re
import shutil

SUBPACKAGES = ("ops", "utils")


def export(target_dir: str, pkg_name: str | None = None) -> None:
    src_root = os.path.join(os.path.dirname(__file__), "..", "fa2_jax")
    pkg_name = pkg_name or os.path.basename(os.path.normpath(target_dir))
    os.makedirs(target_dir, exist_ok=True)
    for sub in SUBPACKAGES:
        dst = os.path.join(target_dir, sub)
        os.makedirs(dst, exist_ok=True)
        src = os.path.join(src_root, sub)
        for fname in sorted(os.listdir(src)):
            if not fname.endswith(".py"):
                continue
            with open(os.path.join(src, fname)) as f:
                code = f.read()
            code = re.sub(r"\bfrom fa2_jax\.", f"from {pkg_name}.", code)
            code = re.sub(r"\bimport fa2_jax\b", f"import {pkg_name}", code)
            with open(os.path.join(dst, fname), "w") as f:
                f.write(code)
            print(f"exported {sub}/{fname}")
    init = os.path.join(target_dir, "__init__.py")
    if not os.path.exists(init):
        with open(init, "w") as f:
            f.write(f"from {pkg_name}.ops import flash_attn_func, flash_attn_reference\n")
    print(f"done -> {target_dir} (package '{pkg_name}')")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("target")
    ap.add_argument("--name", default=None)
    args = ap.parse_args()
    export(args.target, args.name)
