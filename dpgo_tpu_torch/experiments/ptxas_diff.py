"""The ptxas register and spill report of this package's kernel library
beside another copy's, kernel by kernel.

    python -m dpgo_tpu_torch.experiments.ptxas_diff OTHER

OTHER is a directory holding a ``dpgo_tpu_torch`` package (a checkout of
another commit, say the parent).  Each copy's library is built afresh in
its own process from its own sources (``rtr_kernel.build`` into a
temporary directory), its nvcc log is read for every compiled kernel's
registers, stack frame and spill bytes, and one JSON line is printed: the
kernels both copies hold, those of them whose numbers differ (with both
readings), and the kernels only one copy holds.  Needs ``nvcc`` (a CUDA
machine).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

#: Run in a child process with the copy's root first on ``sys.path``.
_CHILD = """
import json, pathlib, sys, tempfile
sys.path.insert(0, sys.argv[1])
from dpgo_tpu_torch.ops import rtr_kernel as rk
with tempfile.TemporaryDirectory() as tmp:
    rk.BUILD_DIR = pathlib.Path(tmp)
    rk.build()
print(json.dumps(rk.BUILD_LOG))
"""

_NUMBERS = {"registers": r"Used (\d+) registers",
            "stack": r"(\d+) bytes stack frame",
            "spill_stores": r"(\d+) bytes spill stores",
            "spill_loads": r"(\d+) bytes spill loads"}


def report(log: str) -> dict:
    """Kernel name with its (r, d) -> its ptxas numbers, from nvcc's log."""
    rows, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"\d([a-z][a-z_]*_kernel(?:_rt)?)I(?:Li(\d+)E)?Li(\d+)E",
                      ln)
        if "Compiling entry function" in ln and m:
            name = f"{m[1]}<{m[2] or 'r'},{m[3]}>"
            rows[name] = {}
        elif name:
            for key, pat in _NUMBERS.items():
                hit = re.search(pat, ln)
                if hit:
                    rows[name][key] = int(hit[1])
    return rows


def build_log(root: str) -> str:
    out = subprocess.run([sys.executable, "-c", _CHILD, os.path.abspath(root)],
                         check=True, capture_output=True, text=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="a directory holding dpgo_tpu_torch")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    mine, theirs = report(build_log(here)), report(build_log(args.other))
    both = sorted(set(mine) & set(theirs))
    differ = {k: {"this": mine[k], "other": theirs[k]} for k in both
              if mine[k] != theirs[k]}
    print(json.dumps({"kernels_in_both": len(both), "differ": differ,
                      "only_this": sorted(set(mine) - set(theirs)),
                      "only_other": sorted(set(theirs) - set(mine))}))


if __name__ == "__main__":
    main()
