"""No line of the port or of ``chip_smoke.py`` reads as an import of
``jax`` or of the JAX package, docstrings included: the check a reader
runs to see that the port stands alone is

    grep -rnE '^\\s*(import|from)\\s+(jax|dpgo_tpu)\\b' dpgo_tpu_torch chip_smoke.py

and it must find nothing (``test_torch_host.py`` holds the imports
themselves in a fresh interpreter)."""

import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
IMPORT_LINE = re.compile(r"^\s*(import|from)\s+(jax|dpgo_tpu)\b")


def test_no_line_of_the_port_reads_as_a_jax_import():
    files = [ROOT / "chip_smoke.py",
             *sorted((ROOT / "dpgo_tpu_torch").rglob("*"))]
    hits = []
    for path in files:
        if not path.is_file() or "_build" in path.parts:
            continue
        try:
            text = path.read_text()
        except UnicodeDecodeError:
            continue
        hits += [f"{path.relative_to(ROOT)}:{i}" for i, line in
                 enumerate(text.splitlines(), 1) if IMPORT_LINE.match(line)]
    assert hits == []
