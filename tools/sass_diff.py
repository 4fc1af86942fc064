"""Compare the SASS of two builds of the package's kernel library, kernel by
kernel, to show which kernels a change left as they were.

    python3 tools/sass_diff.py LIB_A LIB_B

Runs ``cuobjdump -sass`` (the CUDA toolkit's, found beside ``nvcc``) on
both shared libraries, splits each listing into kernels by name, drops the
addresses and the encodings and compares each kernel's instructions.  The
hash that names a source file's anonymous namespace is dropped from the
names, so a kernel keeps its name when its file changes elsewhere.  Prints
one JSON line: the counts and names of the kernels identical in both, of
those that differ, and of those only in A or only in B.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

_FUNC = re.compile(r"^\s*Function : (\S+)")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENC = re.compile(r"/\* 0x[0-9a-f]+ \*/")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_(?:[0-9a-f]{8})?")


def _cuobjdump() -> str:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from sparse_tpu_torch import _kernels

    nvcc = _kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("sass_diff: no CUDA toolkit (nvcc) found")
    return str(Path(nvcc).with_name("cuobjdump"))


def kernels(lib: str, tool: str) -> dict[str, list[str]]:
    """{kernel name: its instructions} of the library ``lib``."""
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs: dict[str, list[str]] = {}
    body = None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            body = funcs.setdefault(_ANON.sub(r"<\1.cu>", m.group(1)), [])
            continue
        if line.startswith("Fatbin"):  # the next ELF's header: no kernel's
            body = None
            continue
        text = _ENC.sub("", _ADDR.sub("", line)).strip()
        if body is not None and text and not text.startswith("."):
            body.append(text)
    return funcs


def main():
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    tool = _cuobjdump()
    a, b = (kernels(lib, tool) for lib in sys.argv[1:])
    same = sorted(k for k in a.keys() & b.keys() if a[k] == b[k])
    differ = sorted(k for k in a.keys() & b.keys() if a[k] != b[k])
    print(json.dumps({
        "identical": len(same), "differ": differ,
        "only_a": sorted(a.keys() - b.keys()),
        "only_b": sorted(b.keys() - a.keys()),
        "n_a": len(a), "n_b": len(b)}))


if __name__ == "__main__":
    main()
