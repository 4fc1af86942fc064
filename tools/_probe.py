"""Times edited copies of the port's package against each other on the card:
the runner that ``tools/k3_probe.py`` and ``tools/k4_kit_probe.py`` share.

A probe names its forms and gives, for each, edits of the package's
sources.  ``run`` copies the package once a form into
``sparse_tpu_torch/_build/probe/<form>/``, applies the form's edits, builds
the copies side by side, then runs ``tools/ab.py --suite bell --cases
CASES`` in one process a form, the forms in turns (reversed in every other
round), and removes the copies.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable

HERE = Path(__file__).resolve().parent.parent
PROBE = HERE / "sparse_tpu_torch" / "_build" / "probe"

# prints the registers and spills ``nvcc -Xptxas -v`` reports for the
# kernels whose names match the regex REPORT, one line a kernel
_BUILD = r'''
import re
from sparse_tpu_torch import _kernels
form, report = FORM, REPORT
_kernels.build()
name = None
for line in _kernels.build_log.splitlines() if report else ():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        name = m.group(1) if re.search(report, m.group(1)) else None
    elif name and ("registers" in line or "spill" in line):
        print(f"   {form}: {name}: {line.split('info    :')[-1].strip()}",
              flush=True)
'''

# a form's edits: file name under csrc/ -> function of its text
Edits = dict[str, Callable[[str], str]]


def sub(pattern: str | re.Pattern, repl: str, src: str, what: str) -> str:
    """``src`` with every match of ``pattern`` (a string or a compiled
    regex) replaced by ``repl``; exits where there is none."""
    if isinstance(pattern, re.Pattern):
        out, n = pattern.subn(repl, src)
    else:
        out, n = src.replace(pattern, repl), src.count(pattern)
    if n == 0:
        raise SystemExit(f"probe: {what} not found in the sources")
    return out


def _copy(root: Path, form: str, edits: Edits) -> Path:
    dst = PROBE / form
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "sparse_tpu_torch", dst / "sparse_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, edit in edits.items():
        f = dst / "sparse_tpu_torch" / "csrc" / name
        f.write_text(edit(f.read_text()))
    return dst


def run(forms: dict[str, Edits], cases: str, rounds: int,
        root: Path = HERE, report: str = "") -> None:
    """Builds ``root``'s package once a form with its edits and times
    ``cases`` of ``tools/ab.py --suite bell`` on each, in turns; prints the
    ptxas lines of the kernels whose names match the regex ``report``."""
    roots = {f: _copy(root, f, e) for f, e in forms.items()}
    builds = [subprocess.Popen(
        [sys.executable, "-c",
         _BUILD.replace("FORM", repr(f)).replace("REPORT", repr(report))],
        cwd=roots[f]) for f in forms]
    if any([p.wait() for p in builds]):
        raise SystemExit("probe: a build failed")
    names = list(forms)
    for r in range(rounds):
        for f in (names if r % 2 == 0 else names[::-1]):
            subprocess.run([sys.executable, str(HERE / "tools" / "ab.py"),
                            "--suite", "bell", "--root", str(roots[f]),
                            "--tag", f, "--cases", cases], check=True)
    shutil.rmtree(PROBE, ignore_errors=True)
