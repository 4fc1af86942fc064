"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``), each run in this process on the CPU at the
reference's size: the port's ``main(["--device", "cpu", ...])`` (its own
assertions included) beside the reference's ``main()``, whose printed
results are read back.  Where the reference's mesh spans conftest's 8
virtual devices, the port's spans 8 in-process shards.

Exact: the top-5 pages, the halo and the printed tile fill, the fill-in
block count and the coarse operator's stored count.  Within tolerance:
the top-5 ranks within 1e-5 (one unit of the printed fifth decimal; the
reference runs float64 here, the port float32); a PCG relative error
within 1% of the reference's printed 3 digits where it is above 1e-4 (the
reference's own gate), else both below 1e-4; the CG residual within 1e-6
of the reference's (both at float32's floor, below the 1e-5 gate); the
LU's |P A - L U| and the solve's residual below 1e-12 in both (float64).
"""

import ast
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name, capsys):
    """The reference script's ``main()`` in this process; its output."""
    capsys.readouterr()
    _load(name).main()
    return capsys.readouterr().out


def _floats(pattern, text):
    return [float(x) for x in re.findall(pattern, text)]


def test_pagerank(capsys):
    ref = _reference("pagerank", capsys)
    out = _load("torch_pagerank").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    m = re.search(r"top-5 pages: (\[.*?\]) ranks: (\[.*?\])", ref)
    ref_top, ref_ranks = (ast.literal_eval(m.group(1)),
                          ast.literal_eval(m.group(2)))
    ranks = out["ranks"]
    top = np.argsort(ranks)[::-1][:5]
    assert top.tolist() == ref_top
    np.testing.assert_allclose(ranks[top], ref_ranks, rtol=0, atol=1e-5)
    assert printed.startswith(f"top-5 pages: {ref_top} ranks: ")


def test_poisson_cg(capsys):
    ref = _reference("poisson_cg", capsys)
    out = _load("torch_poisson_cg").main(["--device", "cpu", "--shards", "8"])
    printed = capsys.readouterr().out
    names = ("jacobi", "block-jacobi(4)", "chebyshev(6)")
    ref_err = dict(zip(names, _floats(r"relative error ([0-9.e+-]+)", ref)))
    assert len(ref_err) == 3 and "on 8 devices" in ref
    for name in names:
        got, want = out["err"][name], ref_err[name]
        if want > 1e-4:
            assert abs(got - want) <= 1e-2 * want, (name, got, want)
        else:
            assert got < 1e-4, (name, got, want)
        assert f"on 8 shards, 60 iters, {name}: relative error " in printed
    assert out["err"]["chebyshev(6) x120"] < 1e-4


def test_fast_distributed_cg(capsys):
    ref = _reference("fast_distributed_cg", capsys)
    out = _load("torch_fast_distributed_cg").main(
        ["--device", "cpu", "--shards", "8"])
    printed = capsys.readouterr().out
    halo = int(re.search(r"halo/shard: (\d+) entries", ref).group(1))
    fill = re.search(r"tile fill ([0-9.]+)", ref).group(1)
    assert out["halo"] == halo and f"{out['fill']:.3f}" == fill
    ref_rel = _floats(r"rel residual ([0-9.e+-]+)", ref)[0]
    assert out["rel"] < 1e-5 and ref_rel < 1e-5
    assert abs(out["rel"] - ref_rel) <= 1e-6
    assert f"halo/shard: {halo} entries" in printed


def test_galerkin_reuse(capsys):
    ref = _reference("galerkin_reuse", capsys)
    out = _load("torch_galerkin_reuse").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    stored = int(re.search(r"A_c is 128x128, (\d+) stored", ref).group(1))
    assert out["first_ok"] and out["stored"] == stored
    assert f"(A_c is 128x128, {stored} stored)" in printed


def test_block_lu_solve(capsys):
    ref = _reference("block_lu_solve", capsys)
    out = _load("torch_block_lu_solve").main(["--device", "cpu"])
    printed = capsys.readouterr().out
    fills = int(re.search(r"fill-in blocks: (\d+)", ref).group(1))
    lu_err = _floats(r"max \|P.A - L.U\| = ([0-9.e+-]+)", ref)[0]
    resid = _floats(r"ols residual: ([0-9.e+-]+)", ref)[0]
    assert out["fills"] == fills
    assert f"fill-in blocks: {fills}" in printed
    for got, want in ((out["lu_err"], lu_err), (out["resid"], resid)):
        assert got < 1e-12 and want < 1e-12


@pytest.mark.parametrize("name", ["torch_pagerank", "torch_poisson_cg",
                                  "torch_fast_distributed_cg",
                                  "torch_galerkin_reuse",
                                  "torch_block_lu_solve"])
def test_examples_import_only_the_port(name):
    """No port example imports jax or the reference package."""
    text = (ROOT / "examples" / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|sparse_tpu)\b", text,
                         re.M)
