"""The port exports the reference's public names, and still imports no
JAX with every subpackage loaded.

The reference has no ``__all__``, so its public names are ``dir()`` of the
package (without a leading underscore), taken in a subprocess.  Every one
of them exists in ``sparse_tpu_torch``, except the six ``_pallas`` names of
the K7 plan API, which the port renamed ``_slab`` on purpose."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RENAMED = {
    "BsrPallasPlan": "BsrSlabPlan",
    "BsrPallasPlanAD": "BsrSlabPlanAD",
    "bsr_smsmm_pallas_prepare": "bsr_smsmm_slab_prepare",
    "bsr_smsmm_pallas_prepare_ad": "bsr_smsmm_slab_prepare_ad",
    "bsr_smsmm_apply_pallas": "bsr_smsmm_apply_slab",
    "bsr_smsmm_apply_pallas_ad": "bsr_smsmm_apply_slab_ad",
}


def _public_names(package):
    code = (f"import json, {package}; print(json.dumps(sorted(n for n in "
            f"dir({package}) if not n.startswith('_'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300,
                         env={"JAX_PLATFORMS": "cpu", "PATH": ""})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_reference_name_is_exported():
    ref = _public_names("sparse_tpu")
    port = _public_names("sparse_tpu_torch")
    assert ref - port == set(RENAMED)
    assert set(RENAMED.values()) <= port


def test_import_with_new_subpackages_loads_no_jax():
    code = ("import sys, sparse_tpu_torch, sparse_tpu_torch.interop, "
            "sparse_tpu_torch.linalg, sparse_tpu_torch.solve, "
            "sparse_tpu_torch.utils.validate; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sparse_tpu')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
