"""The port stands alone: no JAX, nothing of ``toucan_tpu``.

A fresh interpreter imports every module of ``toucan_tpu_torch`` and must
end with neither JAX, flax, optax, orbax nor the JAX package loaded; so
must one that imports only the distribution slice's modules
(``dist/``, ``infer/pipelined.py``, ``train/sharded_checkpointing.py``) or
the worker script that the multi-rank tests start
(``tests/torch_dist_worker.py``); importing the training CLI loads none of
its recipes.  A source scan finds no import of them in
the package, in ``chip_smoke.py`` or in that worker.  The frontend is a
verbatim copy and must give the JAX package's feature arrays exactly.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from toucan_tpu.frontend.text import TextFrontend as JaxTextFrontend
from toucan_tpu_torch.frontend.text import TextFrontend

ROOT = pathlib.Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import toucan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(toucan_tpu_torch.__path__, "toucan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "toucan_tpu"))
print(len(names), bad)
"""

_IMPORT_ONE = """
import importlib, sys
sys.path.insert(0, "tests")
for name in sys.argv[1:]:
    importlib.import_module(name)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "toucan_tpu")))
"""


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 20, out          # every module was imported
    assert out[1:] == ["[]"], out


DISTRIBUTION = ["toucan_tpu_torch.dist", "toucan_tpu_torch.dist.mesh",
                "toucan_tpu_torch.dist.longform", "toucan_tpu_torch.dist.scaling_bench",
                "toucan_tpu_torch.dist.tensor_parallel", "toucan_tpu_torch.dist.launch",
                "toucan_tpu_torch.infer.pipelined", "toucan_tpu_torch.train.sharded_checkpointing",
                "torch_dist_worker"]


def test_distribution_modules_and_workers_import_no_jax():
    """One fresh interpreter imports the distribution modules and the
    multi-rank tests' worker script, and nothing else."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_ONE, *DISTRIBUTION], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=True).stdout
    assert out.split() == ["[]"], out


_IMPORT_CLI = """
import sys
import toucan_tpu_torch.cli
light = sorted(m for m in sys.modules if m.startswith(("toucan_tpu_torch.", "torch")))
import toucan_tpu_torch.run.training_pipeline, toucan_tpu_torch.run.weight_averaging
import toucan_tpu_torch.run.scorer
from toucan_tpu_torch.frontend import multilinguality
solver = multilinguality.SimilaritySolver()
print(light, multilinguality._DATA_DIR, len(solver.fullnames) > 1000, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                                  "toucan_tpu")))
"""


def test_cli_imports_no_recipe_and_the_twins_import_no_jax():
    """Importing the CLI loads no recipe, model or torch (its pipelines
    are imported when ``main`` runs); the three training-side twins and the
    multilinguality data, read from the port's own copy, bring in no JAX."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_CLI], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert out[0] == "['toucan_tpu_torch.cli']", out
    assert pathlib.Path(out[1]) == ROOT / "toucan_tpu_torch/frontend/data/multilinguality"
    assert out[2:] == ["True", "[]"], out


_FORBIDDEN = re.compile(
    r"\btoucan_tpu\.|^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b", re.M)


def test_sources_name_no_jax_or_jax_package():
    files = sorted((ROOT / "toucan_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_dist_worker.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
            for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []


@pytest.mark.parametrize("language,text,phonemes", [
    ("en", "Dr. Smith paid $25.50 for 3 kg on May 5th, didn't he?", False),
    ("de", "Der schnelle Hund lief am 3. Mai 12 km weit.", False),
    ("ru", "Привет, мир! В 2021 году было 21 кот.", False),
    ("cmn", "你好，世界。今天是三月五日。", False),
    ("fr", "Bonjour le monde, il est 8 h et j'ai 2 chats.", False),
    ("en", "~ðɪs ɪz ə tˈɛst, hɛlˈoʊ wˈɜːld~#", True),
])
def test_frontend_copy_gives_equal_features(language, text, phonemes):
    want = JaxTextFrontend(language=language).string_to_features(text, input_phonemes=phonemes)
    got = TextFrontend(language=language).string_to_features(text, input_phonemes=phonemes)
    assert got.shape[0] > 3
    np.testing.assert_array_equal(got, want)
