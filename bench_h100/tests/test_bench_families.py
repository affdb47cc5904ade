"""A model family and a client are found by name: a new one is new files
alone.  A toy family and a toy client, written as new files into a copy of
the benchmark with entries added to its ``BENCHMARK.json``, run through
``run.execute`` on the CPU with no file of the copy changed; and the
general harness names no model, vocoder or client of its own."""

import ast
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MODEL_NAMES = ("ToucanTTS", "duration_predictor", "HiFiGAN", "BigVGAN", "CLIENTS")

TOY_FAMILY = '''"""ToucanTTS whose interface is marked and whose check reports one more
number."""
from bench_h100.families import toucan_tts as base

build, embedding_dim, shape_weights = base.build, base.embedding_dim, base.shape_weights
record_shapes, noise_shape, acoustic_flops = base.record_shapes, base.noise_shape, base.acoustic_flops


def build_interface(*args):
    iface = base.build_interface(*args)
    iface.toy = True
    return iface


class Reference(base.Reference):
    def judge(self, rec, feats, z, given=None):
        numbers, tie = super().judge(rec, feats, z, given)
        return dict(numbers, toy_unserved=float(rec["frames"] <= 0)), tie
'''

TOY_CLIENT = '''"""One __call__ at a time that keeps the wave alone."""
from bench_h100.clients.call import CallClient


class WaveOnlyClient(CallClient):
    def _call(self, i):
        return self.iface(self._item(i)[0]), None, None, None

    def request(self, i):
        i = super().request(i)
        for k in ("durations", "pitch", "energy"):
            self.records[-1].pop(k, None)
        return i

    def served(self, synthesis):
        return dict(wave=synthesis["wave"], frames=synthesis["frames"])


CLIENT = WaveOnlyClient
'''

RUN = '''import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/bench_h100/tests", sys.argv[2]]
import tiny
from bench_h100.harness import run
marks = []
out, info = run.execute("toy.wave_only", 2**31 + 3, 1.0, False, device="cpu",
                        config_override=tiny.config("toy"), mix_override=tiny.mix("wave_only"),
                        on_interface=lambda iface: marks.append(getattr(iface, "toy", False)))
print(json.dumps(dict(out=out, marks=marks, harness=run.__file__)))
'''


def digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_family_and_client_are_new_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "golden.json"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digests(tmp_path)
    bench = tmp_path / "bench_h100"
    (bench / "families" / "toy.py").write_text(TOY_FAMILY)
    (bench / "clients" / "wave_only.py").write_text(TOY_CLIENT)
    cfg = json.loads((bench / "configs" / "toucan_hifigan.json").read_text())
    (bench / "configs" / "toy.json").write_text(json.dumps(dict(cfg, name="toy", family="toy")))
    (bench / "traffic" / "wave_only.json").write_text(
        json.dumps({"text": "ljspeech", "client": "wave_only"}))
    (bench / "limits" / "toy.wave_only.json").write_text(json.dumps(
        {"features_differ": 0, "duration_gap": 1e-4, "wave_err": 1e-5, "toy_unserved": 0}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="toy", file="bench_h100/configs/toy.json"))
    spec["workloads"].append({"name": "toy.wave_only", "config": "toy", "traffic": "wave_only",
                              "chips": 1, "why": "a toy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    res = subprocess.run([sys.executable, "-c", RUN, str(tmp_path), str(ROOT)],
                         capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.splitlines()[-1])
    assert Path(got["harness"]).is_relative_to(tmp_path)
    assert got["marks"] == [True]
    out = got["out"]
    assert out["correct"] is True, out["checks"]
    assert list(out["checks"]) == ["features_differ", "duration_gap", "wave_err", "toy_unserved"]
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    after = digests(tmp_path)
    changed = {p for p, h in before.items() if after.get(p) != h}
    assert changed == {Path("BENCHMARK.json")}


def code_names(path: Path) -> set:
    """Identifiers, attributes, imported names and strings of a module,
    its docstrings aside."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    names = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
        elif isinstance(n, ast.alias):
            names.add(n.name)
        elif isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs:
            names.add(n.value)
    return names


def test_the_harness_names_no_model_and_no_client():
    for path in (BENCH / "harness").glob("*.py"):
        for name in code_names(path):
            assert not any(m in name for m in MODEL_NAMES), (path.name, name)
